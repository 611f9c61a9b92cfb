"""Learned (deep) feature kernels (the counterpart of
algp_tpu.models.networks).

The feature columns pass through a small MLP φ before the stationary
covariance,

    k(x, x') = s² · k_spatial(x_sp, x'_sp) · k_feature(φ(x_ft), φ(x'_ft)),

and φ's weights are fitted jointly with the kernel hyperparameters by the
same marginal likelihood.  Downstream, everything (the Gram kernel over
the grid, the greedy loops, the episode) sees the embedded inputs
[spatial | φ(features)] under `deep_spec` (df = the embedding width): the
deep kernel is a preprocessing contract, not a second implementation.

The joint fit goes through the shared optimizer loop `gp._opt_loop` on
the tree (KernelParams, [(W0, b0), (W1, b1), …]).  Each restart trains
its own copy of the one initial MLP, so the weights carry the restart
axis and the embedding of a step is a batched matmul chain, (R, n, dz).
The matmuls run in f32 with TF32 off (the reference's
`Precision.HIGHEST`).

The MLP init is Glorot-normal from a `torch.Generator`; the reference's
comes from `jax.random`, so a test that holds the two against each other
passes the reference's weights in (`convert.mlp_from_numpy`), through
`fit_deep(inits=…)` or by replacing `step_inits`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from algp_tpu_torch.config import FitConfig, MLPSpec
from algp_tpu_torch.device import resolve_device
from algp_tpu_torch.models import gp as gp_mod
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec

_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


def init_mlp(spec: MLPSpec, df: int, generator: Optional[torch.Generator] = None,
             device=None) -> list:
    """Glorot-normal weights [(W0, b0), (W1, b1), …], W (a, b) and b (b,)
    zero, drawn from `generator` (seed 0 on `device` if None)."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
    dims = spec.dims(df)
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        scale = float(np.sqrt(np.float32(2.0 / (a + b))))
        W = scale * torch.randn((a, b), generator=generator, dtype=torch.float32,
                                device=generator.device)
        layers.append((W, torch.zeros((b,), dtype=torch.float32,
                                      device=generator.device)))
    return layers


def _activation(spec: MLPSpec):
    try:
        return _ACTIVATIONS[spec.activation]
    except KeyError:
        raise ValueError(
            f"unknown MLPSpec.activation {spec.activation!r}; "
            f"use one of {sorted(_ACTIVATIONS)}"
        ) from None


def embed_features(spec: MLPSpec, mlp, feats: torch.Tensor) -> torch.Tensor:
    """φ(features): (n, df) → (n, dz), or (R, n, dz) for weights with a
    leading restart axis (W (R, a, b), b (R, b))."""
    act = _activation(spec)
    if feats.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("embed_features: TF32 matmuls are on; the embedding "
                           "is f32 (torch.backends.cuda.matmul.allow_tf32 = False)")
    z = feats
    for i, (W, b) in enumerate(mlp):
        z = torch.matmul(z, W) + b[..., None, :]
        if i + 1 < len(mlp):
            z = act(z)
    return z


def embed_inputs(spec: MLPSpec, mlp, x: torch.Tensor, ds: int) -> torch.Tensor:
    """[spatial | φ(features)]: the inputs every downstream consumer sees."""
    z = embed_features(spec, mlp, x[:, ds:])
    return torch.cat([x[:, :ds].expand(*z.shape[:-1], ds), z], dim=-1)


def deep_spec(kspec: KernelSpec, mspec: MLPSpec) -> KernelSpec:
    """The kernel spec downstream consumers use: df = the embedding width."""
    return KernelSpec(spatial_kind=kspec.spatial_kind,
                      feature_kind=kspec.feature_kind, ds=kspec.ds, df=mspec.out)


@dataclasses.dataclass
class DeepFitResult:
    params: KernelParams  # kernel hyperparameters at `deep_spec`
    mlp: list  # φ's weights [(W, b), …]
    nll: torch.Tensor
    all_nlls: torch.Tensor  # (restarts,)
    nll_trace: torch.Tensor  # (restarts, iters)
    best_restart: torch.Tensor


def make_deep_inits(kspec: KernelSpec, mspec: MLPSpec, cfg: FitConfig,
                    generator: Optional[torch.Generator] = None, device=None):
    """(mlp0, kernel inits): the shared initial MLP, then the restart inits
    at `deep_spec`, both drawn from `generator` in that order."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
    mlp0 = init_mlp(mspec, kspec.df, generator)
    return mlp0, gp_mod.make_restart_inits(deep_spec(kspec, mspec), cfg, generator)


def fit_deep(
    kspec: KernelSpec,
    mspec: MLPSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    noise_scale: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    num_valid=None,
    inits: Optional[tuple] = None,
) -> DeepFitResult:
    """Joint deep-kernel fit: MLP weights and kernel hyperparameters on the
    −MLL (plus ½·weight_decay·ΣW² over the weight matrices), by
    `cfg.optimizer`, over the kernel restarts.  `x` holds the raw features
    (`kspec.df` columns after the `kspec.ds` spatial ones); the result's
    params live at `deep_spec`.  `inits` = (mlp0, kernel inits) replaces
    `make_deep_inits`."""
    mlp0, kinits = inits if inits is not None else make_deep_inits(
        kspec, mspec, cfg, generator, device=x.device)
    R = kinits.log_outputscale.shape[0]
    mlp = [(W.expand(R, *W.shape).clone(), b.expand(R, *b.shape).clone())
           for W, b in mlp0]
    espec = deep_spec(kspec, mspec)

    def loss(tree) -> torch.Tensor:
        kp, layers = tree
        if not cfg.learn_noise:
            kp = dataclasses.replace(kp, log_noise=kp.log_noise.detach())
        z = embed_inputs(mspec, layers, x, kspec.ds)
        nll = gp_mod.neg_mll(espec, kp, z, y, noise_scale, min_noise=cfg.min_noise,
                             jitter=cfg.jitter, num_valid=num_valid)
        if mspec.weight_decay:
            # L2 prior on the weight matrices (biases stay free): without
            # it the embedding can game the marginal likelihood
            wd = sum(torch.sum(W * W, dim=(-2, -1)) for W, _ in layers)
            nll = nll + 0.5 * mspec.weight_decay * wd
        return nll

    best, best_nll, trace = gp_mod._opt_loop(cfg, loss, (kinits, mlp))
    k = torch.argmin(best_nll)  # lowest index wins ties
    kp, layers = gp_mod._take(best, k)
    return DeepFitResult(params=kp, mlp=layers,
                         nll=best_nll.index_select(0, k.reshape(1))[0],
                         all_nlls=best_nll, nll_trace=trace, best_restart=k)


def step_inits(kspec: KernelSpec, mspec: MLPSpec, cfg: FitConfig, seed: int,
               step: int, device) -> tuple:
    """(mlp0, kernel inits) of the deep refit at episode step `step`, drawn
    from `gp.step_generator(seed, step)`: every refit starts from a fresh
    MLP, as the reference's does."""
    return make_deep_inits(kspec, mspec, cfg, gp_mod.step_generator(seed, step, device))


def fit_step(kspec: KernelSpec, mspec: MLPSpec, cfg: FitConfig, x, y, noise_scale,
             seed: int, step: int, num_valid=None) -> DeepFitResult:
    """The episode's deep refit at `step`: `fit_deep` from `step_inits`."""
    inits = step_inits(kspec, mspec, cfg, seed, step, x.device)
    return fit_deep(kspec, mspec, cfg, x, y, noise_scale, num_valid=num_valid,
                    inits=inits)
