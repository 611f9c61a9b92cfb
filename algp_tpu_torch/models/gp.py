"""Exact Gaussian-process regression fitted by marginal likelihood (the
counterpart of the fit in algp_tpu.models.gp).

The restarts are a leading batch dimension of `KernelParams`: one step
runs one batched Cholesky over all restarts, and the gradient is taken
from the sum of the per-restart NLLs — the restarts share no parameter,
so each one's gradient (and any NaN) stays its own.  Adam is written out
in optax's order of operations (`optax.scale_by_adam`, then the scale by
−lr, then `apply_updates`), so the port follows the reference step for
step.  The fit differentiates only the plain small-n Gram; no kernel runs
under autograd.  Nothing in the step loop reads a value on the host.

Not ported yet: L-BFGS, `fit_step*`, `fit_multi`, `posterior`/`predict`
and `ExactGP`; see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from algp_tpu_torch.config import FitConfig
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec, gram

_LOG2PI = 1.8378770664093453

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def effective_noise_var(
    params: KernelParams, min_noise: float, noise_scale: Optional[torch.Tensor]
) -> torch.Tensor:
    """Per-sample noise variance with a hard floor for f32 conditioning;
    (...,) or, with `noise_scale` (n,), (..., n)."""
    nv = torch.clamp_min(params.noise_var, min_noise * min_noise)
    if noise_scale is not None:
        nv = nv[..., None] * noise_scale
    return nv


def _masked_gram_with_noise(spec, params, x, nv, jitter, num_valid):
    """K + diag(noise) with identity padding beyond `num_valid`: padded
    rows/cols are exactly e_i, so with y = 0 there they add 0 to the
    quadratic form and to the log-det."""
    n = x.shape[0]
    K = gram(spec, params, x, x)
    if nv.dim() == K.dim() - 2:  # one variance per batch element
        nv = nv[..., None]
    K = K + torch.diag_embed((nv + jitter).expand(*K.shape[:-1]))
    if num_valid is None:
        return K
    mask = torch.arange(n, device=x.device) < num_valid
    pair = mask[:, None] & mask[None, :]
    return torch.where(pair, K, torch.eye(n, dtype=K.dtype, device=K.device))


def neg_mll(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    y: torch.Tensor,
    noise_scale: Optional[torch.Tensor] = None,
    *,
    min_noise: float = 1e-3,
    jitter: float = 1e-6,
    num_valid=None,
) -> torch.Tensor:
    """Negative log marginal likelihood ½yᵀK⁻¹y + ½log|K| + (n/2)log 2π,
    one value per batch element of `params`.  With `num_valid`, entries
    ≥ num_valid are identity-padded and contribute exactly zero."""
    n = x.shape[0]
    nv = effective_noise_var(params, min_noise, noise_scale)
    if num_valid is not None:
        y = y * (torch.arange(n, device=y.device) < num_valid)
        count = num_valid
    else:
        count = n
    K = _masked_gram_with_noise(spec, params, x, nv, jitter, num_valid)
    L = la.cholesky(K)
    yb = y.expand(*K.shape[:-1])
    alpha = la.cho_solve(L, yb)
    return (
        0.5 * torch.sum(yb * alpha, -1)
        + torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
        + 0.5 * count * _LOG2PI
    )


@dataclasses.dataclass
class FitResult:
    params: KernelParams  # best restart's best params
    nll: torch.Tensor  # its final NLL
    all_nlls: torch.Tensor  # (restarts,) final NLL per restart
    nll_trace: torch.Tensor  # (restarts, iters) NLL per step
    best_restart: torch.Tensor  # index of the winning restart (device)


def _bias_correction(decay: float, count: int) -> float:
    # 1 − decay^count in f32 arithmetic, as optax computes it (an f32
    # value, so dividing an f32 tensor by it rounds exactly as there)
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _adam_step(g, mu, nu, count):
    """One `optax.scale_by_adam` step on lists of tensors, in optax's
    order of operations; `count` is the 1-based step number.  Returns
    (updates, mu, nu); the caller scales the updates by −lr."""
    bc1 = _bias_correction(_ADAM_B1, count)
    bc2 = _bias_correction(_ADAM_B2, count)
    mu = [(1 - _ADAM_B1) * gi + _ADAM_B1 * mi for gi, mi in zip(g, mu)]
    nu = [(1 - _ADAM_B2) * (gi * gi) + _ADAM_B2 * vi for gi, vi in zip(g, nu)]
    upd = [(mi / bc1) / (torch.sqrt(vi / bc2) + _ADAM_EPS)
           for mi, vi in zip(mu, nu)]
    return upd, mu, nu


def _opt_loop(
    cfg: FitConfig,
    loss: Callable[[KernelParams], torch.Tensor],
    params0: KernelParams,
):
    """The optimizer loop over `cfg.iters` steps with best-ever tracking
    and the non-finite guard; `loss` maps batched params to one value per
    restart.  Returns (best_params, best_nll, trace (R, iters))."""
    if cfg.optimizer == "lbfgs":
        raise NotImplementedError(
            "L-BFGS fitting is not ported to algp_tpu_torch yet; see ROADMAP.md"
        )
    if cfg.optimizer != "adam":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    names = [f.name for f in dataclasses.fields(KernelParams)]
    p = [getattr(params0, name).detach().clone() for name in names]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    best_p = [t.clone() for t in p]
    best_nll = torch.full(
        params0.log_outputscale.shape, torch.inf, device=p[0].device
    )
    trace = []
    for step in range(1, cfg.iters + 1):
        leaves = [t.requires_grad_(True) for t in p]
        nll = loss(KernelParams(**dict(zip(names, leaves))))
        grads = torch.autograd.grad(nll.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        nll = nll.detach()
        p = [t.detach() for t in leaves]
        with torch.no_grad():
            better = nll < best_nll
            best_nll = torch.where(better, nll, best_nll)
            best_p = [torch.where(_bcast(better, a), a, b)
                      for a, b in zip(p, best_p)]
            upd, mu, nu = _adam_step(grads, mu, nu, step)
            p = [pi + (-cfg.learning_rate) * u for pi, u in zip(p, upd)]
        trace.append(nll)

    with torch.no_grad():
        # the final iterate may beat the best tracked pre-update value
        nll_fin = loss(KernelParams(**dict(zip(names, p))))
        better = nll_fin < best_nll
        best_nll = torch.where(better, nll_fin, best_nll)
        best_p = [torch.where(_bcast(better, a), a, b)
                  for a, b in zip(p, best_p)]
        # non-finite guard: a diverged restart must never win the argmin
        best_nll = torch.where(torch.isfinite(best_nll), best_nll, torch.inf)
    return (
        KernelParams(**dict(zip(names, best_p))),
        best_nll,
        torch.stack(trace, dim=-1),
    )


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(*mask.shape, *([1] * (like.dim() - mask.dim())))


def _take(p: KernelParams, k: torch.Tensor) -> KernelParams:
    """Restart k of batched params, k a device index (no host sync)."""
    return p.map(lambda a: a.index_select(0, k.reshape(1))[0])


def _fit_batched(
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    noise_scale: Optional[torch.Tensor],
    inits: KernelParams,
    num_valid=None,
) -> FitResult:
    """All restarts of `inits` (leading axis) at once, then the winner
    (the counterpart of algp_tpu.models.gp._fit_jit)."""

    def loss(p: KernelParams) -> torch.Tensor:
        if not cfg.learn_noise:
            p = dataclasses.replace(p, log_noise=p.log_noise.detach())
        return neg_mll(
            spec, p, x, y, noise_scale, min_noise=cfg.min_noise,
            jitter=cfg.jitter, num_valid=num_valid,
        )

    best_p, best_nll, trace = _opt_loop(cfg, loss, inits)
    k = torch.argmin(best_nll)  # lowest index wins ties (oracle contract)
    return FitResult(
        params=_take(best_p, k),
        nll=best_nll.index_select(0, k.reshape(1))[0],
        all_nlls=best_nll,
        nll_trace=trace,
        best_restart=k,
    )


def make_restart_inits(
    spec: KernelSpec,
    cfg: FitConfig,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> KernelParams:
    """Stacked multi-restart initial hyperparameters (restart axis
    leading).  Restart 0 is the unperturbed config init; the rest perturb
    in log space with draws from `generator` (seed 0 on `device` if
    None)."""
    if generator is None:
        generator = torch.Generator(device=device or "cpu").manual_seed(0)
    base = dict(
        ls_spatial=cfg.init_ls_spatial,
        ls_feature=cfg.init_ls_feature,
        outputscale=cfg.init_outputscale,
        noise=cfg.init_noise,
        device=generator.device,
    )
    inits = [spec.init_params(**base)] + [
        spec.init_params(generator, perturb=cfg.perturb, **base)
        for _ in range(cfg.restarts - 1)
    ]
    return KernelParams(**{
        f.name: torch.stack([getattr(p, f.name) for p in inits])
        for f in dataclasses.fields(KernelParams)
    })


def fit(
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    noise_scale: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    num_valid=None,
    inits: Optional[KernelParams] = None,
) -> FitResult:
    """Multi-restart MLL fit: `cfg.restarts` inits × `cfg.iters` steps.
    `inits` (restart axis leading) replaces `make_restart_inits`, e.g. to
    start from the reference's own inits."""
    if inits is None:
        inits = make_restart_inits(spec, cfg, generator, device=x.device)
    return _fit_batched(spec, cfg, x, y, noise_scale, inits, num_valid)
