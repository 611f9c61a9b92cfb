"""Coregionalized multi-trait GP, the intrinsic coregionalization model
(the counterpart of algp_tpu.models.coregional).

The traits share the spatial(×feature) kernel k and are coupled by a
learned T × T trait covariance,

    cov[f_t(x), f_s(x')] = B[t, s] · k(x, x'),     B = A Aᵀ + diag(κ),

so densely measured traits carry information into sparsely measured ones.
The joint system over n plots × T traits is kron(K_x, B) plus per-(plot,
trait) noise, flattened plot-major (m = i·T + t).  Cells a visit did not
measure are identity-padded, as the exact GP pads its buffers, so they add
exactly zero to the likelihood.

The fit runs the restarts as a leading batch axis of `ICMParams` through
the shared optimizer loop (`gp._opt_loop`): one batched nT × nT Cholesky
(`cholesky_ex`, NaN on failure) a step.  The kernel's own outputscale and
base noise are frozen (detached in the loss): B carries the per-trait
signal variance and `log_noise_t` the per-trait noise.  Prediction reuses
the factor: the per-trait means for every trait are one (n, N) cross-Gram
(the Gram kernel of `ops.gram`) and one matmul; the variances take one
(nT, N) triangular solve per trait.

Restart inits come from a `torch.Generator`; the reference's come from
`jax.random`, so a test passes the reference's inits in
(`convert.icm_params_from_numpy`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from algp_tpu_torch.config import FitConfig
from algp_tpu_torch.device import resolve_device
from algp_tpu_torch.models import gp as gp_mod
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.gram import gram_kernel
from algp_tpu_torch.ops.kernels import (
    KernelParams, KernelSpec, _f32_log, gram, gram_diag,
)

_LOG2PI = gp_mod._LOG2PI


@dataclasses.dataclass
class ICMParams:
    """ICM hyperparameters, f32 tensors with optional leading batch dims.

    kernel          : the shared kernel's (its log_outputscale and
                      log_noise stay fixed in the fit)
    coreg_a         : (..., T, r) factor of B = A Aᵀ + diag(κ)
    log_coreg_kappa : (..., T) log of B's diagonal boost κ
    log_noise_t     : (..., T) per-trait log noise std (`noise_scale`
                      multiplies the variance, as in the exact GP)
    """

    kernel: KernelParams
    coreg_a: torch.Tensor
    log_coreg_kappa: torch.Tensor
    log_noise_t: torch.Tensor


def trait_cov(params: ICMParams) -> torch.Tensor:
    """The T × T PSD trait covariance B = A Aᵀ + diag(exp κ)."""
    A = params.coreg_a
    return A @ A.mT + torch.diag_embed(torch.exp(params.log_coreg_kappa))


def _flat_mask(n, T, obs_mask, num_valid, device) -> torch.Tensor:
    m = torch.ones((n, T), dtype=torch.bool, device=device) if obs_mask is None \
        else obs_mask
    if num_valid is not None:
        m = m & (torch.arange(n, device=device) < num_valid)[:, None]
    return m.reshape(-1)


def _icm_system(spec, params, x, obs_mask, noise_scale, min_noise, jitter, num_valid):
    """The masked nT × nT joint system and its flat observation mask.

    Plot-major: entry m = i·T + t is (plot i, trait t), so
    kron(K_x, B)[m, m'] = K_x[i, j]·B[t, s].  Masked entries are
    identity-padded: with y = 0 there they add 0 to the quadratic form and
    to the log-det."""
    n = x.shape[0]
    T = params.log_noise_t.shape[-1]
    Kx = gram(spec, params.kernel, x, x)
    B = trait_cov(params)
    batch = Kx.shape[:-2]
    C = (Kx[..., :, None, :, None] * B[..., None, :, None, :]).reshape(
        *batch, n * T, n * T)
    nv_t = torch.clamp_min(torch.exp(2.0 * params.log_noise_t), min_noise * min_noise)
    ns = torch.ones((n,), dtype=torch.float32, device=x.device) \
        if noise_scale is None else noise_scale
    nv = (ns[:, None] * nv_t[..., None, :]).reshape(*nv_t.shape[:-1], n * T)
    C = C + torch.diag_embed(nv + jitter)
    mf = _flat_mask(n, T, obs_mask, num_valid, x.device)
    pair = mf[:, None] & mf[None, :]
    C = torch.where(pair, C, torch.eye(n * T, dtype=C.dtype, device=C.device))
    return C, mf


def neg_mll_icm(
    spec: KernelSpec,
    params: ICMParams,
    x: torch.Tensor,
    Y: torch.Tensor,
    obs_mask: Optional[torch.Tensor] = None,
    noise_scale: Optional[torch.Tensor] = None,
    *,
    min_noise: float = 1e-3,
    jitter: float = 1e-6,
    num_valid=None,
) -> torch.Tensor:
    """Joint negative log marginal likelihood over the observed (plot,
    trait) cells of Y (n, T), one value per batch element of `params`;
    Y's masked cells are ignored.  A failed factor gives NaN."""
    C, mf = _icm_system(spec, params, x, obs_mask, noise_scale, min_noise, jitter,
                        num_valid)
    y = torch.where(mf, Y.reshape(-1), 0.0).expand(*C.shape[:-1])
    L = la.cholesky(C)
    alpha = la.cho_solve(L, y)
    count = torch.sum(mf.to(torch.float32))
    return (
        0.5 * torch.sum(y * alpha, -1)
        + torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
        + 0.5 * count * _LOG2PI
    )


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ICMFitResult:
    params: ICMParams
    nll: torch.Tensor
    all_nlls: torch.Tensor  # (restarts,)
    nll_trace: torch.Tensor  # (restarts, iters)
    best_restart: torch.Tensor


def make_icm_inits(
    spec: KernelSpec,
    cfg: FitConfig,
    T: int,
    rank: int,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> ICMParams:
    """Stacked multi-restart ICM inits (restart axis leading).

    Restart 0 is the unperturbed kernel init with A = 0.3/√r, κ = 0.5 and
    the per-trait noise at `cfg.init_noise`; the others perturb A
    additively and the log-space leaves by `cfg.perturb`.  The kernel's
    outputscale is 1 and its noise `cfg.init_noise` on every restart: the
    fit freezes both, so a perturbed value would stay with the winner."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
    dev = generator.device
    kinits = gp_mod.make_restart_inits(
        spec, dataclasses.replace(cfg, init_outputscale=1.0), generator)
    kinits = dataclasses.replace(
        kinits,
        log_outputscale=torch.zeros_like(kinits.log_outputscale),
        log_noise=_f32_log(cfg.init_noise, dev).expand_as(kinits.log_noise).clone(),
    )
    a0 = torch.full((T, rank), 0.3 / np.sqrt(rank), dtype=torch.float32, device=dev)
    lk0 = _f32_log(0.5, dev).expand(T).clone()
    ln0 = _f32_log(cfg.init_noise, dev).expand(T).clone()
    As, lks, lns = [a0], [lk0], [ln0]
    for _ in range(cfg.restarts - 1):
        for base, out in ((a0, As), (lk0, lks), (ln0, lns)):
            out.append(base + cfg.perturb * torch.randn(
                base.shape, generator=generator, dtype=torch.float32, device=dev))
    return ICMParams(kernel=kinits, coreg_a=torch.stack(As),
                     log_coreg_kappa=torch.stack(lks), log_noise_t=torch.stack(lns))


def step_inits(spec: KernelSpec, cfg: FitConfig, T: int, seed: int, step: int,
               device) -> ICMParams:
    """ICM inits (rank `cfg.icm_rank`) drawn from `gp.step_generator(seed,
    step)`."""
    return make_icm_inits(spec, cfg, T, cfg.icm_rank,
                          gp_mod.step_generator(seed, step, device))


def _icm_loss(spec, cfg, x, Y, obs_mask, noise_scale, num_valid):
    def loss(p: ICMParams) -> torch.Tensor:
        # B owns the signal variance and log_noise_t the noise: the
        # kernel's own copies get no gradient and stay at their inits
        kp = dataclasses.replace(p.kernel, log_outputscale=p.kernel.log_outputscale.detach(),
                                 log_noise=p.kernel.log_noise.detach())
        p = dataclasses.replace(p, kernel=kp)
        if not cfg.learn_noise:
            p = dataclasses.replace(p, log_noise_t=p.log_noise_t.detach())
        return neg_mll_icm(spec, p, x, Y, obs_mask, noise_scale, min_noise=cfg.min_noise,
                           jitter=cfg.jitter, num_valid=num_valid)

    return loss


def fit_icm(
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    Y: torch.Tensor,
    obs_mask: Optional[torch.Tensor] = None,
    noise_scale: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    *,
    rank: int = 1,
    num_valid=None,
    inits: Optional[ICMParams] = None,
    mesh=None,
) -> ICMFitResult:
    """Multi-restart joint MLL fit of the ICM: `cfg.restarts` inits ×
    `cfg.iters` steps of `cfg.optimizer`, each step one batched nT × nT
    Cholesky.  `obs_mask` (n, T) bool marks the measured cells (None =
    all); `rank` is r of B = A Aᵀ + diag κ; `inits` replaces
    `make_icm_inits`.  `mesh` (`parallel.make_mesh`, every rank calling
    with the same inputs): each rank of its 'restarts' axis runs its
    contiguous slice of the restarts and the NLLs are all-gathered; a
    restart count the axis does not divide runs whole on every rank, as
    the reference falls back to replication."""
    if inits is None:
        inits = make_icm_inits(spec, cfg, Y.shape[1], rank, generator, device=x.device)
    loss = _icm_loss(spec, cfg, x, Y, obs_mask, noise_scale, num_valid)
    if mesh is None:
        ran = gp_mod._opt_loop(cfg, loss, inits)
    else:
        from algp_tpu_torch.parallel.sharded import opt_loop_restarts

        ran = opt_loop_restarts(mesh, cfg, loss, inits, ragged="replicate")
    return gp_mod.best_of(*ran, result=ICMFitResult)


# ---------------------------------------------------------------------------
# Posterior / prediction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ICMPosterior:
    """Cached ICM posterior over the flat (plot, trait) training set.

    L     : (nT, nT) lower Cholesky of the masked joint system
    alpha : (nT,)    Σ⁻¹ vec(Y), 0 at masked entries
    x     : (n, d)   the training inputs (plots)
    mask  : (nT,)    1.0 at observed (plot, trait) entries
    B     : (T, T)   the fitted trait covariance
    """

    L: torch.Tensor
    alpha: torch.Tensor
    x: torch.Tensor
    mask: torch.Tensor
    B: torch.Tensor


def posterior_icm(
    spec: KernelSpec,
    params: ICMParams,
    x: torch.Tensor,
    Y: torch.Tensor,
    obs_mask: Optional[torch.Tensor] = None,
    noise_scale: Optional[torch.Tensor] = None,
    *,
    min_noise: float = 1e-3,
    jitter: float = 1e-6,
    num_valid=None,
) -> ICMPosterior:
    C, mf = _icm_system(spec, params, x, obs_mask, noise_scale, min_noise, jitter,
                        num_valid)
    y = torch.where(mf, Y.reshape(-1), 0.0)
    L = la.cholesky(C)
    return ICMPosterior(L=L, alpha=la.cho_solve(L, y), x=x,
                        mask=mf.to(torch.float32), B=trait_cov(params))


def predict_icm_mean(spec: KernelSpec, params: ICMParams, post: ICMPosterior,
                     x_test: torch.Tensor) -> torch.Tensor:
    """Per-trait posterior means at `x_test`, (N, T): one (n, N) cross-Gram
    and one matmul for every trait,
    μ[j, t] = Σ_{i,s} k(x_i, x*_j)·α[i, s]·B[s, t] = (K_cᵀ (α_mat B))[j, t]."""
    n, T = post.x.shape[0], post.B.shape[0]
    Kc = gram_kernel(spec, params.kernel, post.x, x_test)  # (n, N)
    return Kc.T @ (post.alpha.reshape(n, T) @ post.B)


def predict_icm(spec: KernelSpec, params: ICMParams, post: ICMPosterior,
                x_test: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-trait posterior means and variances at `x_test`, (N, T) each:
    the means as `predict_icm_mean`, the variances one (nT, N) triangular
    solve per trait."""
    n, T = post.x.shape[0], post.B.shape[0]
    Kc = gram_kernel(spec, params.kernel, post.x, x_test)  # (n, N)
    means = Kc.T @ (post.alpha.reshape(n, T) @ post.B)
    kdiag = gram_diag(spec, params.kernel, x_test)
    cols = []
    for t in range(T):
        # rows (i, s) of the flat cross-covariance to trait t
        cross = (Kc[:, None, :] * post.B[:, t][None, :, None]).reshape(n * T, -1)
        V = la.solve_triangular(post.L, cross * post.mask[:, None])
        cols.append(post.B[t, t] * kdiag - torch.sum(V * V, dim=0))
    return means, torch.clamp_min(torch.stack(cols, dim=1), 0.0)


def fit_predict_icm(
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    Y: torch.Tensor,
    x_test: torch.Tensor,
    obs_mask: Optional[torch.Tensor] = None,
    noise_scale: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    *,
    rank: int = 1,
    test_chunk: int = 65536,
    compute_var: bool = True,
    inits: Optional[ICMParams] = None,
    mesh=None,
) -> tuple[torch.Tensor, Optional[torch.Tensor], ICMFitResult]:
    """`fit_icm`, the posterior and the per-trait prediction over `x_test`
    in chunks of `test_chunk` points (the last zero-padded to the chunk
    and trimmed, as the reference does; columns are independent).
    `compute_var=False` skips the T triangular solves a chunk and returns
    (means, None, result): the end-of-episode evaluation reads means
    only.  `mesh` splits the fit's restarts as in `fit_icm`; the posterior
    and the prediction run whole on every rank."""
    res = fit_icm(spec, cfg, x, Y, obs_mask, noise_scale, generator, rank=rank,
                  inits=inits, mesh=mesh)
    post = posterior_icm(spec, res.params, x, Y, obs_mask, noise_scale,
                         min_noise=cfg.min_noise, jitter=cfg.jitter)

    def one(chunk):
        if compute_var:
            return predict_icm(spec, res.params, post, chunk)
        return predict_icm_mean(spec, res.params, post, chunk), None

    N = x_test.shape[0]
    if N <= test_chunk:
        mean, var = one(x_test)
        return mean, var, res
    means, vars_ = [], []
    for s in range(0, N, test_chunk):
        chunk = x_test[s: s + test_chunk]
        pad = test_chunk - chunk.shape[0]
        if pad:
            chunk = torch.cat([chunk, chunk.new_zeros((pad, x_test.shape[1]))])
        m, v = one(chunk)
        means.append(m[: test_chunk - pad])
        vars_.append(None if v is None else v[: test_chunk - pad])
    var = torch.cat(vars_) if compute_var else None
    return torch.cat(means), var, res
