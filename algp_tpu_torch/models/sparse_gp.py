"""Sparse variational GP regression, Titsias' collapsed bound (the
counterpart of algp_tpu.models.sparse_gp).

When the sampled set grows into the thousands (long campaigns), the exact
O(n³)-per-step MLL fit stops being cheap.  SGPR fits the hyperparameters
by the collapsed lower bound over M inducing points,

    ELBO = log N(y | 0, Q + Λ) − ½ tr(Λ⁻¹ (K − Q)),  Q = K_xz K_zz⁻¹ K_zx,

without an n × n matrix:  A = L_zz⁻¹ K_zx Λ^{-½},  B = I + A Aᵀ,
c = L_B⁻¹ A Λ^{-½} y, O(n·M²) per optimizer step.  The fit is the exact
path's (`gp._opt_loop`: Adam over the restart batch, best-ever tracking,
the non-finite guard) with this objective, differentiated by autograd
through the plain Gram; heteroscedastic Λ and identity-padded
`num_valid` buffers follow `gp.neg_mll`.  Every function takes params
with a leading restart axis.

The episode's refits (`fit_step_sparse`, `fit_step_sparse_warm`) take a
k-center design over the valid rows of the padded buffer, computed on the
device.  `predict_sparse` builds K_z* with the Gram kernel of `ops.gram`
(the plain version for CPU tensors).

Tracing: each refit marks its design and its fit as the profiler regions
`sgpr.design` and `sgpr.fit` (`utils.profiling.annotate`), once a refit;
`FITS` counts the SGPR fits started, as `ops.gram.LAUNCHES` counts the
Gram kernel's launches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from algp_tpu_torch.acquisition_lowrank import (
    _Z_JITTER, check_kcenter_m, kcenter_indices,
)
from algp_tpu_torch.config import FitConfig
from algp_tpu_torch.device import resolve_device
from algp_tpu_torch.models import gp as gp_mod
from algp_tpu_torch.models.gp import FitResult, effective_noise_var
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.gram import gram_kernel
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec, gram, gram_diag
from algp_tpu_torch.utils.profiling import annotate

_LOG2PI = 1.8378770664093453

#: SGPR fits started so far (a run can show how many of its fits were sparse)
FITS = 0


def _bound_terms(spec, params, x, y, z, noise_scale, min_noise, num_valid):
    """The collapsed bound's shared factors: (Lzz, U, LB, c, lam, y, mask,
    count) with U = L_zz⁻¹ K_zx (..., M, n), padded slots zeroed."""
    n, M = x.shape[0], z.shape[0]
    batch = params.log_outputscale.shape
    nv = effective_noise_var(params, min_noise, noise_scale)
    lam = (nv if noise_scale is not None else nv[..., None]).expand(*batch, n)
    if num_valid is not None:
        mask = (torch.arange(n, device=x.device) < num_valid).to(torch.float32)
        count = num_valid
    else:
        mask = torch.ones((n,), dtype=torch.float32, device=x.device)
        count = n
    lam = torch.where(mask > 0, lam, 1.0)  # padded slots: λ = 1, zero terms
    y = y * mask
    eye = torch.eye(M, dtype=torch.float32, device=x.device)
    Kzz = gram(spec, params, z, z) + (
        _Z_JITTER * torch.exp(params.log_outputscale))[..., None, None] * eye
    Lzz = la.cholesky(Kzz)
    U = la.solve_triangular(Lzz, gram(spec, params, z, x) * mask)  # (..., M, n)
    rl = torch.rsqrt(lam)
    A = U * rl[..., None, :]
    LB = la.cholesky(eye + A @ A.mT)
    c = la.solve_triangular(LB, (A @ (y * rl)[..., None])[..., 0])
    return Lzz, U, LB, c, lam, y, mask, count


def neg_elbo(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    noise_scale: Optional[torch.Tensor] = None,
    *,
    min_noise: float = 1e-3,
    jitter: float = 1e-6,
    num_valid=None,
) -> torch.Tensor:
    """−ELBO, one value per batch element of `params`.  Conventions of
    `gp.neg_mll`: `noise_scale` multiplies the fitted noise variance per
    sample, entries ≥ `num_valid` contribute exactly zero.  `jitter` is
    accepted for signature parity and unused (Λ ≥ min_noise², K_zz has
    its own relative jitter)."""
    del jitter
    _, U, LB, c, lam, y, mask, count = _bound_terms(
        spec, params, x, y, z, noise_scale, min_noise, num_valid)
    qdiag = torch.sum(U * U, dim=-2)
    kdiag = gram_diag(spec, params, x)
    trace = 0.5 * torch.sum(mask * torch.clamp_min(kdiag - qdiag, 0.0) / lam, -1)
    quad = 0.5 * (torch.sum(y * (y * (1.0 / lam)), -1) - torch.sum(c * c, -1))
    logdet = torch.sum(mask * torch.log(lam), -1) * 0.5 + torch.sum(
        torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)), -1)
    return quad + logdet + 0.5 * count * _LOG2PI + trace


def _fit_sparse_batched(spec, cfg, x, y, z, noise_scale, inits, num_valid=None):
    """All restarts of `inits` at once on −ELBO, then the winner."""
    global FITS
    FITS += 1

    def loss(p: KernelParams) -> torch.Tensor:
        if not cfg.learn_noise:
            p = dataclasses.replace(p, log_noise=p.log_noise.detach())
        return neg_elbo(spec, p, x, y, z, noise_scale, min_noise=cfg.min_noise,
                        jitter=cfg.jitter, num_valid=num_valid)

    best_p, best_nll, trace = gp_mod._opt_loop(cfg, loss, inits)
    k = torch.argmin(best_nll)  # lowest index wins ties (oracle contract)
    return FitResult(
        params=gp_mod._take(best_p, k),
        nll=best_nll.index_select(0, k.reshape(1))[0],
        all_nlls=best_nll, nll_trace=trace, best_restart=k,
    )


def fit_sparse(
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    noise_scale: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    num_valid=None,
    inits: Optional[KernelParams] = None,
) -> FitResult:
    """Multi-restart −ELBO fit (`gp.fit` with the SGPR objective); `nll`
    in the result is the best −ELBO, an upper bound on the exact −MLL."""
    if inits is None:
        inits = gp_mod.make_restart_inits(spec, cfg, generator, device=x.device)
    return _fit_sparse_batched(spec, cfg, x, y, z, noise_scale, inits, num_valid)


def _valid_design(x, num_valid, num_inducing, caller):
    """The k-center design over the valid rows of a padded buffer."""
    m = min(num_inducing, x.shape[0])
    check_kcenter_m(num_valid, m, caller)
    return x.index_select(0, kcenter_indices(x, m, num_valid))


def _design_and_fit(spec, cfg, x, y, noise_scale, num_valid, num_inducing,
                    caller, inits):
    """A refit's design and fit, each in its profiler region; the result
    carries the design's host seconds (`FitResult.design_s`, an enqueue
    like the episode's `fit_s`)."""
    with annotate("sgpr.design"):
        t0 = time.perf_counter()
        z = _valid_design(x, num_valid, num_inducing, caller)
        design_s = time.perf_counter() - t0
    with annotate("sgpr.fit"):
        res = _fit_sparse_batched(spec, cfg, x, y, z, noise_scale, inits, num_valid)
    res.design_s = design_s
    return res


def fit_step_sparse(
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    noise_scale: Optional[torch.Tensor],
    seed: int,
    step: int,
    num_valid,
    *,
    num_inducing: int,
) -> FitResult:
    """The episode's sparse refit at `step`: inits from `gp.step_inits`, a
    k-center design of `num_inducing` points over the valid rows, then
    `fit_sparse`.  Requires num_valid ≥ num_inducing (`check_kcenter_m`)."""
    inits = gp_mod.step_inits(spec, cfg, seed, step, x.device)
    return _design_and_fit(spec, cfg, x, y, noise_scale, num_valid, num_inducing,
                           "fit_step_sparse", inits)


def fit_step_sparse_warm(
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    noise_scale: Optional[torch.Tensor],
    seed: int,
    step: int,
    num_valid,
    incumbent: KernelParams,
    *,
    num_inducing: int,
) -> FitResult:
    """`fit_step_sparse` with the incumbent as restart 0 and `gp.refit_cfg`'s
    iters / restarts: best-ever tracking evaluates the incumbent first, so
    the refit's −ELBO never ends above the incumbent's on the same design."""
    rcfg = gp_mod.refit_cfg(cfg)
    inits = gp_mod.warm_inits(spec, rcfg, seed, step, incumbent, x.device)
    return _design_and_fit(spec, rcfg, x, y, noise_scale, num_valid, num_inducing,
                           "fit_step_sparse_warm", inits)


@dataclasses.dataclass
class SparsePosterior:
    """Cached SGPR predictive state, O(M²): Lzz (M, M) chol of K_zz +
    jitter, LB (M, M) chol of I + A Aᵀ, c (M,) L_B⁻¹ A Λ^{-½} y, z (M, d)."""

    Lzz: torch.Tensor
    LB: torch.Tensor
    c: torch.Tensor
    z: torch.Tensor


def posterior_sparse(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    noise_scale: Optional[torch.Tensor] = None,
    *,
    min_noise: float = 1e-3,
    num_valid=None,
) -> SparsePosterior:
    """The SGPR posterior's factors at fixed params."""
    Lzz, _, LB, c, *_ = _bound_terms(
        spec, params, x, y, z, noise_scale, min_noise, num_valid)
    return SparsePosterior(Lzz=Lzz, LB=LB, c=c, z=z)


def predict_sparse(
    spec: KernelSpec, params: KernelParams, post: SparsePosterior,
    x_test: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SGPR predictive mean and variance at `x_test` (the q(f*) marginals):
    V1 = L_zz⁻¹ K_z*, V2 = L_B⁻¹ V1, μ* = V2ᵀ c,
    σ²* = k** − colsum V1² + colsum V2².  K_z* from the Gram kernel."""
    V1 = la.solve_triangular(post.Lzz, gram_kernel(spec, params, post.z, x_test))
    V2 = la.solve_triangular(post.LB, V1)
    mean = V2.T @ post.c
    var = (gram_diag(spec, params, x_test) - torch.sum(V1 * V1, dim=0)
           + torch.sum(V2 * V2, dim=0))
    return mean, torch.clamp_min(var, 0.0)


class SparseGP:
    """Stateful façade mirroring `gp.ExactGP` for the sparse model:
    `fit(x, y)` / `predict(x*)` over an M-point k-center design (or a given
    `z`).  Inputs go to `device`: the card unless the caller asks for the
    CPU."""

    def __init__(self, spec: KernelSpec, num_inducing: int = 256,
                 fit_config: Optional[FitConfig] = None, device=None):
        self.spec = spec
        self.num_inducing = num_inducing
        self.fit_config = fit_config or FitConfig()
        self.device = resolve_device(device)
        self.params: Optional[KernelParams] = None
        self.post: Optional[SparsePosterior] = None

    def _t(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def fit(self, x, y, noise_scale=None, generator=None, z=None,
            inits: Optional[KernelParams] = None) -> FitResult:
        x, y = self._t(x), self._t(y)
        ns = None if noise_scale is None else self._t(noise_scale)
        if z is None:
            z = x.index_select(0, kcenter_indices(x, min(self.num_inducing, x.shape[0])))
        else:
            z = self._t(z)
        res = fit_sparse(self.spec, self.fit_config, x, y, z, ns,
                         generator=generator, inits=inits)
        self.params = res.params
        self.post = posterior_sparse(self.spec, res.params, x, y, z, ns,
                                     min_noise=self.fit_config.min_noise)
        return res

    def predict(self, x_test):
        if self.post is None:
            raise RuntimeError("fit() first")
        return predict_sparse(self.spec, self.params, self.post, self._t(x_test))
