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

The episode's refits (`fit_step`, `fit_step_warm`) draw their restart
inits from `step_inits`: a `torch.Generator` seeded from (episode seed,
step), the counterpart of the reference's fold_in(PRNGKey(seed), step),
so a resumed episode draws exactly the inits the uninterrupted one would.
The streams cannot equal jax.random's; a test that holds the episode
against the reference replaces `step_inits` with the reference's inits.

The posterior (`posterior`, `predict`, the row-append growth
`posterior_extend` and the fused pairs) serves the episode's metrics;
`predict` builds its cross-covariance with the Gram kernel of `ops.gram`
(the plain version for CPU tensors).

Not ported yet: L-BFGS and `fit_multi`; see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from algp_tpu_torch.config import FitConfig
from algp_tpu_torch.device import resolve_device
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.gram import gram_kernel
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec, gram, gram_diag

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
    None; `device` None is the card, and the CPU only when asked for)."""
    if generator is None:
        generator = torch.Generator(
            device=resolve_device(device)).manual_seed(0)
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


# ---------------------------------------------------------------------------
# Episode refits
# ---------------------------------------------------------------------------


def step_inits(
    spec: KernelSpec, cfg: FitConfig, seed: int, step: int, device
) -> KernelParams:
    """Restart inits of the refit at episode step `step`: draws from a
    generator seeded by (seed, step) alone, so a resumed run repeats
    them."""
    mixed = int(np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
    gen = torch.Generator(device=device).manual_seed(mixed)
    return make_restart_inits(spec, cfg, gen)


def fit_step(
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    noise_scale: Optional[torch.Tensor],
    seed: int,
    step: int,
    num_valid=None,
) -> FitResult:
    """The episode's refit at `step`: `fit` from `step_inits`."""
    inits = step_inits(spec, cfg, seed, step, x.device)
    return _fit_batched(spec, cfg, x, y, noise_scale, inits, num_valid)


def refit_cfg(cfg: FitConfig) -> FitConfig:
    """The FitConfig a warm refit runs under: `refit_iters` /
    `refit_restarts` override `iters` / `restarts` when set (0 keeps the
    full-fit value); the identity when warm refits are off."""
    if not (cfg.refit_iters or cfg.refit_restarts):
        return cfg
    return dataclasses.replace(
        cfg,
        iters=cfg.refit_iters or cfg.iters,
        restarts=cfg.refit_restarts or cfg.restarts,
    )


def fit_step_warm(
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    noise_scale: Optional[torch.Tensor],
    seed: int,
    step: int,
    incumbent: KernelParams,
    num_valid=None,
) -> FitResult:
    """`fit_step` with a warm restart 0: the incumbent params replace the
    unperturbed init, and `refit_cfg` shrinks iters / restarts.  Best-ever
    tracking evaluates the incumbent before its first update, so a warm
    refit never ends worse than where it started."""
    rcfg = refit_cfg(cfg)
    inits = warm_inits(spec, rcfg, seed, step, incumbent, x.device)
    return _fit_batched(spec, rcfg, x, y, noise_scale, inits, num_valid)


def warm_inits(
    spec: KernelSpec, rcfg: FitConfig, seed: int, step: int,
    incumbent: KernelParams, device,
) -> KernelParams:
    """`step_inits` under `rcfg` with restart 0 replaced by the incumbent
    params (the warm refits, exact and sparse)."""
    inits = step_inits(spec, rcfg, seed, step, device)
    return KernelParams(**{
        f.name: torch.cat([getattr(incumbent, f.name)[None].to(device),
                           getattr(inits, f.name)[1:]])
        for f in dataclasses.fields(KernelParams)
    })


# ---------------------------------------------------------------------------
# Posterior: predictive mean / variance over the grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Posterior:
    """Cached GP posterior: factor + weights over the training set.

    L     : (n, n) lower Cholesky of K(X,X) + diag(noise), identity-padded
    alpha : (n,)   K⁻¹ y  (0 in the padding)
    x     : (n, d) training inputs
    mask  : (n,)   1.0 for real training points, 0.0 for padding
    """

    L: torch.Tensor
    alpha: torch.Tensor
    x: torch.Tensor
    mask: torch.Tensor


def posterior(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    y: torch.Tensor,
    noise_scale: Optional[torch.Tensor] = None,
    *,
    min_noise: float = 1e-3,
    jitter: float = 1e-6,
    num_valid=None,
) -> Posterior:
    """Factor the (identity-padded beyond `num_valid`) training system."""
    n = x.shape[0]
    nv = effective_noise_var(params, min_noise, noise_scale)
    K = _masked_gram_with_noise(spec, params, x, nv, jitter, num_valid)
    if num_valid is not None:
        mask = (torch.arange(n, device=x.device) < num_valid).to(torch.float32)
        y = y * mask
    else:
        mask = torch.ones((n,), dtype=torch.float32, device=x.device)
    L = la.cholesky(K)
    return Posterior(L=L, alpha=la.cho_solve(L, y), x=x, mask=mask)


def predict(
    spec: KernelSpec, params: KernelParams, post: Posterior, x_test: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance at `x_test`:
    μ* = K*ᵀ α,  σ²* = k** − colsum(V²),  V = L⁻¹K*.  K* is the Gram
    kernel's (the reference's large-grid Pallas call); the trisolve takes
    the whole (n, N) right-hand side at once."""
    Ks = gram_kernel(spec, params, post.x, x_test)
    Ks = Ks * post.mask[:, None]  # zero rows for identity-padded slots
    mean = Ks.T @ post.alpha
    V = la.solve_triangular(post.L, Ks)
    var = gram_diag(spec, params, x_test) - torch.sum(V * V, dim=0)
    return mean, torch.clamp_min(var, 0.0)


def posterior_extend(
    spec: KernelSpec,
    params: KernelParams,
    post: Posterior,
    x_pad: torch.Tensor,
    y_pad: torch.Tensor,
    new_nv: torch.Tensor,
    m0: int,
    k_count: int,
    *,
    jitter: float = 1e-6,
) -> Posterior:
    """Grow a cached posterior by the step's new samples without
    refactorizing: rows m0 … m0+k_count−1 are appended one at a time with
    `linalg.chol_append_row` (O(k·n²)), then α is re-solved.

    x_pad/y_pad : the full padded training buffers (new samples already
                  at slots [m0, m0+k_count))
    new_nv      : (k_max,) noise variance of each new sample (entries
                  ≥ k_count ignored)
    """
    n_max = x_pad.shape[0]
    idx = torch.arange(n_max, device=x_pad.device)
    L = post.L.clone()  # the cached factor stays as it was
    for t in range(k_count):
        m = m0 + t
        xs = x_pad[m: m + 1]
        k_vec = torch.where(idx < m, gram(spec, params, x_pad, xs)[:, 0], 0.0)
        k_ss = gram_diag(spec, params, xs)[0] + new_nv[t] + jitter
        la.chol_append_row(L, m, k_vec, k_ss)
    mask = (idx < m0 + k_count).to(torch.float32)
    alpha = la.cho_solve(L, y_pad * mask)
    return Posterior(L=L, alpha=alpha, x=x_pad, mask=mask)


def posterior_and_predict(
    spec, params, x, y, noise_scale, x_test, *, min_noise=1e-3, jitter=1e-6,
    num_valid=None,
):
    """`posterior` + `predict`: (Posterior, mean, var)."""
    post = posterior(spec, params, x, y, noise_scale, min_noise=min_noise,
                     jitter=jitter, num_valid=num_valid)
    mean, var = predict(spec, params, post, x_test)
    return post, mean, var


def extend_and_predict(
    spec, params, post, x_pad, y_pad, new_nv, m0, k_count, x_test, *,
    jitter=1e-6,
):
    """`posterior_extend` + `predict` (the between-refit episode step)."""
    post = posterior_extend(spec, params, post, x_pad, y_pad, new_nv, m0,
                            k_count, jitter=jitter)
    mean, var = predict(spec, params, post, x_test)
    return post, mean, var


class ExactGP:
    """Stateful façade over the functional core (`fit(x, y)` /
    `predict(x*)`).  Inputs go to `device`: the card unless the caller
    asks for the CPU."""

    def __init__(self, spec: KernelSpec, fit_config: Optional[FitConfig] = None,
                 device=None):
        self.spec = spec
        self.fit_config = fit_config or FitConfig()
        self.device = resolve_device(device)
        self.params: Optional[KernelParams] = None
        self.post: Optional[Posterior] = None

    def _t(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def fit(self, x, y, noise_scale=None, generator=None,
            inits: Optional[KernelParams] = None) -> FitResult:
        x, y = self._t(x), self._t(y)
        ns = None if noise_scale is None else self._t(noise_scale)
        res = fit(self.spec, self.fit_config, x, y, ns, generator=generator,
                  inits=inits)
        self.set_params(res.params, x, y, ns)
        return res

    def set_params(self, params: KernelParams, x, y, noise_scale=None):
        """Condition on data with given (already-fitted) hyperparameters."""
        ns = None if noise_scale is None else self._t(noise_scale)
        self.params = params
        self.post = posterior(
            self.spec, params, self._t(x), self._t(y), ns,
            min_noise=self.fit_config.min_noise, jitter=self.fit_config.jitter,
        )

    def predict(self, x_test):
        if self.post is None:
            raise RuntimeError("fit() or set_params() first")
        return predict(self.spec, self.params, self.post, self._t(x_test))
