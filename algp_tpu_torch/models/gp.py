"""Exact Gaussian-process regression fitted by marginal likelihood (the
counterpart of the fit in algp_tpu.models.gp).

The restarts are a leading batch dimension of `KernelParams`: one step
runs one batched Cholesky over all restarts, and the gradient is taken
from the sum of the per-restart NLLs — the restarts share no parameter,
so each one's gradient (and any NaN) stays its own.  Adam is written out
in optax's order of operations (`optax.scale_by_adam`, then the scale by
−lr, then `apply_updates`), so the port follows the reference step for
step; nothing in its step loop reads a value on the host.  L-BFGS is
optax 0.2.6's `lbfgs()` written out (`_lbfgs_loop`): the two-loop
recursion over 10 pairs, then optax's zoom line search, under the
reference's per-restart (`vmap`) semantics — each restart searches until
its own search is done, a finished restart's state is frozen, and the
trip loop ends when no restart still searches, which takes one
device→host read a trip.  Both loops run over any parameter tree
(`tree_leaves`: `KernelParams`, the ICM's `ICMParams`, the deep kernel's
(KernelParams, MLP weights)), its leaves in the reference's `tree_leaves`
order.  The fit differentiates only the plain small-n Gram; no kernel
runs under autograd.  `fit_multi` fits T traits × R
restarts as one flat batch of T·R restarts.

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

# optax.lbfgs()'s defaults: scale_by_lbfgs(memory_size=10,
# scale_init_precond=True), then scale_by_zoom_linesearch(20 steps,
# initial_guess_strategy="one") with its defaults (tol 0, increase factor
# 2, slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6,
# stepsize_precision 1e-5, no maximal stepsize)
_LBFGS_MEMORY = 10
_LS_STEPS = 20
_LS_INCREASE, _LS_SLOPE_RTOL, _LS_CURV_RTOL = 2.0, 1e-4, 0.9
_LS_APPROX_DEC_RTOL, _LS_INTERVAL = 1e-6, 1e-5


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
    quadratic form and to the log-det.  `x` may carry the batch too (the
    deep fit's per-restart embeddings, (R, n, d))."""
    n = x.shape[-2]
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
    n = x.shape[-2]
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
    # an SGPR refit's host seconds for its k-center design (an enqueue:
    # nothing waits for the device); None for every other fit
    design_s: Optional[float] = None


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


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree in the reference's `tree_leaves`
    order: a dataclass's fields in order, a list's or tuple's items in
    order, recursively (`KernelParams`; `ICMParams`; the deep fit's
    `(KernelParams, [(W0, b0), (W1, b1), …])`)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    raise TypeError(f"not a parameter tree: {type(tree).__name__}")


def tree_rebuild(like, leaves):
    """A tree shaped as `like` holding `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if dataclasses.is_dataclass(t):
            return type(t)(**{f.name: build(getattr(t, f.name))
                              for f in dataclasses.fields(t)})
        return type(t)(build(item) for item in t)

    return build(like)


def tree_map(fn, tree):
    """`tree` with `fn` applied to every leaf."""
    return tree_rebuild(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def _opt_loop(cfg: FitConfig, loss: Callable, params0):
    """The optimizer loop over `cfg.iters` steps with best-ever tracking
    and the non-finite guard; `params0` is any parameter tree whose leaves
    carry a leading restart axis, and `loss` maps such a tree to one value
    per restart.  A leaf the loss detaches (the reference's
    `stop_gradient`) gets a zero gradient, so Adam leaves it exactly where
    it started.  Returns (best_params, best_nll, trace (R, iters))."""
    if cfg.optimizer == "lbfgs":
        return _lbfgs_loop(cfg, loss, params0)
    if cfg.optimizer != "adam":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    p = [t.detach().clone() for t in tree_leaves(params0)]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    best_p = [t.clone() for t in p]
    best_nll = torch.full(p[0].shape[:1], torch.inf, device=p[0].device)
    trace = []
    for step in range(1, cfg.iters + 1):
        leaves = [t.requires_grad_(True) for t in p]
        nll = loss(tree_rebuild(params0, leaves))
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
        nll_fin = loss(tree_rebuild(params0, p))
        better = nll_fin < best_nll
        best_nll = torch.where(better, nll_fin, best_nll)
        best_p = [torch.where(_bcast(better, a), a, b)
                  for a, b in zip(p, best_p)]
        # non-finite guard: a diverged restart must never win the argmin
        best_nll = torch.where(torch.isfinite(best_nll), best_nll, torch.inf)
    return tree_rebuild(params0, best_p), best_nll, torch.stack(trace, dim=-1)


def _flat(p) -> torch.Tensor:
    """(R, P) batched params: the leaves side by side, in `tree_leaves`
    order."""
    return torch.cat([t.reshape(t.shape[0], -1) for t in tree_leaves(p)], dim=1)


def _unflat(x: torch.Tensor, like):
    """The tree shaped as `like` whose leaves are the columns of `x`
    (views)."""
    leaves, off = [], 0
    for t in tree_leaves(like):
        size = t[0].numel()
        leaves.append(x[:, off:off + size].reshape(t.shape))
        off += size
    return tree_rebuild(like, leaves)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's cubic interpolation: the critical point of the cubic through
    (a, fa), (b, fb), (c, fc) with slope fpa at a (NaN if none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc * dc * r0 + -(db * db) * r1) / denom
    B = (-(dc * dc * dc) * r0 + db * db * db * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's quadratic interpolation through (a, fa), (b, fb), slope fpa."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo, or Hager-Zhang's approximate decrease near a minimum; 0
    where satisfied, inf for NaN (optax's `_compute_decrease_error`)."""
    err = value - value_init - _LS_SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * _LS_SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - _LS_APPROX_DEC_RTOL * torch.abs(value_init)
    err = torch.clamp_min(torch.minimum(torch.maximum(approx, delta), err), 0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _curvature_error(slope, slope_init):
    err = torch.clamp_min(torch.abs(slope) - _LS_CURV_RTOL * torch.abs(slope_init), 0.0)
    return torch.where(torch.isnan(err), torch.inf, err)


def _select(mask: torch.Tensor, a: dict, b: dict) -> dict:
    """Per restart: the entries of `a` where `mask`, else `b`'s."""
    return {k: torch.where(_bcast(mask, a[k]), a[k], b[k]) for k in a}


def _zoom_linesearch(vg, x, u, value, grad):
    """optax 0.2.6's `zoom_linesearch` (Nocedal-Wright 3.5 / 3.6) along the
    directions `u` (R, P) from `x`, one search per restart: a trip
    evaluates each restart at its own trial stepsize (the interval search's
    or the zoom's, as `interval_found` says), and a restart that is done
    or failed keeps its state.  Returns (stepsize, value, grad) at the end
    of each restart's search."""
    R = x.shape[0]
    dev = x.device
    zero = torch.zeros(R, device=dev)
    slope = _vdot(u, grad)
    st = dict(
        count=torch.zeros(R, dtype=torch.int64, device=dev),
        stepsize=zero, value=value, grad=grad, slope=slope,
        decrease_error=torch.full((R,), torch.inf, device=dev),
        interval_found=torch.zeros(R, dtype=torch.bool, device=dev),
        done=torch.zeros(R, dtype=torch.bool, device=dev),
        failed=torch.zeros(R, dtype=torch.bool, device=dev),
        low=zero, value_low=value, slope_low=slope,
        high=zero, value_high=value, slope_high=slope,
        cubic_ref=zero, value_cubic_ref=value,
        safe_stepsize=zero, safe_value=value, safe_grad=grad,
    )
    value_init, slope_init = value, slope
    while True:
        active = ~(st["done"] | st["failed"])
        if not bool(active.any()):  # the trip's one device→host read
            break
        c = st["count"]
        low, high = st["low"], st["high"]
        # the zoom's trial point: cubic, else quadratic, else bisection
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        mc = _cubicmin(low, st["value_low"], st["slope_low"], high, st["value_high"],
                       st["cubic_ref"], st["value_cubic_ref"])
        use_cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
        mq = _quadmin(low, st["value_low"], st["slope_low"], high, st["value_high"])
        use_quad = ~use_cubic & (mq > left + 0.1 * delta) & (mq < right - 0.1 * delta)
        middle = torch.where(use_cubic, mc, st["cubic_ref"])
        middle = torch.where(use_quad, mq, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
        # the interval search's: the guess 1, then twice the last stepsize
        grown = torch.where(c == 0, torch.ones_like(zero), _LS_INCREASE * st["stepsize"])
        zoom = st["interval_found"]
        trial = torch.where(zoom, middle, grown)
        v_t, g_t = vg(x + _bcast(trial, x) * u)
        s_t = _vdot(g_t, u)
        dec = _decrease_error(trial, v_t, s_t, value_init, slope_init)
        err = torch.maximum(dec, _curvature_error(s_t, slope_init))
        done = err <= 0.0
        point = dict(stepsize=trial, value=v_t, grad=g_t, slope=s_t)
        new = dict(st, count=c + 1, decrease_error=dec, done=done, **point)

        # interval search (algorithm 3.5)
        prev = dict(stepsize=st["stepsize"], value=st["value"], slope=st["slope"])
        hi_new = (dec > 0.0) | ((v_t >= prev["value"]) & (c > 0))
        lo_new = (s_t >= 0.0) & ~hi_new
        bounds = _select(
            lo_new,
            dict(low=trial, value_low=v_t, slope_low=s_t,
                 high=prev["stepsize"], value_high=prev["value"], slope_high=prev["slope"]),
            dict(low=prev["stepsize"], value_low=prev["value"], slope_low=prev["slope"],
                 high=trial, value_high=v_t, slope_high=s_t))
        search = dict(
            new, **bounds, cubic_ref=bounds["low"], value_cubic_ref=bounds["value_low"],
            interval_found=hi_new | lo_new | done,
            failed=(c + 1 >= _LS_STEPS) & ~done,
            **_select(dec <= 0.0,
                      dict(safe_stepsize=trial, safe_value=v_t, safe_grad=g_t),
                      dict(safe_stepsize=st["safe_stepsize"], safe_value=st["safe_value"],
                           safe_grad=st["safe_grad"])))

        # zoom (algorithm 3.6)
        safe = _select((dec <= 0.0) & (v_t < st["safe_value"]),
                       dict(safe_stepsize=trial, safe_value=v_t, safe_grad=g_t),
                       dict(safe_stepsize=st["safe_stepsize"], safe_value=st["safe_value"],
                            safe_grad=st["safe_grad"]))
        hi_mid = (dec > 0.0) | (v_t >= st["value_low"])
        hi_low = (s_t * (high - low) >= 0.0) & ~hi_mid
        cur_hi = dict(high=high, value_high=st["value_high"], slope_high=st["slope_high"])
        hi = _select(hi_mid, dict(high=trial, value_high=v_t, slope_high=s_t), cur_hi)
        hi = _select(hi_low, dict(high=low, value_high=st["value_low"],
                                  slope_high=st["slope_low"]), hi)
        lo = _select(~hi_mid, dict(low=trial, value_low=v_t, slope_low=s_t),
                     dict(low=low, value_low=st["value_low"], slope_low=st["slope_low"]))
        ref = _select(hi_mid | hi_low,
                      dict(cubic_ref=high, value_cubic_ref=st["value_high"]),
                      dict(cubic_ref=low, value_cubic_ref=st["value_low"]))
        gave_up = (c + 1 >= _LS_STEPS) | ((delta <= _LS_INTERVAL)
                                           & (safe["safe_stepsize"] > 0.0))
        zoomed = dict(new, **hi, **lo, **ref, **safe, failed=gave_up & ~done)

        new = _select(zoom, zoomed, search)
        # a failed search falls back to its best point of sufficient
        # decrease, if it has one (optax's `_try_safe_step`)
        fallback = new["failed"] & ((new["safe_stepsize"] > 0.0)
                                    | torch.isinf(new["decrease_error"]))
        new.update(_select(
            fallback,
            dict(stepsize=new["safe_stepsize"], value=new["safe_value"],
                 grad=new["safe_grad"]),
            dict(stepsize=new["stepsize"], value=new["value"], grad=new["grad"])))
        st = _select(active, new, st)
    return st["stepsize"], st["value"], st["grad"]


def _lbfgs_loop(cfg: FitConfig, loss, params0):
    """`_opt_loop` under optax.lbfgs(): each step preconditions the
    gradient by the two-loop recursion over the last 10 (Δparams, Δgrad)
    pairs (γ = capped 1/‖g‖ at the first step, then ΔgᵀΔp / ‖Δg‖²), runs
    the zoom line search along the negated direction and moves by the
    stepsize it found.  The value and gradient the search ends at are the
    next step's (optax's `value_and_grad_from_state`)."""
    m = _LBFGS_MEMORY

    def vg(x):
        x = x.detach().requires_grad_(True)
        v = loss(_unflat(x, params0))
        g, = torch.autograd.grad(v.sum(), x, allow_unused=True)
        return v.detach(), (torch.zeros_like(x) if g is None else g)

    x = _flat(params0).detach().clone()
    R, P = x.shape
    value, grad = vg(x)
    dw = x.new_zeros((m, R, P))
    du = x.new_zeros((m, R, P))
    rho = x.new_zeros((m, R))
    prev_x, prev_g = torch.zeros_like(x), torch.zeros_like(x)
    best_nll = torch.full((R,), torch.inf, device=x.device)
    best_x = x.clone()
    trace = []
    for k in range(cfg.iters):
        nll, g = value, grad
        trace.append(nll)
        better = nll < best_nll
        best_nll = torch.where(better, nll, best_nll)
        best_x = torch.where(better[:, None], x, best_x)

        # scale_by_lbfgs: store the newest pair, then P_k g
        if k > 0:
            d_x, d_g = x - prev_x, g - prev_g
            dot = _vdot(d_g, d_x)
            w = torch.where(dot == 0.0, 0.0, 1.0 / dot)
            sq = _vdot(d_g, d_g)
            gamma = torch.where(sq > 0.0, dot / sq, 1.0)
        else:
            d_x, d_g, w = torch.zeros_like(x), torch.zeros_like(x), x.new_zeros(R)
            gamma = torch.clamp_max(1.0 / torch.sqrt(_vdot(g, g)), 1.0)
        slot = (k - 1) % m
        dw[slot], du[slot], rho[slot] = d_x, d_g, w
        order = [(k % m + j) % m for j in range(m)]
        vec, alphas = g, {}
        for i in reversed(order):
            alphas[i] = rho[i] * _vdot(dw[i], vec)
            vec = vec + (-alphas[i])[:, None] * du[i]
        vec = gamma[:, None] * vec
        for i in order:
            beta = rho[i] * _vdot(du[i], vec)
            vec = vec + (alphas[i] - beta)[:, None] * dw[i]
        prev_x, prev_g = x, g

        u = -1.0 * vec
        step, value, grad = _zoom_linesearch(vg, x, u, nll, g)
        x = x + step[:, None] * u

    with torch.no_grad():
        nll_fin = loss(_unflat(x, params0))
        better = nll_fin < best_nll
        best_nll = torch.where(better, nll_fin, best_nll)
        best_x = torch.where(better[:, None], x, best_x)
        best_nll = torch.where(torch.isfinite(best_nll), best_nll, torch.inf)
    return (tree_map(torch.clone, _unflat(best_x, params0)), best_nll,
            torch.stack(trace, dim=-1))


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(*mask.shape, *([1] * (like.dim() - mask.dim())))


def _take(p, k: torch.Tensor):
    """Restart k of a batched parameter tree, k a device index (no host
    sync)."""
    return tree_map(lambda a: a.index_select(0, k.reshape(1))[0], p)


def _mll_loss(spec, cfg: FitConfig, x, y, noise_scale, num_valid=None):
    """The fit's objective: batched params → −MLL per batch element, with
    the noise frozen unless `cfg.learn_noise`."""

    def loss(p: KernelParams) -> torch.Tensor:
        if not cfg.learn_noise:
            p = dataclasses.replace(p, log_noise=p.log_noise.detach())
        return neg_mll(
            spec, p, x, y, noise_scale, min_noise=cfg.min_noise,
            jitter=cfg.jitter, num_valid=num_valid,
        )

    return loss


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
    loss = _mll_loss(spec, cfg, x, y, noise_scale, num_valid)
    return best_of(*_opt_loop(cfg, loss, inits))


def best_of(best_p, best_nll: torch.Tensor, trace: torch.Tensor, result=FitResult):
    """The fit result of a restart batch that ran (`_opt_loop`'s outputs):
    the lowest NLL wins, the lowest index on ties (oracle contract).
    `result` is the result class (`FitResult`, or one with its fields)."""
    k = torch.argmin(best_nll)
    return result(
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


def fit_multi(
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    Y: torch.Tensor,
    noise_scale: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    inits: Optional[KernelParams] = None,
) -> FitResult:
    """Independent GPs for the T traits (columns of Y (n, T)) of the same
    plots, every trait from the same restart inits: T·R restarts in one
    batch, so each step runs one batched Cholesky over all of them.
    Returns a FitResult whose fields carry a leading trait axis
    (`trait_result` takes one trait's)."""
    if inits is None:
        inits = make_restart_inits(spec, cfg, generator, device=x.device)
    T, R = Y.shape[1], inits.log_outputscale.shape[0]
    batch = inits.map(lambda a: a.repeat(T, *([1] * (a.dim() - 1))))
    loss = _mll_loss(spec, cfg, x, Y.T.repeat_interleave(R, dim=0), noise_scale)
    best_p, best_nll, trace = _opt_loop(cfg, loss, batch)
    best_nll = best_nll.reshape(T, R)
    k = torch.argmin(best_nll, dim=1)  # lowest index wins ties
    rows = torch.arange(T, device=k.device) * R + k
    return FitResult(
        params=best_p.map(lambda a: a.index_select(0, rows)),
        nll=best_nll.gather(1, k[:, None])[:, 0],
        all_nlls=best_nll,
        nll_trace=trace.reshape(T, R, -1),
        best_restart=k,
    )


def trait_result(res: FitResult, t: int) -> FitResult:
    """Trait t's FitResult from a `fit_multi` batch."""
    return FitResult(params=res.params.map(lambda a: a[t]), nll=res.nll[t],
                     all_nlls=res.all_nlls[t], nll_trace=res.nll_trace[t],
                     best_restart=res.best_restart[t])


# ---------------------------------------------------------------------------
# Episode refits
# ---------------------------------------------------------------------------


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on `device` seeded by (seed, step) alone (the
    counterpart of the reference's fold_in(PRNGKey(seed), step)), so a
    resumed run repeats its draws."""
    mixed = int(np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(mixed)


def step_inits(
    spec: KernelSpec, cfg: FitConfig, seed: int, step: int, device
) -> KernelParams:
    """Restart inits of the refit at episode step `step`, drawn from
    `step_generator(seed, step)`."""
    return make_restart_inits(spec, cfg, step_generator(seed, step, device))


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
