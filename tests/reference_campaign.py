"""Plain reference of the long SGPR campaign (preset `c5_long`): the exact
GP posterior, the exact mutual-information score of a path's sample set
under the implicit complement precision, the `per_cost` path utility,
Titsias' collapsed bound over a padded buffer with heteroscedastic noise,
the k-center design over its valid rows, and Adam from given inits.

Written from the definitions in plain PyTorch, in whatever dtype the
caller gives (float64 for the reference).  It imports nothing of the
program under test, and TF32 matmuls are switched off at import (they
would round float32 products; float64 is never rounded by them).

The model:
- the samples A (noisy, variance σ²·scale each, σ² floored at
  min_noise²) condition an exact GP: mean and variance at every cell;
- the prior precision of the noisy field over all N cells is
  P = (K + σ²_f I)⁻¹, σ²_f the future measurements' noise; deleting A
  (its Schur complement, a repeated sample deleted once) gives the
  precision of the cells not sampled;
- a set S's score is ½ log det(Σ_S|A + σ²_f I + 1e-6 I) + ½ log det of
  that precision on S: Krause's MI of the set, with a repeated slot and
  the padding masked out and a site already sampled given unit,
  uncoupled precision;
- the path chosen is the one of most information (clamped at 0) per unit
  of its cost (`per_cost`);
- the collapsed bound over inducing points z,
  −ELBO = −log N(y | 0, Q + Λ) + ½ tr(Λ⁻¹(K − Q)), Q = K_xz K_zz⁻¹ K_zx,
  Λ = diag(σ²·scale), over the valid rows of a padded buffer;
- the design: k-center (maximin) over the valid rows, from row 0, the
  farthest row (squared distance) from the chosen set each round, the
  first of tied maxima.

Departures from the paper's and the preset's mathematics, each the
program's own convention, kept so both sides compute one thing:
- K_zz carries 1e-6·s² on its diagonal, and the MI blocks 1e-6 on theirs;
- the −ELBO is computed densely (an n × n factor of Q + Λ), not through
  Woodbury: the same number, reached another way;
- a padded buffer's rows past its count are dropped, which is what the
  program's identity padding amounts to (they add exactly zero).
"""

from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LOG2PI = math.log(2.0 * math.pi)
Z_JITTER = 1e-6
SET_JITTER = 1e-6
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def stationary(kind: str, r2: torch.Tensor) -> torch.Tensor:
    """Unit-variance kernel value from the scaled squared distance."""
    if kind == "rbf":
        return torch.exp(-0.5 * r2)
    r = torch.sqrt(torch.clamp_min(r2, 1e-20))
    if kind == "matern32":
        a = math.sqrt(3.0) * r
        return (1.0 + a) * torch.exp(-a)
    if kind == "matern52":
        a = math.sqrt(5.0) * r
        return (1.0 + a + a * a / 3.0) * torch.exp(-a)
    raise ValueError(f"unknown kernel kind {kind!r}")


def gram(kind: str, x1, x2, log_ls, log_s2) -> torch.Tensor:
    """s² k(x1, x2) with ARD lengthscales; leading batch dims of the
    parameters broadcast (log_ls (..., d), log_s2 (...,))."""
    inv = torch.exp(-log_ls)[..., None, :]
    a, b = x1 * inv, x2 * inv
    r2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * a @ b.mT)
    return torch.exp(log_s2)[..., None, None] * stationary(kind, torch.clamp_min(r2, 0.0))


def posterior(kind, x, xA, yA, nvA, log_ls, log_s2):
    """Exact GP posterior mean and variance (clamped at 0) at every x."""
    LA = torch.linalg.cholesky(gram(kind, xA, xA, log_ls, log_s2) + torch.diag(nvA))
    w = torch.linalg.solve_triangular(LA, yA[:, None], upper=False)[:, 0]
    C = torch.linalg.solve_triangular(LA, gram(kind, xA, x, log_ls, log_s2), upper=False)
    return C.T @ w, torch.clamp_min(torch.exp(log_s2) - (C * C).sum(0), 0.0)


def prior_precision(kind, x, nv_future: float, log_ls, log_s2) -> torch.Tensor:
    """P = (K(X, X) + nv_future·I)⁻¹ over all the cells, dense."""
    K = gram(kind, x, x, log_ls, log_s2)
    K.diagonal().add_(nv_future)
    return torch.cholesky_inverse(torch.linalg.cholesky(K))


def set_scores(kind, x, sets, sizes, A, nvA, nv_future: float, P, log_ls, log_s2):
    """MI scores (S,) of the padded sets (S, k) given the samples A (with
    repeats, noise nvA) under the prior precision P with A deleted."""
    dev, dt = x.device, x.dtype
    S, k = sets.shape
    rows = sets.reshape(-1)
    xr, xA = x[rows], x[A]
    LA = torch.linalg.cholesky(gram(kind, xA, xA, log_ls, log_s2) + torch.diag(nvA))
    C = torch.linalg.solve_triangular(LA, gram(kind, xA, xr, log_ls, log_s2), upper=False)
    Cs = C.T.reshape(S, k, -1)
    xs = xr.reshape(S, k, -1)
    same = sets[:, :, None] == sets[:, None, :]
    first = ~torch.tril(same, diagonal=-1).any(dim=2)
    mask = (torch.arange(k, device=dev)[None, :] < sizes[:, None]) & first
    pair = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(k, dtype=dt, device=dev)
    M1 = gram(kind, xs, xs, log_ls, log_s2) - Cs @ Cs.mT + nv_future * eye
    M1 = torch.where(pair, M1, 0.0) + torch.diag_embed(
        torch.where(mask, SET_JITTER, 1.0).to(dt))
    h1 = torch.log(torch.diagonal(torch.linalg.cholesky(M1), dim1=-2, dim2=-1)).sum(-1)
    # the precision of the cells not sampled, on each set
    Au = torch.unique(A)
    F = P[rows][:, Au]  # (S·k, a)
    Z = torch.cholesky_solve(F.T, torch.linalg.cholesky(P[Au][:, Au]))  # P_AA⁻¹ P_AR
    Pss = P[sets[:, :, None], sets[:, None, :]] - F.reshape(S, k, -1) @ Z.T.reshape(S, k, -1).mT
    tk = torch.isin(rows, Au).reshape(S, k)
    Pss = torch.where(tk[:, :, None] | tk[:, None, :], 0.0, Pss)
    Pss = torch.where(eye.bool()[None] & tk[:, :, None], 1.0, Pss)
    Pss = torch.where(pair, Pss, 0.0) + torch.diag_embed(torch.where(mask, 0.0, 1.0).to(dt))
    h2 = torch.log(torch.diagonal(torch.linalg.cholesky(Pss), dim1=-2, dim2=-1)).sum(-1)
    return h1 + h2


def per_cost_utility(scores, sizes, costs):
    """Information (clamped at 0) per unit cost; −inf for empty sets."""
    return torch.where(sizes > 0, torch.clamp_min(scores, 0.0) / costs.to(scores.dtype),
                       -math.inf)


def kcenter(x: torch.Tensor, m: int, count: int) -> torch.Tensor:
    """The k-center design of m rows over the first `count` rows of x."""
    live = x[:count]
    d = ((live - live[0]) ** 2).sum(1)
    chosen = [0]
    for _ in range(1, m):
        j = int(torch.argmax(d))
        chosen.append(j)
        d = torch.minimum(d, ((live - live[j]) ** 2).sum(1))
    return torch.tensor(chosen, dtype=torch.int64, device=x.device)


def neg_elbo(kind, x, y, z, log_ls, log_s2, log_noise, *, min_noise, count,
             noise_scale=None):
    """The collapsed −ELBO over the first `count` rows of the padded
    (x, y, noise_scale), one value per leading batch element of the
    parameters (log_ls (R, d), log_s2 (R,), log_noise (R,))."""
    x, y = x[:count], y[:count]
    n, M = x.shape[0], z.shape[0]
    scale = (torch.ones(n, dtype=x.dtype, device=x.device) if noise_scale is None
             else noise_scale[:count].to(x.dtype))
    lam = torch.clamp_min(torch.exp(2.0 * log_noise), min_noise * min_noise)[..., None] * scale
    eye = torch.eye(M, dtype=x.dtype, device=x.device)
    Kzz = gram(kind, z, z, log_ls, log_s2) + (Z_JITTER * torch.exp(log_s2))[..., None, None] * eye
    Kzx = gram(kind, z, x, log_ls, log_s2)
    Q = Kzx.mT @ torch.cholesky_solve(Kzx, torch.linalg.cholesky(Kzz))
    L = torch.linalg.cholesky(Q + torch.diag_embed(lam))
    alpha = torch.cholesky_solve(y.expand(*lam.shape)[..., None], L)[..., 0]
    nll = (0.5 * (y * alpha).sum(-1)
           + torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1) + 0.5 * n * LOG2PI)
    kdiag = torch.exp(log_s2)[..., None].expand(*lam.shape)  # stationary: k(x, x) = s²
    return nll + 0.5 * ((kdiag - torch.diagonal(Q, dim1=-2, dim2=-1)) / lam).sum(-1)


def adam(loss, inits: list, *, iters: int, lr: float) -> dict:
    """Adam (bias-corrected, optax's scale_by_adam) on `loss`, which maps
    the list of parameter tensors (leading restart axis) to one value per
    restart.  Each restart keeps the best value it has seen, the final
    iterate included; a non-finite restart never wins; the lowest value
    wins, the lowest index on ties.  Returns the winner's parameters and
    value, each restart's best, and `trace`, every restart's value before
    each step (R, iters)."""
    p = [t.detach().clone() for t in inits]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    best = torch.full(p[0].shape[:1], math.inf, dtype=p[0].dtype, device=p[0].device)
    best_p = [t.clone() for t in p]
    trace = []

    def keep(v, q):
        nonlocal best, best_p
        better = v < best
        best = torch.where(better, v, best)
        best_p = [torch.where(better.reshape(-1, *[1] * (a.dim() - 1)), a, b)
                  for a, b in zip(q, best_p)]

    for t in range(1, iters + 1):
        q = [a.requires_grad_(True) for a in p]
        v = loss(q)
        g = torch.autograd.grad(v.sum(), q)
        with torch.no_grad():
            p = [a.detach() for a in q]
            keep(v.detach(), p)
            trace.append(v.detach())
            c1, c2 = 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t
            mu = [(1 - ADAM_B1) * gi + ADAM_B1 * m for gi, m in zip(g, mu)]
            nu = [(1 - ADAM_B2) * gi * gi + ADAM_B2 * w for gi, w in zip(g, nu)]
            p = [a - lr * (m / c1) / (torch.sqrt(w / c2) + ADAM_EPS)
                 for a, m, w in zip(p, mu, nu)]
    with torch.no_grad():
        keep(loss(p), p)
        best = torch.where(torch.isfinite(best), best, math.inf)
        k = int(torch.argmin(best))
    return {"params": [b[k] for b in best_p], "value": best[k], "all_values": best,
            "best_restart": k, "trace": torch.stack(trace, -1)}
