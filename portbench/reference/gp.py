"""Plain reference of an exact Gaussian process: the stationary kernels,
the negative log marginal likelihood, its multi-restart Adam fit, and
greedy Krause mutual-information selection over a candidate set.

Written from the textbook definitions in plain PyTorch, in whatever
dtype the caller gives (float64 for the reference, float32 with TF32 for
the benchmark's control).  It imports nothing of the program and takes
none of its state: the benchmark hands both sides the same inputs and
this module works out the fit, the factors, the scores and the sites
again.

Selection follows Krause, Singh and Guestrin (JMLR 2008): the score of a
candidate y is Var(z_y | z_A) / Var(z_y | z_rest), with A the pilots and
the sites taken so far and `rest` every other candidate, for noisy
observations z = f + ε.  The denominator is 1 / P_yy for the precision P
of the noisy observations over `rest`, kept dense and shrunk by one Schur
complement a round.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

LOG2PI = math.log(2.0 * math.pi)
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
    """s² k(x1, x2) with ARD lengthscales; the squared distances of the
    scaled coordinates a, b as |a|² + |b|² − 2 a·b, one matrix product
    (exact to 1e-12 in float64; the product is what TF32 would round in
    the control).  Leading batch dims of the parameters broadcast
    (log_ls (..., d), log_s2 (...,))."""
    inv = torch.exp(-log_ls)[..., None, :]
    a, b = x1 * inv, x2 * inv
    r2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * a @ b.mT)
    return torch.exp(log_s2)[..., None, None] * stationary(kind, torch.clamp_min(r2, 0.0))


def neg_mll(kind, x, y, log_ls, log_s2, log_noise, *, min_noise, jitter,
            noise_scale=None):
    """½ yᵀK⁻¹y + ½ log|K| + (n/2) log 2π with K = s²k(X, X) + diag(σ²·scale
    + jitter), σ² floored at min_noise² and scale 1 unless given (n,); one
    value per restart."""
    n = x.shape[0]
    nv = torch.clamp_min(torch.exp(2.0 * log_noise), min_noise * min_noise)
    scale = (torch.ones(n, dtype=x.dtype, device=x.device) if noise_scale is None
             else noise_scale.to(x.dtype))
    K = gram(kind, x, x, log_ls, log_s2)
    K = K + torch.diag_embed(nv[..., None] * scale + jitter)
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(y.expand(*K.shape[:-1])[..., None], L)[..., 0]
    return (0.5 * (y * alpha).sum(-1)
            + torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
            + 0.5 * n * LOG2PI)


def fit_adam(kind, x, y, inits: dict, *, iters, lr, min_noise, jitter,
             learn_noise=True, noise_scale=None) -> dict:
    """Adam (optax's scale_by_adam, bias-corrected) on the negative MLL,
    every restart of `inits` (log_ls (R, d), log_s2 (R,), log_noise (R,))
    at once.  Each restart keeps the best value it has seen, the final
    iterate included; a non-finite restart never wins; the lowest NLL wins,
    the lowest index on ties.  Returns the winner's parameters, its NLL,
    every restart's best NLL and parameters, the winner's index, and the
    NLL of every restart before each step (`trace`, (R, iters))."""
    names = ("log_ls", "log_s2", "log_noise")
    p = [inits[k].detach().clone() for k in names]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    best = torch.full(p[0].shape[:1], math.inf, dtype=x.dtype, device=x.device)
    best_p = [t.clone() for t in p]
    trace = []

    def loss(q):
        noise = q[2] if learn_noise else q[2].detach()
        return neg_mll(kind, x, y, q[0], q[1], noise, min_noise=min_noise,
                       jitter=jitter, noise_scale=noise_scale)

    def keep(nll, q):
        nonlocal best, best_p
        better = nll < best
        best = torch.where(better, nll, best)
        best_p = [torch.where(better.reshape(-1, *[1] * (a.dim() - 1)), a, b)
                  for a, b in zip(q, best_p)]

    for t in range(1, iters + 1):
        q = [a.requires_grad_(True) for a in p]
        nll = loss(q)
        g = torch.autograd.grad(nll.sum(), q, allow_unused=True)
        g = [torch.zeros_like(a) if gi is None else gi for a, gi in zip(q, g)]
        with torch.no_grad():
            p = [a.detach() for a in q]
            keep(nll.detach(), p)
            trace.append(nll.detach())
            c1, c2 = 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t
            mu = [(1 - ADAM_B1) * gi + ADAM_B1 * m for gi, m in zip(g, mu)]
            nu = [(1 - ADAM_B2) * gi * gi + ADAM_B2 * v for gi, v in zip(g, nu)]
            p = [a - lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
                 for a, m, v in zip(p, mu, nu)]
    with torch.no_grad():
        keep(loss(p), p)
        best = torch.where(torch.isfinite(best), best, math.inf)
        k = int(torch.argmin(best))
    return {"log_ls": best_p[0][k], "log_s2": best_p[1][k],
            "log_noise": best_p[2][k], "nll": best[k], "all_nlls": best,
            "all_params": best_p, "best_restart": k,
            "trace": torch.stack(trace, -1)}


def greedy_mi(kind, x, nv, pilot_idx, pilot_nv, log_ls, log_s2, rounds: int,
              follow: Optional[torch.Tensor] = None) -> dict:
    """Greedy Krause-MI selection of `rounds` sites over the candidates x
    (N, d) with future-measurement noise nv (N,), after conditioning on
    the pilots (noise pilot_nv).  Without `follow` it takes the argmax
    each round (lowest index on ties); with `follow` (rounds,) it takes
    those sites instead and reports, for each, how far its score lies
    below the round's best: gap = (best − score) / best, infinite for a
    site already taken or out of range.  Returns the sites, the gaps and
    the posterior variance of every candidate after the last round."""
    N = x.shape[0]
    dev, dt = x.device, x.dtype
    A = pilot_idx.to(device=dev, dtype=torch.int64)
    K = gram(kind, x, x, log_ls, log_s2)
    # the precision of the noisy observations over all candidates
    L = torch.linalg.cholesky(K + torch.diag(nv))
    W = torch.linalg.solve_triangular(L, torch.eye(N, dtype=dt, device=dev), upper=False)
    del L
    P = W.T @ W
    del W
    # condition on the pilots: basis rows C with d = k(x, x) − Σ C²
    LA = torch.linalg.cholesky(K[A][:, A] + torch.diag(pilot_nv.to(dt)))
    B = torch.linalg.solve_triangular(LA, K[A], upper=False)
    d = torch.diagonal(K).clone() - (B * B).sum(0)
    # remove the pilots from the precision: P ← P − P[:, A] P_AA⁻¹ P[A, :]
    U = P[:, A]
    P -= U @ torch.linalg.solve(U[A], U.T)
    del U
    taken = torch.zeros(N, dtype=torch.bool, device=dev)
    taken[A] = True
    sites, gaps = [], []
    for r in range(rounds):
        s = torch.where(taken, -math.inf, (d + nv) * torch.diagonal(P))
        top = s.max()
        if follow is None:
            j = int(torch.argmax(s))
        else:
            j = int(follow[r])
            if not 0 <= j < N or bool(taken[j]):
                gaps.append(math.inf)
                break
        gaps.append(float((top - s[j]) / top))
        sites.append(j)
        col = K[:, j] - B.T @ B[:, j]
        c = col / torch.sqrt(d[j] + nv[j])
        B = torch.cat([B, c[None]])
        d = d - c * c
        u = P[:, j].clone()
        P.addr_(u, u / u[j], alpha=-1.0)
        taken[j] = True
    return {"selected": torch.tensor(sites, dtype=torch.int64), "gaps": gaps,
            "post_var": d}
