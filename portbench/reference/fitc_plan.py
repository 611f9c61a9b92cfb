"""Plain reference of one step of the informative-path planner with the
low-rank (FITC) precision: the exact GP posterior of the field given the
samples so far, and the mutual-information score of every candidate
path's sample set.

The model, from its definition:
- the samples A (noisy, variance σ²·scale each) condition an exact GP:
  mean and variance over every cell, and the posterior covariance of a
  path's sites S;
- the precision of the noisy field is the FITC one, P̃ = (Q + D)⁻¹ with
  Q = K_xz K_zz⁻¹ K_zx over M k-center inducing points z (K_zz with
  1e-6·s² on its diagonal) and D = diag(k(x, x) − q(x) + σ²_future);
  by Woodbury P̃_ij = δ_ij/D_i − v_i·v_j, v_i = L_B⁻¹ u_i / D_i with
  u_i = L_zz⁻¹ k_z(x_i) and B = I + Σ_i u_i u_iᵀ / D_i;
- a set's score is ½ log det(Σ_S|A + σ²I + 1e-6 I) + ½ log det of P̃
  with A removed (its Schur complement) on S: Krause's MI of the set,
  with repeated sites and padding masked out and sites already sampled
  given unit, uncoupled precision;
- the path chosen is the one of most information per sample among the
  paths whose cost per sample is within 1.25 of the cheapest.

Everything in the dtype of the inputs; the candidate axis in blocks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.gp import gram

Z_JITTER = 1e-6
PRICE_TOL = 1.25
SET_JITTER = 1e-6


def subgrid(nr: int, nc: int, target: int) -> np.ndarray:
    """Flat indices of a uniform sub-grid of about `target` points: the
    stride s = ceil(nr·nc / target) split over the axes, s_c = ceil(√s),
    s_r = ceil(s / s_c)."""
    s = -(-(nr * nc) // target)
    sc = 1
    while sc * sc < s:
        sc += 1
    sr = -(-s // sc)
    return (np.arange(0, nr, sr, dtype=np.int64)[:, None] * nc
            + np.arange(0, nc, sc, dtype=np.int64)).ravel()


def kcenter(x: torch.Tensor, m: int, start: int = 0) -> torch.Tensor:
    """Greedy maximin design: start at `start`, then m − 1 times the point
    farthest (squared distance) from the chosen set, the first on ties."""
    d = ((x - x[start]) ** 2).sum(1)
    chosen = [start]
    for _ in range(1, m):
        j = int(torch.argmax(d))
        chosen.append(j)
        d = torch.minimum(d, ((x - x[j]) ** 2).sum(1))
    return torch.tensor(chosen, dtype=torch.int64, device=x.device)


class Fitc:
    """The FITC precision over the candidates x, built in blocks."""

    def __init__(self, kind, x, z, log_ls, log_s2, nv: float, block: int = 1 << 19):
        self.kind, self.z, self.log_ls, self.log_s2, self.nv = kind, z, log_ls, log_s2, nv
        M = z.shape[0]
        eye = torch.eye(M, dtype=z.dtype, device=z.device)
        s2 = torch.exp(log_s2)
        self.Lzz = torch.linalg.cholesky(gram(kind, z, z, log_ls, log_s2) + Z_JITTER * s2 * eye)
        B = eye.clone()
        for lo in range(0, x.shape[0], block):
            U, d = self._ud(x[lo:lo + block])
            B += (U / d) @ U.T
        self.LB = torch.linalg.cholesky(B)

    def _ud(self, xr):
        U = torch.linalg.solve_triangular(
            self.Lzz, gram(self.kind, self.z, xr, self.log_ls, self.log_s2), upper=False)
        d = torch.clamp_min(torch.exp(self.log_s2) - (U * U).sum(0), 0.0) + self.nv
        return U, d

    def rows(self, xr):
        """(v (R, M), 1/D (R,)) at the locations xr."""
        U, d = self._ud(xr)
        V = torch.linalg.solve_triangular(self.LB, U / d, upper=False)
        return V.T, 1.0 / d


def posterior(kind, x, xA, yA, nvA, log_ls, log_s2, block: int = 1 << 19):
    """Exact GP posterior mean and variance (clamped at 0) at every x."""
    LA = torch.linalg.cholesky(gram(kind, xA, xA, log_ls, log_s2) + torch.diag(nvA))
    w = torch.linalg.solve_triangular(LA, yA[:, None], upper=False)[:, 0]
    mean, var = [], []
    s2 = torch.exp(log_s2)
    for lo in range(0, x.shape[0], block):
        C = torch.linalg.solve_triangular(
            LA, gram(kind, xA, x[lo:lo + block], log_ls, log_s2), upper=False)
        mean.append(C.T @ w)
        var.append(torch.clamp_min(s2 - (C * C).sum(0), 0.0))
    return torch.cat(mean), torch.cat(var)


def set_scores(kind, x, sets, sizes, A, nvA, nv_future, fitc: Fitc, log_ls, log_s2):
    """MI scores (S,) of the padded sets (S, k) given the samples A (with
    repeats, noise nvA) under the FITC precision."""
    dev, dt = x.device, x.dtype
    S, k = sets.shape
    rows = sets.reshape(-1)
    xr = x[rows]
    xA = x[A]
    # posterior covariance of each set given A
    LA = torch.linalg.cholesky(gram(kind, xA, xA, log_ls, log_s2) + torch.diag(nvA))
    C = torch.linalg.solve_triangular(LA, gram(kind, xA, xr, log_ls, log_s2), upper=False)
    Cs = C.T.reshape(S, k, -1)
    xs = xr.reshape(S, k, -1)
    Kp = gram(kind, xs, xs, log_ls, log_s2)
    same = sets[:, :, None] == sets[:, None, :]
    first = ~torch.tril(same, diagonal=-1).any(dim=2)
    mask = (torch.arange(k, device=dev)[None, :] < sizes[:, None]) & first
    pair = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(k, dtype=dt, device=dev)
    M1 = Kp - Cs @ Cs.mT + nv_future * eye
    M1 = torch.where(pair, M1, 0.0) + torch.diag_embed(
        torch.where(mask, SET_JITTER, 1.0).to(dt))
    h1 = torch.log(torch.diagonal(torch.linalg.cholesky(M1), dim1=-2, dim2=-1)).sum(-1)
    # the FITC precision with A removed, on each set
    Au = torch.unique(A)
    VA, dA = fitc.rows(x[Au])
    Vr, dr = fitc.rows(xr)
    PA = -(VA @ VA.T) + torch.diag(dA)
    F = -(Vr @ VA.T) + (rows[:, None] == Au[None, :]).to(dt) * dr[:, None]
    Z = torch.cholesky_solve(F.T, torch.linalg.cholesky(PA))  # PA⁻¹ Fᵀ
    Vs, ds = Vr.reshape(S, k, -1), dr.reshape(S, k)
    P = -(Vs @ Vs.mT) + same.to(dt) * ds[:, :, None] - F.reshape(S, k, -1) @ Z.T.reshape(S, k, -1).mT
    tk = torch.isin(rows, Au).reshape(S, k)
    P = torch.where(tk[:, :, None] | tk[:, None, :], 0.0, P)
    P = torch.where(eye.bool()[None] & tk[:, :, None], 1.0, P)
    P = torch.where(pair, P, 0.0) + torch.diag_embed(torch.where(mask, 0.0, 1.0).to(dt))
    h2 = torch.log(torch.diagonal(torch.linalg.cholesky(P), dim1=-2, dim2=-1)).sum(-1)
    return h1 + h2


def per_sample_utility(scores, sizes, costs):
    """Information per sample among the paths priced within PRICE_TOL of
    the cheapest per sample; −inf for the others and for empty sets."""
    valid = sizes > 0
    n = torch.clamp_min(sizes.to(scores.dtype), 1.0)
    price = costs.to(scores.dtype) / n
    p_min = torch.min(torch.where(valid, price, math.inf))
    eligible = valid & (price <= PRICE_TOL * p_min)
    return torch.where(eligible, torch.clamp_min(scores, 0.0) / n, -math.inf)
