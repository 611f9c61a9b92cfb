"""Greedy entropy / Krause mutual-information selection on the device (the
counterpart of the main-path parts of algp_tpu.acquisition).

The posterior over all N candidates is kept as a growing basis B (T × N):
row t is the normalised posterior covariance column of the t-th selected
point, and d ← d − c² tracks every candidate's posterior variance; no
round refactorizes anything.  The Krause-MI denominator uses the
precision identity Var(z_y | z_rest) = 1/[(K+Σ)⁻¹]_yy with an implicit
complement precision P = WᵀW − F·G: W = L⁻¹ is built once, F and G grow
by one Schur correction per round, and the round's column (WᵀW)[:, j]
comes from the CUDA kernel of `ops.updates`.

The round loop is a Python loop whose every step stays on the device:
the selected index j is a device tensor, every gather uses tensor
indices, and nothing reads a value back until the caller does.  Argmax
is `torch.argmax` (lowest index wins ties), matching the f64 oracle in
tests/oracle.py.

Not ported yet: the path-set scoring and the episode steps (config 5),
`cond_solve`'s explicit-inverse branch for ≥ 2²⁰ candidates, and the
low-rank planner; see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from algp_tpu_torch.config import FitConfig
from algp_tpu_torch.models import gp as gp_mod
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.gram import gram_kernel_with_noise
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec, gram, gram_diag
from algp_tpu_torch.ops.updates import wtw_column


@dataclasses.dataclass
class SelectionResult:
    """Outcome of a greedy selection run.

    selected : (rounds,) int64 — chosen candidate indices, in order
    post_var : (N,) posterior variance of every candidate after all rounds
    scores   : (rounds, N) per-round score fields (-inf at taken entries),
               or a (0, N) placeholder when traces are off
    basis    : (T, N) the conditioning basis (pilot rows first)
    """

    selected: torch.Tensor
    post_var: torch.Tensor
    scores: torch.Tensor
    basis: torch.Tensor

    def truncate(self, n: int) -> "SelectionResult":
        """Drop the alignment-padding candidates beyond the first n."""
        return SelectionResult(
            selected=self.selected, post_var=self.post_var[:n],
            scores=self.scores[:, :n], basis=self.basis[:, :n],
        )


def pad_candidates(
    x: torch.Tensor, nv: torch.Tensor, *, align: int = 512
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad the candidate axis to an `align` multiple with inert sentinels:
    distinct far-away coordinates (kernel ≈ 0 to everything), noise 1,
    born taken downstream.  Kept from the reference so that every
    intermediate shape equals its own."""
    N = x.shape[0]
    N_pad = (N + align - 1) // align * align
    if N_pad == N:
        return x, nv
    pad = N_pad - N
    far = -1e6 - 1e3 * torch.arange(
        1, pad + 1, dtype=torch.float32, device=x.device
    )
    x = torch.cat([x, far[:, None].expand(pad, x.shape[1])], dim=0)
    nv = torch.cat([nv, torch.ones((pad,), dtype=nv.dtype, device=nv.device)])
    return x, nv


def _posterior_col(spec, params, x, j1, B):
    """Posterior covariance column for candidate j (j1: a (1,) device
    index) given the filled basis rows of B (unfilled rows are zero)."""
    prior_col = gram(spec, params, x, x.index_select(0, j1))[:, 0]
    Bj = B.index_select(1, j1)[:, 0]  # B[:, j]
    return prior_col - B.T @ Bj


def _condition(B, d, col, j1, nv_j, t):
    """Rank-1 conditioning on a noisy observation at candidate j; writes
    basis row t in place."""
    c = col / torch.sqrt(d.index_select(0, j1) + nv_j)
    B[t] = c
    return B, d - c * c


def greedy_select(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    nv: torch.Tensor,
    pilot_idx: torch.Tensor,
    *,
    rounds: int,
    num_pilot: int,
    strategy: str = "entropy",
    return_scores: bool = False,
    pilot_count=None,
    pilot_nv: Optional[torch.Tensor] = None,
) -> SelectionResult:
    """Greedy active sampling over N candidates, on x's device.

    x         : (N, dim) candidate locations (+ features)
    nv        : (N,) observation-noise variance of future measurements
    pilot_idx : (num_pilot,) indices already sampled (conditioned first,
                never re-selected); shape (0,) for none
    pilot_nv  : optional (num_pilot,) noise variance of the pilot
                measurements (defaults to nv at pilot_idx)
    pilot_count: optional count ≤ num_pilot of real pilot slots
    strategy  : "entropy" (score d + nv) or "mi" (Krause ratio
                (d + nv) · P_yy)

    Matches tests/oracle.py greedy_{variance,mi}_selection index for index.
    """
    if strategy not in ("entropy", "mi"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if pilot_count is None:
        pilot_count = num_pilot
    pilot_idx = pilot_idx.to(device=x.device, dtype=torch.int64)
    if pilot_nv is None:
        pilot_nv = nv.index_select(0, pilot_idx)
    N = x.shape[0]
    x, nv = pad_candidates(x, nv, align=512)
    res = _greedy_select(
        spec, params, x, nv, pilot_idx, pilot_count, pilot_nv,
        rounds=rounds, num_pilot=num_pilot, strategy=strategy,
        return_scores=return_scores, n_valid=N,
    )
    return res.truncate(N) if x.shape[0] != N else res


def _greedy_select(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    nv: torch.Tensor,
    pilot_idx: torch.Tensor,
    pilot_count,
    pilot_nv: torch.Tensor,
    *,
    rounds: int,
    num_pilot: int,
    strategy: str,
    return_scores: bool,
    n_valid: Optional[int] = None,
) -> SelectionResult:
    """The selection loop on (alignment-padded) candidates."""
    dev = x.device
    N = x.shape[0]
    if n_valid is None:
        n_valid = N
    T = num_pilot + rounds
    d = gram_diag(spec, params, x)
    B = torch.zeros((T, N), dtype=torch.float32, device=dev)
    # alignment-padding candidates (index ≥ n_valid) are born taken
    taken = torch.arange(N, device=dev) >= n_valid
    sel = torch.zeros((rounds,), dtype=torch.int64, device=dev)

    # pilot phase, batched: one m×m Cholesky + one m×N trisolve, identical
    # in exact arithmetic to sequential rank-1 conditioning in pilot order
    if num_pilot:
        C, d, taken_pilot, _ = _batch_pilot_condition(
            spec, params, x, pilot_nv, pilot_idx, pilot_count, d,
        )
        taken = taken | taken_pilot
        B[:num_pilot] = C

    if strategy == "mi":
        # implicit complement precision P_t = WᵀW − F·G (never N×N dense)
        K = gram_kernel_with_noise(spec, params, x, nv / params.noise_var)
        W = la.tri_inv(la.cholesky(K))
        del K
        pdiag = torch.sum(W * W, dim=0)  # diag(WᵀW) = column sums of W²
        F = torch.zeros((N, T), dtype=torch.float32, device=dev)
        G = torch.zeros((T, N), dtype=torch.float32, device=dev)
        if num_pilot:
            F, G, pdiag = _implicit_pilot_delete(
                W, pilot_idx, pilot_count, F, G, pdiag, num_pilot
            )

    scores = torch.full(
        (rounds if return_scores else 0, N), -torch.inf, device=dev
    )
    for r in range(rounds):
        num = d + nv
        s = num if strategy == "entropy" else num * pdiag
        s = torch.where(taken, -torch.inf, s)
        j1 = torch.argmax(s).reshape(1)  # device index, never read here
        if return_scores:
            scores[r] = s

        t = num_pilot + r
        col = _posterior_col(spec, params, x, j1, B)
        B, d = _condition(B, d, col, j1, nv.index_select(0, j1), t)
        if strategy == "mi":
            # current precision column u = (WᵀW)[:, j] − F·G[:, j]
            u = wtw_column(W, j1) - F @ G.index_select(1, j1)[:, 0]
            pjj = pdiag.index_select(0, j1)
            F[:, t] = u
            G[t] = u / pjj
            pdiag = pdiag - (u * u) / pjj
            pdiag.index_fill_(0, j1, 1.0)
        taken.index_fill_(0, j1, True)
        sel[r] = j1[0]
    return SelectionResult(selected=sel, post_var=d, scores=scores, basis=B)


def _implicit_pilot_delete(W, pilot_idx, pilot_count, F, G, pdiag, num_pilot):
    """Batch-remove the pilot block from the implicit precision:
    P1 = P0 − U0 PA⁻¹ U0ᵀ with U0 = P0[:, A] = Wᵀ W[:, A], stored as
    F[:, :m] = U0, G[:m] = PA⁻¹ U0ᵀ.  Padded pilot slots contribute
    exact zeros.

    Duplicate pilot indices (a node measured twice) are deduplicated:
    only the first occurrence participates, since a second delete of the
    same index would make PA singular and NaN every MI score.
    """
    dev = W.device
    N = W.shape[0]
    m = num_pilot
    valid = torch.arange(m, device=dev) < pilot_count
    same = (
        (pilot_idx[:, None] == pilot_idx[None, :])
        & valid[:, None] & valid[None, :]
    )
    dup = torch.tril(same, diagonal=-1).any(dim=1)  # an earlier slot holds it
    valid = valid & ~dup
    validf = valid.to(torch.float32)
    idx_safe = torch.where(valid, pilot_idx, 0)
    WE = W.index_select(1, idx_safe) * validf  # (N, m) = W[:, A]
    U0 = (WE.T @ W).T  # (N, m) = P0[:, A]
    PA = U0.index_select(0, idx_safe) * validf[:, None]
    pair = valid[:, None] & valid[None, :]
    PA = torch.where(pair, PA, torch.eye(m, dtype=torch.float32, device=dev))
    LA = la.cholesky(PA)
    Z = la.cho_solve(LA, U0.T) * validf[:, None]  # (m, N) = PA⁻¹ U0ᵀ
    F[:, :m] = U0
    G[:m] = Z
    pdiag = pdiag - torch.sum(U0 * Z.T, dim=1)
    return F, G, torch.where(_mask_of(pilot_idx, valid, N), 1.0, pdiag)


def _mask_of(idx, valid, N):
    """(N,) bool: True at the valid entries of idx."""
    mask = torch.zeros((N + 1,), dtype=torch.bool, device=idx.device)
    mask.index_fill_(0, torch.where(valid, idx, N), True)
    return mask[:N]


def _batch_pilot_condition(spec, params, x, pilot_nv, pilot_idx, pilot_count,
                           d0):
    """Condition the candidate field on all pilots in one batched op.

    Returns (C, d, taken, LA): C (m, N) the basis rows (row t is the
    normalised posterior-covariance row of pilot t given pilots < t), d
    the updated posterior variances, taken the pilot mask, LA the
    identity-padded Cholesky factor of K_AA + Σ_A.  Padded pilot slots
    (≥ pilot_count) contribute exactly zero.
    """
    dev = x.device
    m = pilot_idx.shape[0]
    N = x.shape[0]
    valid = torch.arange(m, device=dev) < pilot_count
    idx_safe = torch.where(valid, pilot_idx, 0)
    xA = x.index_select(0, idx_safe)
    KA = gram(spec, params, xA, xA) + torch.diag(pilot_nv)
    pair = valid[:, None] & valid[None, :]
    KA = torch.where(pair, KA, torch.eye(m, dtype=torch.float32, device=dev))
    LA = la.cholesky(KA)
    Kc = gram(spec, params, xA, x) * valid[:, None].to(torch.float32)
    C = la.solve_triangular(LA, Kc)
    d = d0 - torch.sum(C * C, dim=0)
    return C, d, _mask_of(pilot_idx, valid, N), LA


def fit_and_select(
    spec: KernelSpec,
    fitcfg: FitConfig,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    x: torch.Tensor,
    pilot_idx: torch.Tensor,
    *,
    rounds: int,
    num_pilot: int,
    strategy: str = "mi",
    generator: Optional[torch.Generator] = None,
    inits: Optional[KernelParams] = None,
):
    """The north-star workload: multi-restart MLL fit, then greedy
    selection over all N candidates with the fitted hyperparameters.
    Candidate noise is the fitted base noise variance.  `inits` (restart
    axis leading) replaces the restart inits drawn from `generator`.
    Nothing waits for the device until the caller reads a result.

    Returns (fit_result, SelectionResult).
    """
    N = x.shape[0]
    x_pad, _ = pad_candidates(x, torch.ones((N,), device=x.device))
    if inits is None:
        inits = gp_mod.make_restart_inits(
            spec, fitcfg, generator, device=x.device
        )
    fit_res = gp_mod._fit_batched(spec, fitcfg, x_train, y_train, None, inits)
    nv_base = torch.clamp_min(
        torch.exp(2.0 * fit_res.params.log_noise), fitcfg.min_noise**2
    )
    # padded sentinel candidates keep the inert nv = 1 convention
    nv = torch.where(
        torch.arange(x_pad.shape[0], device=x.device) < N, nv_base, 1.0
    ).to(torch.float32)
    pilot_idx = pilot_idx.to(device=x.device, dtype=torch.int64)
    sel = _greedy_select(
        spec, fit_res.params, x_pad, nv, pilot_idx, num_pilot,
        nv_base.expand(num_pilot).clone(),
        rounds=rounds, num_pilot=num_pilot, strategy=strategy,
        return_scores=False, n_valid=N,
    )
    return fit_res, sel.truncate(N) if x_pad.shape[0] != N else sel
