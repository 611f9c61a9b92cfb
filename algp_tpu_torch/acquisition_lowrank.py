"""Greedy Krause MI past the exact planner's size, through a low-rank
(Nyström / FITC) complement precision (the counterpart of
algp_tpu.acquisition_lowrank).

    Σ = K + diag(nv) ≈ U Uᵀ + D,   U = K_xz L_zz⁻ᵀ   (N × M),
    D = diag(clamp(k_diag − rowsum U², 0) + nv)        (Σ's diagonal exact)
    P̃ = Σ⁻¹ = D⁻¹ − Vᵀ V,  V = L_B⁻¹ Uᵀ D⁻¹,  B = I + Uᵀ D⁻¹ U   (M × M)

The seed costs O(N·M²) (one Gram of the inducing points against every
candidate, two triangular solves, one M × M product) and a round's
precision column P̃[:, j] = d⁻¹ⱼ eⱼ − Vᵀ(V eⱼ) is one (N × M) matvec.  The
numerator σ²(y|A) + nv stays exact; only the complement's background term
goes through the inducing points.  With Z = X the selections equal the
exact path's.

On CUDA the seeds' K_zx comes from the Gram kernel of `ops.gram`, where
the reference calls `gram_pallas`; `v_rows_at` and the per-set blocks use
the plain `gram`, as the reference does.  The K_zz factor of every seed
is `la.jitter_ladder_cholesky`, the reference's adaptive-jitter factor
with no host read, so a seed is queued without waiting.  The k-center
chain is a Python loop whose index stays on the device.  Vᵀ is kept
row-major: every round and every plan step gathers it by rows.

From 2²⁰ candidates the seeds' (M, N) solves are products with an
explicit inverse (`acquisition.cond_solve`).  The small-factor seed
streams its candidate axis in chunks where the reference does (an (M, N)
buffer past `_SEED_CHUNK_BYTES`), one Gram launch per chunk.  The
z-ensemble (K inducing designs: a (K, M, d) z for the greedy loop, a
list of K factors for the fused step) runs one seed per design and
averages the K designs' MI scores before each argmax; the numerator's
conditioning is shared.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from algp_tpu_torch import acquisition as _acq
from algp_tpu_torch.acquisition import (
    SelectionResult,
    _batch_pilot_condition,
    _condition,
    _mask_of,
    _posterior_col,
    pad_candidates,
)
from algp_tpu_torch.config import FitConfig
from algp_tpu_torch.models import gp as gp_mod
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.gram import gram_kernel
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec, gram, gram_diag

#: relative jitter on K_zz (scaled by the outputscale): keeps the inducing
#: Cholesky positive definite with near-duplicate centers
_Z_JITTER = 1e-6

#: `lowrank_factors_seed` streams its candidate axis in chunks of
#: _SEED_CHUNK once the (M, N) buffer would pass _SEED_CHUNK_BYTES, as the
#: reference does: chunking changes the order of B's sums, so the port
#: computes the reference's function only where it chunks alike
_SEED_CHUNK_BYTES = 5 * 2**30
_SEED_CHUNK = 1 << 20


def _seed_solve(L: torch.Tensor, B: torch.Tensor, n_global: int) -> torch.Tensor:
    """The seeds' (M, N)-shaped triangular solves, gated on the full
    unpadded candidate count (`acquisition.cond_solve`)."""
    return _acq.cond_solve(L, B, n_global)


def _zz_factor(spec, params, z):
    """L_zz of K_zz + _Z_JITTER·s²·I, adaptive jitter without a host read."""
    M = z.shape[0]
    eye = torch.eye(M, dtype=torch.float32, device=z.device)
    Kzz = gram(spec, params, z, z) + _Z_JITTER * torch.exp(params.log_outputscale) * eye
    return la.jitter_ladder_cholesky(Kzz, initial_jitter=1e-5)[0]


def _eye(M, device):
    return torch.eye(M, dtype=torch.float32, device=device)


def _first_occurrence(idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """valid & not a repeat of an earlier valid slot (a node sampled twice
    is deleted once, or PA would be singular)."""
    same = (idx[:, None] == idx[None, :]) & valid[:, None] & valid[None, :]
    return valid & ~torch.tril(same, diagonal=-1).any(dim=1)


@dataclasses.dataclass
class LowRankPrecision:
    """Implicit prior precision P̃ = diag(dinv) − VT·VTᵀ over candidates.

    VT    : (N, M) Vᵀ, row-major (gathered by rows)
    dinv  : (N,)   1 / D
    pdiag : (N,)   diag P̃ = dinv − rowsum VT²
    """

    VT: torch.Tensor
    dinv: torch.Tensor
    pdiag: torch.Tensor


def check_kcenter_m(num_valid, m: int, caller: str) -> None:
    """The `kcenter_indices` contract m ≤ live rows, checked where the live
    count is a host integer (a device count is not read: no check).  Past
    exhaustion the maximin rounds would duplicate index 0, possibly a
    padding row."""
    if isinstance(num_valid, torch.Tensor) and num_valid.device.type != "cpu":
        return
    nv = int(num_valid)
    if nv < m:
        raise ValueError(
            f"{caller}: k-center inducing design needs num_valid ≥ m "
            f"(got {nv} live rows for m={m}) — maximin rounds past "
            f"exhaustion would silently duplicate index 0"
        )


def kcenter_indices(
    x: torch.Tensor, m: int, n_valid=None, *, start: int = 0
) -> torch.Tensor:
    """Greedy k-center (maximin) design: start at `start`, then take the
    candidate farthest (squared raw-input distance) from the chosen set, m
    times in all.  `n_valid` masks alignment-padding rows.  The chosen
    index stays a device tensor, `torch.argmax` takes the first of tied
    maxima (as the reference and the oracle do), nothing is read on the
    host.  Returns (m,) int64."""
    N = x.shape[0]
    live = torch.arange(N, device=x.device) < (N if n_valid is None else n_valid)
    # made on the device (a host tensor's upload would wait for the card)
    ninf = torch.full((), -torch.inf, device=x.device)

    def sq(xj):
        diff = x - xj[None, :]
        return torch.sum(diff * diff, dim=1)

    d = torch.where(live, sq(x[start]), ninf)
    chosen = [torch.full((), start, dtype=torch.int64, device=x.device)]
    for _ in range(1, m):
        j = torch.argmax(d)
        chosen.append(j)
        d = torch.minimum(
            d, torch.where(live, sq(x.index_select(0, j.reshape(1))[0]), ninf))
    return torch.stack(chosen)


def lowrank_precision_seed(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    nv: torch.Tensor,
    z: torch.Tensor,
    *,
    n_valid: Optional[int] = None,
) -> LowRankPrecision:
    """The low-rank implicit precision over all N candidates, O(N·M²).
    Valid per (params, nv, z).  `n_valid`: the unpadded candidate count
    for the solve gate (default: x's length)."""
    n_gate = x.shape[0] if n_valid is None else n_valid
    M = z.shape[0]
    Lzz = _zz_factor(spec, params, z)
    Ut = _seed_solve(Lzz, gram_kernel(spec, params, z, x), n_gate)  # (M, N)
    qdiag = torch.sum(Ut * Ut, dim=0)
    d = torch.clamp_min(gram_diag(spec, params, x) - qdiag, 0.0) + nv
    dinv = 1.0 / d
    A = Ut * dinv[None, :]  # (M, N) = Uᵀ D⁻¹
    B = _eye(M, x.device) + A @ Ut.T
    V = _seed_solve(la.cholesky(B), A, n_gate)  # (M, N)
    VT = V.mT.contiguous()  # row-major once per seed
    pdiag = dinv - torch.sum(VT * VT, dim=1)
    return LowRankPrecision(VT=VT, dinv=dinv, pdiag=pdiag)


def _precision_col(lr: LowRankPrecision, j1: torch.Tensor) -> torch.Tensor:
    """P̃[:, j] = d⁻¹ⱼ eⱼ − VT·VT[j] (j1 a (1,) device index)."""
    vj = lr.VT.index_select(0, j1)[0]
    u0 = -(lr.VT @ vj)
    return u0.index_add(0, j1, lr.dinv.index_select(0, j1))


def _lowrank_schur(lr: LowRankPrecision, idx: torch.Tensor, count):
    """Schur factors deleting set A from P̃: U0 = P̃0[:, A] (N, m) and
    Z = PA⁻¹ U0ᵀ (m, N), duplicate slots deleted once."""
    dev = idx.device
    m = idx.shape[0]
    valid = _first_occurrence(idx, torch.arange(m, device=dev) < count)
    vf = valid.to(torch.float32)
    idx_safe = torch.where(valid, idx, 0)
    VA = lr.VT.index_select(0, idx_safe)  # (m, M)
    U0 = -(lr.VT @ VA.T)  # (N, m)
    ar = torch.arange(m, device=dev)
    U0[idx_safe, ar] += lr.dinv.index_select(0, idx_safe)
    U0 = U0 * vf[None, :]
    PA = U0.index_select(0, idx_safe) * vf[:, None]
    pair = valid[:, None] & valid[None, :]
    PA = torch.where(pair, PA, _eye(m, dev))
    Z = la.cho_solve(la.cholesky(PA), U0.T) * vf[:, None]  # (m, N)
    return U0, Z, valid


def lowrank_corrections(lr: LowRankPrecision, idx: torch.Tensor, count):
    """P̃_V∖A = P̃0 − F·ZTᵀ off A, rebuilt from the seed in one batched op:
    returns (F (N, m), ZT (N, m))."""
    U0, Z, _ = _lowrank_schur(lr, idx, count)
    return U0, Z.T


def _corrections_rows(VA, dA, Vr, dr, rows, idx_safe, valid):
    """(F_rows, ZT_rows): the Schur correction factors restricted to
    candidate `rows`, from the sampled set's precision rows (VA, dA) and
    the rows' own (Vr, dr)."""
    m = VA.shape[0]
    vf = valid.to(torch.float32)
    PA = -(VA @ VA.T) + torch.diag(dA)
    pair = valid[:, None] & valid[None, :]
    PA = torch.where(pair, PA, _eye(m, VA.device))
    LA = la.cholesky(PA)
    F_rows = -(Vr @ VA.T)  # (R, m)
    own = (rows[:, None] == idx_safe[None, :]) & valid[None, :]
    F_rows = (F_rows + torch.where(own, dr[:, None], 0.0)) * vf[None, :]
    ZT_rows = la.cho_solve(LA, F_rows.T).T * vf[None, :]
    return F_rows, ZT_rows


def lowrank_corrections_at(
    lr: LowRankPrecision, idx: torch.Tensor, count, rows: torch.Tensor
):
    """`lowrank_corrections` at candidate `rows` only: (R, m) slices of F
    and ZT with the same per-row algebra, O(R·(M + m)·m) instead of
    O(N·M·m) (the episode step reads the corrections only at the path
    sets' rows)."""
    m = idx.shape[0]
    valid = _first_occurrence(idx, torch.arange(m, device=idx.device) < count)
    idx_safe = torch.where(valid, idx, 0)
    return _corrections_rows(
        lr.VT.index_select(0, idx_safe), lr.dinv.index_select(0, idx_safe),
        lr.VT.index_select(0, rows), lr.dinv.index_select(0, rows),
        rows, idx_safe, valid,
    )


def _pilot_delete_lowrank(lr, pilot_idx, pilot_count, F, G, pdiag):
    """Batch-remove the pilot block from the implicit precision (the
    greedy loop's state before round 0)."""
    m = pilot_idx.shape[0]
    U0, Z, valid = _lowrank_schur(lr, pilot_idx, pilot_count)
    F[:, :m] = U0
    G[:m] = Z
    pdiag = pdiag - torch.sum(U0 * Z.T, dim=1)
    return F, G, torch.where(_mask_of(pilot_idx, valid, F.shape[0]), 1.0, pdiag)


def greedy_select_lowrank(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    nv: torch.Tensor,
    pilot_idx: torch.Tensor,
    z: torch.Tensor,
    *,
    rounds: int,
    num_pilot: int,
    return_scores: bool = False,
    pilot_count=None,
    pilot_nv: Optional[torch.Tensor] = None,
) -> SelectionResult:
    """Greedy Krause MI over N candidates with an M-inducing-point
    complement precision: `acquisition.greedy_select(strategy="mi")` past
    the exact N² seed.  z (M, dim): the inducing locations (a k-center
    design, a sub-grid, or z = x, which reproduces the exact path).  A
    (K, M, dim) stack runs the z-ensemble: K seeds, and every round scores
    (d + nv) · mean_k pdiag_k, the mean of the K designs' MI scores.
    Arguments and conventions otherwise as `acquisition.greedy_select`."""
    if pilot_count is None:
        pilot_count = num_pilot
    pilot_idx = pilot_idx.to(device=x.device, dtype=torch.int64)
    if pilot_nv is None:
        pilot_nv = nv.index_select(0, pilot_idx)
    N = x.shape[0]
    x, nv = pad_candidates(x, nv, align=512)
    res = _greedy_select_lowrank(
        spec, params, x, nv, pilot_idx, pilot_count, pilot_nv, z,
        rounds=rounds, num_pilot=num_pilot, return_scores=return_scores,
        n_valid=N,
    )
    return res.truncate(N) if x.shape[0] != N else res


def _greedy_select_lowrank(
    spec, params, x, nv, pilot_idx, pilot_count, pilot_nv, z, *,
    rounds, num_pilot, return_scores, n_valid=None,
) -> SelectionResult:
    """The selection loop on (alignment-padded) candidates."""
    dev = x.device
    N = x.shape[0]
    if n_valid is None:
        n_valid = N
    T = num_pilot + rounds
    d = gram_diag(spec, params, x)
    B = torch.zeros((T, N), dtype=torch.float32, device=dev)
    taken = torch.arange(N, device=dev) >= n_valid
    sel = torch.zeros((rounds,), dtype=torch.int64, device=dev)
    if num_pilot:
        C, d, taken_pilot, _ = _batch_pilot_condition(
            spec, params, x, pilot_nv, pilot_idx, pilot_count, d,
            n_valid=n_valid,
        )
        taken = taken | taken_pilot
        B[:num_pilot] = C

    # one seed and one (F, G, pdiag) state per design; the numerator's
    # conditioning (B, d) does not depend on the design and stays single
    ens = z.dim() == 3
    states = []
    for zk in (z.unbind(0) if ens else [z]):
        lr = lowrank_precision_seed(spec, params, x, nv, zk, n_valid=n_valid)
        F = torch.zeros((N, T), dtype=torch.float32, device=dev)
        G = torch.zeros((T, N), dtype=torch.float32, device=dev)
        pdiag = lr.pdiag
        if num_pilot:
            F, G, pdiag = _pilot_delete_lowrank(lr, pilot_idx, pilot_count,
                                                F, G, pdiag)
        states.append([lr, F, G, pdiag])

    scores = torch.full(
        (rounds if return_scores else 0, N), -torch.inf, device=dev
    )
    for r in range(rounds):
        pdiag = (torch.mean(torch.stack([st[3] for st in states]), dim=0)
                 if ens else states[0][3])
        s = torch.where(taken, -torch.inf, (d + nv) * pdiag)
        j1 = torch.argmax(s).reshape(1)  # device index, never read here
        if return_scores:
            scores[r] = s
        t = num_pilot + r
        col = _posterior_col(spec, params, x, j1, B)
        B, d = _condition(B, d, col, j1, nv.index_select(0, j1), t)
        for st in states:
            lr, F, G, pdiag = st
            u = _precision_col(lr, j1) - F @ G.index_select(1, j1)[:, 0]
            pjj = pdiag.index_select(0, j1)
            F[:, t] = u
            G[t] = u / pjj
            pdiag = pdiag - (u * u) / pjj
            pdiag.index_fill_(0, j1, 1.0)
            st[3] = pdiag
        taken.index_fill_(0, j1, True)
        sel[r] = j1[0]
    return SelectionResult(selected=sel, post_var=d, scores=scores, basis=B)


@dataclasses.dataclass
class LowRankFactors:
    """The low-rank precision reduced to its small factors, O(M²) state:
    Lzz (M, M) chol of K_zz + jitter, LB (M, M) chol of B = I + A Uᵀ, and
    the inducing locations z (M, d).  `v_rows_at` rebuilds any rows of
    VT / dinv from them with the full seed's per-row arithmetic."""

    Lzz: torch.Tensor
    LB: torch.Tensor
    z: torch.Tensor


def _candidate_nv(params, n, device, min_noise, nv_mult):
    """nv_mult · max(exp(2·log_noise), min_noise²) for n candidates, on the
    device (no host read)."""
    base = torch.clamp_min(torch.exp(2.0 * params.log_noise), min_noise * min_noise)
    return torch.full((n,), nv_mult, dtype=torch.float32, device=device) * base


def lowrank_factors_seed(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    z: torch.Tensor,
    *,
    min_noise: float = 1e-3,
    nv_mult: float = 1.0,
) -> LowRankFactors:
    """The small-factor seed: one O(N·M²) pass assembling B = I + A Uᵀ,
    nothing N-sized kept; the candidate noise derived from the params on
    the device.  Past `_SEED_CHUNK_BYTES` of (M, N) buffer the pass
    streams the candidate axis in `_SEED_CHUNK` columns (one Gram launch
    each), as the reference does; below it the one chunk is the whole."""
    M, N = z.shape[0], x.shape[0]
    dev = x.device
    Lzz = _zz_factor(spec, params, z)
    # B = I + Σ_chunks A_c U_cᵀ.  The tail chunk is padded with x[0] rows
    # whose A-columns are masked to zero, so every chunk has one shape and
    # the padding adds nothing.  The solve family follows the global
    # count; past the gate the explicit inverse is built once.
    c = N if 4 * M * N <= _SEED_CHUNK_BYTES else min(_SEED_CHUNK, N)
    n_pad = (N + c - 1) // c * c
    x_pad = torch.cat([x, x[:1].expand(n_pad - N, x.shape[1])])
    valid = (torch.arange(n_pad, device=dev) < N).to(torch.float32)
    nv_c = _candidate_nv(params, c, dev, min_noise, nv_mult)
    Lzz_inv = la.tri_inv(Lzz) if N >= _acq.COND_MATMUL_N else None
    Bacc = torch.zeros((M, M), dtype=torch.float32, device=dev)
    for i in range(n_pad // c):
        xc = x_pad[i * c:(i + 1) * c]
        Kzc = gram_kernel(spec, params, z, xc)
        Uc = Lzz_inv @ Kzc if Lzz_inv is not None else la.solve_triangular(Lzz, Kzc)
        qc = torch.sum(Uc * Uc, dim=0)
        dc = torch.clamp_min(gram_diag(spec, params, xc) - qc, 0.0) + nv_c
        Ac = Uc * (valid[i * c:(i + 1) * c] / dc)[None, :]
        Bacc = Bacc + Ac @ Uc.T
    return LowRankFactors(Lzz=Lzz, LB=la.cholesky(_eye(M, dev) + Bacc), z=z)


def v_rows_at(
    spec: KernelSpec,
    params: KernelParams,
    fac: LowRankFactors,
    x_rows: torch.Tensor,
    nv_rows: torch.Tensor,
    n_global: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(VT_rows (R, M), dinv_rows (R,)) of the low-rank precision at the
    given locations, with the full seed's per-row arithmetic (the plain
    Gram, as the reference).  `n_global`: the episode's full candidate
    count, for the solve gate."""
    Ur = _seed_solve(fac.Lzz, gram(spec, params, fac.z, x_rows), n_global)
    qr = torch.sum(Ur * Ur, dim=0)
    dinv_r = 1.0 / (torch.clamp_min(gram_diag(spec, params, x_rows) - qr, 0.0)
                    + nv_rows)
    Vr = _seed_solve(fac.LB, Ur * dinv_r[None, :], n_global)  # (M, R)
    return Vr.T, dinv_r


def lowrank_seed_with_z(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    z: torch.Tensor,
    *,
    min_noise: float = 1e-3,
    nv_mult: float = 1.0,
) -> LowRankPrecision:
    """`lowrank_precision_seed` with the candidate noise derived from the
    params on the device and the inducing design passed in."""
    nv = _candidate_nv(params, x.shape[0], x.device, min_noise, nv_mult)
    return lowrank_precision_seed(spec, params, x, nv, z)


def _condition_and_mean(spec, params, x, idx_pad, count, noise_scale_pad,
                        y_pad, min_noise):
    """The step's conditioning pass: (C, d, taken, mean, valid)."""
    cap = idx_pad.shape[0]
    base = torch.clamp_min(torch.exp(2.0 * params.log_noise), min_noise * min_noise)
    valid = torch.arange(cap, device=x.device) < count
    pnv = torch.where(valid, base * noise_scale_pad, 1.0)
    C, d, taken, LA = _batch_pilot_condition(
        spec, params, x, pnv, idx_pad, count, gram_diag(spec, params, x)
    )
    mean = C.T @ la.solve_triangular(LA, torch.where(valid, y_pad, 0.0))
    return C, d, taken, mean, valid


def plan_episode_step_lowrank(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    idx_pad: torch.Tensor,
    count,
    noise_scale_pad: torch.Tensor,
    y_pad: torch.Tensor,
    sets: torch.Tensor,
    set_sizes: torch.Tensor,
    costs: torch.Tensor,
    lr: LowRankPrecision,
    *,
    min_noise: float = 1e-3,
    nv_mult: float = 1.0,
    path_utility: str = "per_cost",
):
    """`acquisition.plan_episode_step(strategy="mi")` with the full
    low-rank seed: conditioning and posterior metrics, corrections at the
    sets' rows, set scores, argmax.  Returns (best, mean, post_var,
    scores), all on the device."""
    C, d, taken, mean, _ = _condition_and_mean(
        spec, params, x, idx_pad, count, noise_scale_pad, y_pad, min_noise)
    nv = _candidate_nv(params, x.shape[0], x.device, min_noise, nv_mult)
    F_rows, ZT_rows = lowrank_corrections_at(lr, idx_pad, count, sets.reshape(-1))
    scores = _acq.score_candidate_sets(
        spec, params, x, nv, C, sets, set_sizes,
        P_lowrank=(lr.VT, lr.dinv, F_rows, ZT_rows, taken), strategy="mi",
        corrections_pregathered=True,
    )
    best = _acq.path_set_argmax(scores, set_sizes, costs, path_utility=path_utility)
    return best, mean, torch.clamp_min(d, 0.0), scores


def plan_episode_step_lowrank_factors(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    idx_pad: torch.Tensor,
    count,
    noise_scale_pad: torch.Tensor,
    y_pad: torch.Tensor,
    sets: torch.Tensor,
    set_sizes: torch.Tensor,
    costs: torch.Tensor,
    fac,
    *,
    min_noise: float = 1e-3,
    nv_mult: float = 1.0,
    path_utility: str = "per_cost",
):
    """`plan_episode_step_lowrank` driven by the small-factor seed: the
    VT / dinv rows the step reads (the sampled set's and the path sets')
    come from `v_rows_at`.  `fac`: one design's `LowRankFactors`, or a
    list of K for the z-ensemble, whose MI scores are computed per design
    and averaged before the argmax; the conditioning and the posterior
    metrics are computed once.  Returns (best, mean, post_var, scores)."""
    cap = idx_pad.shape[0]
    dev = x.device
    C, d, taken, mean, valid = _condition_and_mean(
        spec, params, x, idx_pad, count, noise_scale_pad, y_pad, min_noise)
    base = torch.clamp_min(torch.exp(2.0 * params.log_noise), min_noise * min_noise)
    nv_fut = base * nv_mult  # future-measurement noise variance
    vdel = _first_occurrence(idx_pad, valid)
    idx_safe = torch.where(vdel, idx_pad, 0)
    S, k = sets.shape
    rows = sets.reshape(-1)
    N = x.shape[0]
    x_del, x_rows = x.index_select(0, idx_safe), x.index_select(0, rows)
    nv_del = torch.ones((cap,), device=dev) * nv_fut
    nv_rows = torch.ones(rows.shape, device=dev) * nv_fut
    tk = taken.index_select(0, rows).reshape(S, k)
    Bs = C.index_select(1, rows).reshape(cap, S, k).permute(1, 0, 2)
    nvs = torch.ones((S, k), device=dev) * nv_fut

    def mi_scores(fac_k: LowRankFactors) -> torch.Tensor:
        """The path sets' MI scores under one design's precision."""
        VA, dA = v_rows_at(spec, params, fac_k, x_del, nv_del, N)
        Vr, dr = v_rows_at(spec, params, fac_k, x_rows, nv_rows, N)
        F_rows, ZT_rows = _corrections_rows(VA, dA, Vr, dr, rows, idx_safe, vdel)
        P0 = _acq._pblk_lowrank_prior(sets, Vr.reshape(S, k, -1), dr.reshape(S, k))
        Pblk = _acq._pblk_finish(
            P0, F_rows.reshape(S, k, -1), ZT_rows.reshape(S, k, -1), tk)
        return _acq._score_sets_gathered(
            spec, params, x_rows.reshape(S, k, -1), Bs, nvs, set_sizes, Pblk,
            strategy="mi", sets=sets,
        )

    if isinstance(fac, LowRankFactors):
        scores = mi_scores(fac)
    else:
        scores = torch.mean(torch.stack([mi_scores(f) for f in fac]), dim=0)
    best = _acq.path_set_argmax(scores, set_sizes, costs, path_utility=path_utility)
    return best, mean, torch.clamp_min(d, 0.0), scores


def plan_episode_step_lowrank_metrics(
    spec, params, x, idx_pad, count, noise_scale_pad, y_pad, sets, set_sizes,
    costs, lr, f_true, obs_mask, test_mask, *, min_noise=1e-3, nv_mult=1.0,
    path_utility="per_cost",
):
    """`plan_episode_step_lowrank` with the metrics reduced on the device:
    returns (best, rmse, rmse_test, mean_var, var_sites)."""
    best, mean, d, _ = plan_episode_step_lowrank(
        spec, params, x, idx_pad, count, noise_scale_pad, y_pad, sets,
        set_sizes, costs, lr, min_noise=min_noise, nv_mult=nv_mult,
        path_utility=path_utility,
    )
    return _acq.device_metrics(best, mean, d, sets, f_true, obs_mask, test_mask)


def plan_episode_step_lowrank_factors_metrics(
    spec, params, x, idx_pad, count, noise_scale_pad, y_pad, sets, set_sizes,
    costs, fac, f_true, obs_mask, test_mask, *, min_noise=1e-3, nv_mult=1.0,
    path_utility="per_cost",
):
    """`plan_episode_step_lowrank_factors` with the metrics reduced on the
    device: returns (best, rmse, rmse_test, mean_var, var_sites)."""
    best, mean, d, _ = plan_episode_step_lowrank_factors(
        spec, params, x, idx_pad, count, noise_scale_pad, y_pad, sets,
        set_sizes, costs, fac, min_noise=min_noise, nv_mult=nv_mult,
        path_utility=path_utility,
    )
    return _acq.device_metrics(best, mean, d, sets, f_true, obs_mask, test_mask)


def fit_and_select_lowrank(
    spec: KernelSpec,
    fitcfg: FitConfig,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    x: torch.Tensor,
    pilot_idx: torch.Tensor,
    *,
    rounds: int,
    num_pilot: int,
    num_inducing: int,
    generator: Optional[torch.Generator] = None,
    inits: Optional[KernelParams] = None,
):
    """The north-star workload at low-rank scale: multi-restart MLL fit,
    a k-center design of min(num_inducing, N) points over the candidates,
    then greedy low-rank MI.  `inits` (restart axis leading) replaces the
    inits drawn from `generator`.  Nothing waits for the device until the
    caller reads a result.  Returns (fit_result, SelectionResult)."""
    N = x.shape[0]
    dev = x.device
    x_pad, _ = pad_candidates(x, torch.ones((N,), device=dev))
    if inits is None:
        inits = gp_mod.make_restart_inits(spec, fitcfg, generator, device=dev)
    fit_res = gp_mod._fit_batched(spec, fitcfg, x_train, y_train, None, inits)
    nv_base = torch.clamp_min(
        torch.exp(2.0 * fit_res.params.log_noise), fitcfg.min_noise**2
    )
    nv = torch.where(
        torch.arange(x_pad.shape[0], device=dev) < N, nv_base, 1.0
    ).to(torch.float32)
    z = x_pad.index_select(0, kcenter_indices(x_pad, min(num_inducing, N), N))
    pilot_idx = pilot_idx.to(device=dev, dtype=torch.int64)
    sel = _greedy_select_lowrank(
        spec, fit_res.params, x_pad, nv, pilot_idx, num_pilot,
        nv_base.expand(num_pilot).clone(), z,
        rounds=rounds, num_pilot=num_pilot, return_scores=False, n_valid=N,
    )
    return fit_res, sel.truncate(N) if x_pad.shape[0] != N else sel
