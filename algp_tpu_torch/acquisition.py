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

The config-5 episode's planning step (`plan_episode_step`) scores a
padded batch of path sample sets by their joint information: one
conditioning pass over every candidate gives the posterior metrics and
the per-set covariance blocks, and for MI the per-set precision blocks
come from row gathers of the per-refit seed W = L⁻¹ (`WT` materialised
row-major once per refit) less Schur corrections rebuilt from W for the
current sampled set.  Per-set factorizations go through `la.cholesky`,
so a failed one is NaN, as in the reference.  Nothing in a step reads a
value on the host; the episode reads the step's outputs in one copy.

The low-rank (FITC) planner for larger grids is `acquisition_lowrank`;
its per-set blocks go through `score_candidate_sets(P_lowrank=...)`.

`plan_path_step` (a plan step from given noise vectors, without the
posterior mean) and `complement_precision` (the dense (K + diag nv)⁻¹)
are the reference's small-N counterparts, which the tests hold the
implicit and fused paths against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from algp_tpu_torch.config import PATH_UTILITIES, FitConfig
from algp_tpu_torch.models import gp as gp_mod
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.gram import gram_kernel, gram_kernel_with_noise
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec, gram, gram_diag
from algp_tpu_torch.ops.updates import wtw_column
from algp_tpu_torch.utils.profiling import annotate


#: candidate count from which the (cap | M, N) solves of the conditioning
#: pass and the low-rank seeds go through an explicit inverse, as in the
#: reference
COND_MATMUL_N = 1 << 20


def cond_solve(L: torch.Tensor, B: torch.Tensor, n_global: int) -> torch.Tensor:
    """L⁻¹ B for the conditioning pass and the low-rank seeds, gated on the
    unpadded global candidate count as in the reference: the explicit
    inverse's product (`la.solve_triangular_matmul`) from COND_MATMUL_N
    on, the triangular solve below.  `n_global` is the whole field's
    count even where B is a chunk or a few rows, so every consumer of one
    episode stays in one arithmetic family.  The gate is read from the
    module at each call (tests patch it)."""
    if n_global >= COND_MATMUL_N:
        return la.solve_triangular_matmul(L, B)
    return la.solve_triangular(L, B)


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
            n_valid=n_valid,
        )
        taken = taken | taken_pilot
        B[:num_pilot] = C

    if strategy == "mi":
        # implicit complement precision P_t = WᵀW − F·G (never N×N dense)
        K = gram_kernel_with_noise(spec, params, x, nv / params.noise_var)
        W = la.tri_inv(_seed_factor(K))
        del K
        pdiag = torch.sum(W * W, dim=0)  # diag(WᵀW) = column sums of W²
        F = torch.zeros((N, T), dtype=torch.float32, device=dev)
        G = torch.zeros((T, N), dtype=torch.float32, device=dev)
        if num_pilot:
            F, G, pdiag = _implicit_pilot_delete(
                W, pilot_idx, pilot_count, F, G, pdiag, num_pilot
            )
        u0 = torch.empty((N,), dtype=W.dtype, device=dev)  # every round's (WᵀW)[:, j]

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
            u = wtw_column(W, j1, out=u0) - F @ G.index_select(1, j1)[:, 0]
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
    """(N,) bool: True at the valid entries of idx that lie in [0, N)."""
    mask = torch.zeros((N + 1,), dtype=torch.bool, device=idx.device)
    inside = valid & (idx >= 0) & (idx < N)
    mask.index_fill_(0, torch.where(inside, idx, N), True)
    return mask[:N]


def _batch_pilot_condition(spec, params, x, pilot_nv, pilot_idx, pilot_count,
                           d0, n_valid=None, cols=None, col0=0):
    """Condition the candidate field on all pilots in one batched op.

    Returns (C, d, taken, LA): C (m, N) the basis rows (row t is the
    normalised posterior-covariance row of pilot t given pilots < t), d
    the updated posterior variances, taken the pilot mask, LA the
    identity-padded Cholesky factor of K_AA + Σ_A.  Padded pilot slots
    (≥ pilot_count) contribute exactly zero.  `n_valid`: the unpadded
    candidate count for `cond_solve`'s gate (default: x's length).
    `cols`: the candidates x[col0 : col0 + len(cols)] to condition, a
    mesh rank's strip (default: all of x); d0, C and taken are theirs.

    The (m, N) cross-Gram goes through the Gram kernel (the reference's
    plain `gram` here; the kernel's entries are the same bits for RBF and
    Matérn 3/2) and so never materialises (m, N, d) differences; the small
    m × m block stays plain.
    """
    dev = x.device
    m = pilot_idx.shape[0]
    N = x.shape[0]
    cols = x if cols is None else cols
    valid = torch.arange(m, device=dev) < pilot_count
    idx_safe = torch.where(valid, pilot_idx, 0)
    xA = x.index_select(0, idx_safe)
    KA = gram(spec, params, xA, xA) + torch.diag(pilot_nv)
    pair = valid[:, None] & valid[None, :]
    KA = torch.where(pair, KA, torch.eye(m, dtype=torch.float32, device=dev))
    LA = la.cholesky(KA)
    Kc = gram_kernel(spec, params, xA, cols) * valid[:, None].to(torch.float32)
    C = cond_solve(LA, Kc, N if n_valid is None else n_valid)
    d = d0 - torch.sum(C * C, dim=0)
    return C, d, _mask_of(pilot_idx - col0, valid, cols.shape[0]), LA


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


# ---------------------------------------------------------------------------
# Path-constrained set scoring (config 5)
# ---------------------------------------------------------------------------


def score_candidate_sets(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    nv: torch.Tensor,
    basis: torch.Tensor,
    sets: torch.Tensor,
    set_sizes: torch.Tensor,
    P_implicit: Optional[tuple] = None,
    P_lowrank: Optional[tuple] = None,
    *,
    strategy: str = "entropy",
    corrections_pregathered: bool = False,
) -> torch.Tensor:
    """Joint utility of padded candidate sets (path sample sets), batched.

    sets      : (S, k_max) int64 candidate indices, padded with 0
    set_sizes : (S,) true sizes; padded slots are masked to identity
    basis     : (T, N) conditioning state (`_batch_pilot_condition`)
    P_implicit: (WT, F, ZT, taken) — the implicit complement precision
                P = WᵀW − F·ZTᵀ (`implicit_precision_seed` +
                `implicit_corrections`); per-set blocks come from row
                gathers of the row-major WT, F and ZT.  `taken` marks
                sampled candidates, whose implicit rows are exactly zero:
                they get the inert marker (zero row/col, diag 1)
    P_lowrank : (VT, dinv, F, ZT, taken) — as P_implicit, with the prior
                precision P̃0 = diag(dinv) − VT·VTᵀ of the low-rank seed
                (acquisition_lowrank); per-set blocks are row gathers of VT
    corrections_pregathered : F / ZT arrive already gathered at the
                flattened set rows, (S·k_max, C)
                (`acquisition_lowrank.lowrank_corrections_at`); an explicit
                flag, never inferred from the shapes

    entropy:  information gain ½[log det(Cov_S|A + Σ_S) − log det Σ_S]
    mi:       ½[log det(Cov_S|A + Σ_S) + log det P_SS]
    Returns (S,) scores.
    """
    if strategy == "mi" and P_implicit is None and P_lowrank is None:
        raise ValueError(
            "score_candidate_sets(strategy='mi') needs the complement "
            "precision — implicit_precision_seed + implicit_corrections, "
            "or the low-rank seed + lowrank_corrections"
        )
    S, k = sets.shape
    idx_flat = sets.reshape(-1)

    def rows(a):  # (S, k, ...) row gathers
        return a.index_select(0, idx_flat).reshape(S, k, *a.shape[1:])

    if strategy == "mi":
        if P_implicit is not None:
            WT, F, ZT, taken = P_implicit
            Wr = rows(WT)  # (S, k, N)
            P0 = Wr @ Wr.mT
        else:
            VT, dinv, F, ZT, taken = P_lowrank
            P0 = _pblk_lowrank_prior(sets, rows(VT), rows(dinv))
        if corrections_pregathered:
            Fr, Zr = F.reshape(S, k, -1), ZT.reshape(S, k, -1)
        else:
            Fr, Zr = rows(F), rows(ZT)
        Pblk = _pblk_finish(P0, Fr, Zr, rows(taken))
    else:
        Pblk = None
    Bs = basis.index_select(1, idx_flat).reshape(basis.shape[0], S, k)
    return _score_sets_gathered(
        spec, params, rows(x), Bs.permute(1, 0, 2), rows(nv), set_sizes, Pblk,
        strategy=strategy, sets=sets,
    )


def _pblk_lowrank_prior(sets, Vr, dr):
    """Per-set prior precision blocks from gathered low-rank rows:
    P̃0_SS = −Vr·Vrᵀ, plus the D⁻¹ term wherever two slots hold the same
    candidate (a path revisiting a node), as P̃'s own diagonal places it."""
    same = (sets[:, :, None] == sets[:, None, :]).to(torch.float32)
    return -(Vr @ Vr.mT) + same * dr[:, :, None]


def _pblk_finish(P0, Fr, Zr, tk):
    """Apply the gathered Schur corrections and the inert marker for
    already-deleted entries to per-set prior precision blocks: P0
    (S, k, k), Fr/Zr (S, k, C), tk (S, k) bool."""
    k_max = tk.shape[1]
    Pblk = P0 - Fr @ Zr.mT
    off = tk[:, :, None] | tk[:, None, :]
    Pblk = torch.where(off, 0.0, Pblk)
    eye = torch.eye(k_max, dtype=torch.bool, device=tk.device)[None]
    return torch.where(eye & tk[:, :, None], 1.0, Pblk)


def _score_sets_gathered(
    spec, params, xs, Bs, nvs, set_sizes, Pblk, *, strategy, sets=None
):
    """Joint set utilities from gathered per-set blocks: xs (S, k, dim),
    Bs (S, T, k) basis columns, nvs (S, k) noise, Pblk (S, k, k) or None.

    With `sets`, a slot that repeats an earlier slot's candidate (a path
    re-entering a cell) is masked like padding: without the mask its two
    identical precision rows make the block singular, its Cholesky NaN,
    and NaN would win the argmax."""
    S, k_max = xs.shape[:2]
    dev = xs.device
    if sets is not None:
        same = sets[:, :, None] == sets[:, None, :]
        first = ~torch.tril(same, diagonal=-1).any(dim=2)
    else:
        first = torch.ones((S, k_max), dtype=torch.bool, device=dev)
    mask = (torch.arange(k_max, device=dev)[None, :] < set_sizes[:, None]) & first
    pair = mask[:, :, None] & mask[:, None, :]
    Kp = gram(spec, params, xs, xs)  # (S, k, k) prior blocks
    M1 = Kp - Bs.mT @ Bs + torch.diag_embed(nvs)
    M1 = torch.where(pair, M1, 0.0)
    M1 = M1 + torch.diag_embed(torch.where(mask, 1e-6, 1.0))
    L1 = la.cholesky(M1)
    h = torch.sum(torch.log(torch.diagonal(L1, dim1=-2, dim2=-1)), -1)
    if strategy == "entropy":
        # subtract the noise-entropy floor ⇒ information gain ≥ 0
        return h - 0.5 * torch.sum(torch.where(mask, torch.log(nvs), 0.0), -1)
    Pss = torch.where(pair, Pblk, 0.0)
    Pss = Pss + torch.diag_embed(torch.where(mask, 0.0, 1.0))
    L2 = la.cholesky(Pss)
    return h + torch.sum(torch.log(torch.diagonal(L2, dim1=-2, dim2=-1)), -1)


#: "per_sample" price gate: paths whose cost per sample exceeds the best
#: by more than this factor are ineligible
_PRICE_TOL = 1.25


def path_set_argmax(
    scores: torch.Tensor,
    set_sizes: torch.Tensor,
    costs: torch.Tensor,
    *,
    path_utility: str = "per_cost",
    price_tol: float = _PRICE_TOL,
) -> torch.Tensor:
    """The winning path set (a device index) from its scores.

    "per_cost": information per unit cost, clamped ≥ 0; "per_sample":
    among the paths within `price_tol` of the best cost per sample, the
    most information per sample.  Zero-size (padding) paths never win;
    the lowest index wins ties."""
    if path_utility not in PATH_UTILITIES:
        raise ValueError(
            f"unknown path_utility {path_utility!r}; use {PATH_UTILITIES}"
        )
    pos = torch.clamp_min(scores, 0.0)
    valid = set_sizes > 0
    if path_utility == "per_cost":
        util = pos / (costs + 1e-6)
        return torch.argmax(torch.where(valid, util, -torch.inf))
    k = torch.clamp_min(set_sizes.to(torch.float32), 1.0)
    price = costs / k
    p_min = torch.min(torch.where(valid, price, torch.inf))
    eligible = valid & (price <= price_tol * p_min)
    return torch.argmax(torch.where(eligible, pos / k, -torch.inf))


def plan_path_step(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    nv: torch.Tensor,
    idx_pad: torch.Tensor,
    count,
    pilot_nv: torch.Tensor,
    sets: torch.Tensor,
    set_sizes: torch.Tensor,
    costs: torch.Tensor,
    W: Optional[torch.Tensor] = None,
    WT: Optional[torch.Tensor] = None,
    *,
    strategy: str = "entropy",
    path_utility: str = "per_cost",
):
    """A plan step from explicit noise vectors: conditioning on the sampled
    set → (mi) the Schur corrections from W → joint set scores →
    `path_set_argmax`.  idx_pad / pilot_nv: the sampled set padded to a
    fixed capacity and its per-observation noise, of which the first
    `count` slots are real; nv: every candidate's future-measurement
    noise; W / WT: the seed (mi only).  Returns (best, post_var, scores),
    all on the device."""
    if strategy == "mi" and (W is None or WT is None):
        raise ValueError(
            "plan_path_step(strategy='mi') needs the implicit-precision "
            "seed — build (W, WT) with implicit_complement_precision"
        )
    best, _, d, _, scores = _plan_step(
        spec, params, x, nv, idx_pad, count, pilot_nv, sets, set_sizes, costs,
        W, WT, strategy, path_utility)
    return best, d, scores


def _plan_step(spec, params, x, nv, idx_pad, count, pilot_nv, sets, set_sizes,
               costs, W, WT, strategy, path_utility):
    """The plan step shared by `plan_path_step` and `plan_episode_step`:
    conditioning, (mi) the Schur corrections, set scores, the argmax.
    Returns (best, C, d, LA, scores)."""
    d0 = gram_diag(spec, params, x)
    C, d, taken, LA = _batch_pilot_condition(
        spec, params, x, pilot_nv, idx_pad, count, d0
    )
    if strategy == "mi":
        F, ZT = implicit_corrections(W, WT, idx_pad, count)
        scores = score_candidate_sets(
            spec, params, x, nv, C, sets, set_sizes,
            P_implicit=(WT, F, ZT, taken), strategy="mi",
        )
    else:
        scores = score_candidate_sets(
            spec, params, x, nv, C, sets, set_sizes, strategy="entropy",
        )
    best = path_set_argmax(scores, set_sizes, costs, path_utility=path_utility)
    return best, C, d, LA, scores


def plan_episode_step(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    idx_pad: torch.Tensor,
    count: int,
    noise_scale_pad: torch.Tensor,
    y_pad: torch.Tensor,
    sets: torch.Tensor,
    set_sizes: torch.Tensor,
    costs: torch.Tensor,
    W: Optional[torch.Tensor] = None,
    WT: Optional[torch.Tensor] = None,
    *,
    strategy: str = "entropy",
    min_noise: float = 1e-3,
    nv_mult: float = 1.0,
    path_utility: str = "per_cost",
):
    """One episode step's device work: the posterior mean and variance of
    the current state over the whole grid, and the next path's choice.

    With LA = chol(K_AA + Σ_A) and basis rows C = L_A⁻¹ K(X_A, X):
    σ²* = diag K − colsum(C²) and μ* = Cᵀ(L_A⁻¹ y_A), byproducts of the
    conditioning the plan needs anyway.  Then (mi) the Schur corrections
    from W for the sampled set, the set scores and `path_set_argmax`.

    Noise: observations carry base · noise_scale_pad with
    base = max(exp(2·log_noise), min_noise²); future measurements are
    scored at base · nv_mult.  idx_pad / noise_scale_pad / y_pad: the
    sampled set padded to a fixed capacity, of which the first `count`
    slots are real.  W / WT: the per-refit seed (mi only).

    Returns (best, mean, post_var, scores), all on the device.
    """
    if strategy == "mi" and (W is None or WT is None):
        raise ValueError(
            "plan_episode_step(strategy='mi') needs the implicit-precision "
            "seed — build (W, WT) with implicit_precision_seed"
        )
    dev = x.device
    cap = idx_pad.shape[0]
    base = torch.clamp_min(torch.exp(2.0 * params.log_noise), min_noise * min_noise)
    valid = torch.arange(cap, device=dev) < count
    pnv = torch.where(valid, base * noise_scale_pad, 1.0)
    nv = torch.full((x.shape[0],), nv_mult, dtype=torch.float32, device=dev) * base
    best, C, d, LA, scores = _plan_step(
        spec, params, x, nv, idx_pad, count, pnv, sets, set_sizes, costs, W, WT,
        strategy, path_utility)
    u = la.solve_triangular(LA, torch.where(valid, y_pad, 0.0))
    mean = C.T @ u
    return best, mean, torch.clamp_min(d, 0.0), scores


def plan_episode_step_metrics(
    spec, params, x, idx_pad, count, noise_scale_pad, y_pad, sets, set_sizes,
    costs, f_true, obs_mask, test_mask, W=None, WT=None, *,
    strategy="entropy", min_noise=1e-3, nv_mult=1.0, path_utility="per_cost",
):
    """`plan_episode_step` with the metrics reduced on the device against
    the truth (f32 masks): returns (best, rmse, rmse_test, mean_var,
    var_sites), var_sites the posterior variances at sets[best]."""
    best, mean, d, _ = plan_episode_step(
        spec, params, x, idx_pad, count, noise_scale_pad, y_pad, sets,
        set_sizes, costs, W, WT, strategy=strategy, min_noise=min_noise,
        nv_mult=nv_mult, path_utility=path_utility,
    )
    return device_metrics(best, mean, d, sets, f_true, obs_mask, test_mask)


def device_metrics(best, mean, d, sets, f_true, obs_mask, test_mask):
    """A step's outputs reduced on the device against the truth:
    (best, rmse, rmse_test, mean_var, var_sites)."""
    err = mean - f_true
    rmse = torch.sqrt(torch.sum(obs_mask * err * err)
                      / torch.clamp_min(torch.sum(obs_mask), 1.0))
    rmse_test = torch.sqrt(torch.sum(test_mask * err * err)
                           / torch.clamp_min(torch.sum(test_mask), 1.0))
    var_sites = d.index_select(0, sets.index_select(0, best.reshape(1))[0])
    return best, rmse, rmse_test, torch.mean(d), var_sites


# ---------------------------------------------------------------------------
# The implicit precision of episode-level MI
# ---------------------------------------------------------------------------


#: The MI seed's factor L of K + σ²I, both paths (all NaN if it failed).
#: The library factor: the hand-written kernel of `ops.chol` is faster on
#: the H100 but picks other candidates where the MI scores tie within f32
#: noise, so it is not wired in (PERF.md §6).
_seed_factor = la.cholesky


def _seed(K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    W = la.tri_inv(_seed_factor(K))
    # WT materialised row-major, once per refit: the per-set blocks are
    # row gathers of it (W.mT would make each a strided column gather)
    return W, W.mT.contiguous()


def complement_precision(
    spec: KernelSpec, params: KernelParams, x: torch.Tensor, nv: torch.Tensor
) -> torch.Tensor:
    """(K(X, X) + diag nv)⁻¹ over all candidates, dense (N × N): K from the
    Gram kernel, the inverse Wᵀ W from its factor (`la.spd_inverse_from_chol`).
    The small-N counterpart of `implicit_complement_precision`, which
    never materialises P."""
    K = gram_kernel_with_noise(spec, params, x, nv / params.noise_var)
    return la.spd_inverse_from_chol(la.cholesky(K))


def implicit_complement_precision(
    spec: KernelSpec, params: KernelParams, x: torch.Tensor, nv: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Seed the implicit prior precision P0 = (K + diag nv)⁻¹ = WᵀW over
    all candidates: (W, WT) with W = L⁻¹ and WT = Wᵀ row-major."""
    return _seed(gram_kernel_with_noise(spec, params, x, nv / params.noise_var))


def implicit_precision_seed(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    *,
    min_noise: float = 1e-3,
    nv_mult: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`implicit_complement_precision` with the candidate noise
    nv = nv_mult · max(exp(2·log_noise), min_noise²) derived on the
    device: the episode's per-refit seed, no host read.  Marked as the
    profiler region `exact.seed`."""
    with annotate("exact.seed"):
        return _seed(seed_matrix(spec, params, x, min_noise=min_noise,
                                 nv_mult=nv_mult))


def seed_matrix(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    *,
    min_noise: float = 1e-3,
    nv_mult: float = 1.0,
) -> torch.Tensor:
    """The matrix the episode's MI seed factors: K(X, X) + diag nv with
    nv = nv_mult · max(exp(2·log_noise), min_noise²), from the Gram
    kernel."""
    base = torch.clamp_min(torch.exp(2.0 * params.log_noise), min_noise * min_noise)
    nv = torch.full((x.shape[0],), nv_mult, dtype=torch.float32,
                    device=x.device) * base
    return gram_kernel_with_noise(spec, params, x, nv / params.noise_var)


def implicit_corrections(
    W: torch.Tensor, WT: torch.Tensor, idx: torch.Tensor, count: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Schur factors deleting the sampled set A from the implicit
    precision: P_V∖A = WᵀW − F·ZTᵀ with U = (WᵀW)[:, A] (N, C),
    PA = U[A], Z = PA⁻¹Uᵀ; returns (U, Zᵀ).  idx is padded to a fixed
    capacity C, of which the first `count` slots are real; a repeated
    index is deleted once."""
    dev = W.device
    m = idx.shape[0]
    valid = torch.arange(m, device=dev) < count
    same = (idx[:, None] == idx[None, :]) & valid[:, None] & valid[None, :]
    valid = valid & ~torch.tril(same, diagonal=-1).any(dim=1)
    validf = valid.to(torch.float32)
    idx_safe = torch.where(valid, idx, 0)
    WE = WT.index_select(0, idx_safe).T * validf[None, :]  # (N, C) = W[:, A]
    U = (W.T @ WE) * validf[None, :]  # (N, C) = (WᵀW)[:, A]
    PA = U.index_select(0, idx_safe) * validf[:, None]
    pair = valid[:, None] & valid[None, :]
    PA = torch.where(pair, PA, torch.eye(m, dtype=torch.float32, device=dev))
    Z = la.cho_solve(la.cholesky(PA), U.T) * validf[:, None]  # (C, N)
    return U, Z.T
