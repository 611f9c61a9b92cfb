"""Greedy Krause-MI selection with the candidate axis split over the mesh's
'grid' ranks (the counterpart of algp_tpu.parallel.sharded_mi).

Rank g owns the candidate block [g0, g0 + n_loc), g0 = g · n_loc, of the
alignment-padded field (a multiple of lcm(512, S), S the grid size; the
padding is inert).  The state lives in strips:

    W     (n_loc, N)  its rows of W = L⁻¹ (the seed's factor inverse)
    B     (T, n_loc)  the conditioning basis' columns
    F     (n_loc, T), G (T, n_loc)  the Schur corrections of the implicit
                      complement precision P = WᵀW − F·G
    d, pdiag, taken (n_loc,)
    x, nv (N, ·)      replicated (small)

and a round is local work plus a few small collectives:

    scores       local;  argmax: MAX of the score, MIN of the tying
                 ranks' indices (`sharded.global_argmax`)
    B[:, j], G[:, j], d[j], pdiag[j]: one masked-sum gather (`row_at`)
    the posterior column on the local rows: the plain `gram` on
                 (x_loc, x_j), as the single-card `_posterior_col`
    u₀ = (WᵀW)[:, j]: the strip kernel's (N,) partial
                 (`ops.updates.wtw_column_strip`), summed over the grid
    u = u₀[strip] − F·G[:, j], the rank-1 updates: local

The loop (`greedy_loop`) is written once for every precision: the exact
one of either seed here, the low-rank one of `sharded_lowrank`, and none
(greedy entropy, `sharded.sharded_greedy_select`).

The seed has two modes:
  * replicated (default): every rank builds the single-card seed (the
    Gram kernel with the noise, `acquisition._seed_factor`, `tri_inv`, the
    pilot conditioning and the implicit pilot delete), then keeps its row
    strip of W and frees the rest: the single-card arithmetic, while W
    fits one card;
  * distributed_seed=True: the Gram kernel's (n_loc, N) strip plus the
    noise on its diagonal, the blocked Cholesky and triangular inverse of
    `dist_linalg`, the pilot conditioning on the strip and the pilot
    delete with one (N, m) sum: O(N²/S) memory a rank.  Its block
    arithmetic matches the f64 oracle but not the replicated seed bit for
    bit at score ties.

Cross-rank sums reduce in rank order, not the single-card kernel's slice
order: a last-ulp difference that only matters at exact score ties.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from algp_tpu_torch import acquisition as acq
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.gram import gram_kernel, gram_kernel_with_noise
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec, gram, gram_diag
from algp_tpu_torch.ops.updates import wtw_column_strip
from algp_tpu_torch.parallel.dist_linalg import dist_cholesky, dist_tri_inv
from algp_tpu_torch.parallel.sharded import (
    Mesh,
    all_gather,
    global_argmax,
    mesh_align,
    psum,
    row_at,
)


@dataclasses.dataclass
class Strip:
    """The replicated candidates (alignment-padded) and this rank's block."""

    mesh: Mesh
    x: torch.Tensor  # (N, dim)
    nv: torch.Tensor  # (N,)
    g0: int
    n_loc: int
    n_valid: int  # the unpadded count

    @property
    def N(self) -> int:
        return self.x.shape[0]

    @property
    def rows(self) -> slice:
        return slice(self.g0, self.g0 + self.n_loc)

    @property
    def x_loc(self) -> torch.Tensor:
        return self.x[self.rows]

    @property
    def nv_loc(self) -> torch.Tensor:
        return self.nv[self.rows]

    @property
    def gidx(self) -> torch.Tensor:
        return torch.arange(self.g0, self.g0 + self.n_loc, device=self.x.device)


@dataclasses.dataclass
class Precision:
    """The implicit complement precision P = P0 − F·G on a strip: F
    (n_loc, T), G (T, n_loc), pdiag (n_loc,) = diag P, and the prior's
    column: `column(j1, *rows at j)` gives P0[strip, j] from the rows of
    `rows` ((n_loc, ...) tensors) at j.  `shapes`: the strips it holds."""

    F: torch.Tensor
    G: torch.Tensor
    pdiag: torch.Tensor
    column: Callable
    rows: tuple = ()
    shapes: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StripState:
    """The numerator's state on a strip, and the precision (None for
    greedy entropy)."""

    B: torch.Tensor  # (T, n_loc)
    d: torch.Tensor  # (n_loc,)
    taken: torch.Tensor  # (n_loc,) bool
    precision: Optional[Precision] = None


@dataclasses.dataclass
class ShardedSelection:
    """The outcome of a sharded greedy run on one rank.

    selected : (rounds,) int64, the same on every rank
    post_var : (n_loc,) this rank's posterior variances (padding included)
    n_valid  : the unpadded candidate count
    strips   : the shapes of the precision's strips this rank held
    """

    selected: torch.Tensor
    post_var: torch.Tensor
    n_valid: int
    strips: dict

    def gather_post_var(self, mesh: Mesh) -> torch.Tensor:
        """Every candidate's posterior variance, (n_valid,)."""
        return all_gather(self.post_var, mesh.grid_group)[:self.n_valid]


def candidate_strip(mesh: Mesh, x, nv, pilot_idx):
    """Pad the candidates to a multiple of lcm(512, S) and place this rank's
    block: (Strip, pilot indices as int64, the pilots' noise)."""
    pilot_idx = pilot_idx.to(device=x.device, dtype=torch.int64)
    pilot_nv = nv.index_select(0, pilot_idx)
    n_valid = x.shape[0]
    x, nv = acq.pad_candidates(x, nv, align=mesh_align(mesh))
    n_loc = x.shape[0] // mesh.grid
    return Strip(mesh, x, nv, mesh.g * n_loc, n_loc, n_valid), pilot_idx, pilot_nv


def strip_state(spec: KernelSpec, params: KernelParams, strip: Strip, pilot_idx,
                num_pilot: int, pilot_nv, T: int) -> StripState:
    """Prior variances on the strip, conditioned on the pilots in one batched
    op (their (m, n_loc) cross-Gram on the Gram kernel), the padding and
    the pilots taken."""
    dev = strip.x.device
    d = gram_diag(spec, params, strip.x_loc)
    taken = strip.gidx >= strip.n_valid
    B = torch.zeros((T, strip.n_loc), dtype=torch.float32, device=dev)
    if num_pilot:
        C, d, taken_pilot, _ = acq._batch_pilot_condition(
            spec, params, strip.x, pilot_nv, pilot_idx, num_pilot, d,
            n_valid=strip.n_valid, cols=strip.x_loc, col0=strip.g0)
        taken = taken | taken_pilot
        B[:num_pilot] = C
    return StripState(B=B, d=d, taken=taken)


def greedy_loop(spec: KernelSpec, params: KernelParams, strip: Strip, st: StripState,
                *, rounds: int, num_pilot: int) -> ShardedSelection:
    """The greedy rounds on a strip: entropy without a precision, Krause MI
    with one.  Every step stays on the device; the collectives are the
    argmax's two reductions, one gather at j and (exact MI) the
    precision column's sum."""
    mesh, g0, n_loc = strip.mesh, strip.g0, strip.n_loc
    x, nv, x_loc, nv_loc, gidx = strip.x, strip.nv, strip.x_loc, strip.nv_loc, strip.gidx
    B, d, taken, pr = st.B, st.d, st.taken, st.precision
    sel = torch.zeros((rounds,), dtype=torch.int64, device=x.device)
    for r in range(rounds):
        num = d + nv_loc
        s = torch.where(taken, -torch.inf, num if pr is None else num * pr.pdiag)
        j1 = global_argmax(mesh, s, g0, strip.N)
        t = num_pilot + r
        at = row_at(mesh, j1, g0, B.mT, d,
                    *(() if pr is None else (pr.G.mT, pr.pdiag, *pr.rows)))
        # posterior covariance column on the local rows (`_posterior_col`)
        col = gram(spec, params, x_loc, x.index_select(0, j1))[:, 0] - B.mT @ at[0]
        c = col / torch.sqrt(at[1] + nv.index_select(0, j1))
        B[t] = c
        d = d - c * c
        on_j = gidx == j1
        if pr is not None:
            # current precision column u = P0[:, j] − F·G[:, j]
            u = pr.column(j1, *at[4:]) - pr.F @ at[2]
            pjj = at[3]
            pr.F[:, t] = u
            pr.G[t] = u / pjj
            pr.pdiag = torch.where(on_j, 1.0, pr.pdiag - (u * u) / pjj)
        taken = taken | on_j
        sel[r] = j1[0]
    return ShardedSelection(selected=sel, post_var=d, n_valid=strip.n_valid,
                            strips={} if pr is None else pr.shapes)


def exact_precision(strip: Strip, W_loc: torch.Tensor, F, G, pdiag) -> Precision:
    """The exact precision from this rank's rows of W: P0[strip, j] =
    (the grid's sum of the strip kernel's partial columns)[strip].  The
    (N,) partial lives in one buffer for the whole loop: a round's kernel
    and sum overwrite it in place, and the round's update (`u = column −
    F·G[:, j]`, a new tensor) has read it before the next round's kernel,
    later on the same stream, writes it again."""
    u0 = torch.empty((W_loc.shape[1],), dtype=W_loc.dtype, device=W_loc.device)

    def column(j1):
        wtw_column_strip(W_loc, j1, strip.g0, out=u0)
        return psum(u0, strip.mesh.grid_group)[strip.rows]

    return Precision(F=F, G=G, pdiag=pdiag, column=column,
                     shapes={"W": tuple(W_loc.shape)})


def seed_replicated(spec, params, strip: Strip, pilot_idx, num_pilot: int,
                    pilot_nv, T: int) -> StripState:
    """The single-card seed on every rank (`acquisition._greedy_select`'s
    arithmetic), then this rank's strips of it; W's other rows are freed."""
    x, nv, N, dev = strip.x, strip.nv, strip.N, strip.x.device
    d = gram_diag(spec, params, x)
    taken = torch.arange(N, device=dev) >= strip.n_valid
    B = torch.zeros((T, N), dtype=torch.float32, device=dev)
    if num_pilot:
        C, d, taken_pilot, _ = acq._batch_pilot_condition(
            spec, params, x, pilot_nv, pilot_idx, num_pilot, d, n_valid=strip.n_valid)
        taken = taken | taken_pilot
        B[:num_pilot] = C
    K = gram_kernel_with_noise(spec, params, x, nv / params.noise_var)
    W = la.tri_inv(acq._seed_factor(K))
    del K
    pdiag = torch.sum(W * W, dim=0)
    F = torch.zeros((N, T), dtype=torch.float32, device=dev)
    G = torch.zeros((T, N), dtype=torch.float32, device=dev)
    if num_pilot:
        F, G, pdiag = acq._implicit_pilot_delete(W, pilot_idx, num_pilot, F, G, pdiag,
                                                 num_pilot)
    rows = strip.rows
    W_loc = W[rows].contiguous()
    del W
    return StripState(
        B=B[:, rows].contiguous(), d=d[rows].contiguous(), taken=taken[rows].contiguous(),
        precision=exact_precision(strip, W_loc, F[rows].contiguous(),
                                  G[:, rows].contiguous(), pdiag[rows].contiguous()))


def _first_valid(pilot_idx, num_pilot: int):
    """The pilot slots that take part in a delete: (valid, as f32, the
    index with invalid slots at 0) — every slot real, each index once."""
    m = pilot_idx.shape[0]
    valid = torch.ones((m,), dtype=torch.bool, device=pilot_idx.device)
    same = pilot_idx[:, None] == pilot_idx[None, :]
    valid = valid & ~torch.tril(same, diagonal=-1).any(dim=1)
    return valid, valid.to(torch.float32), torch.where(valid, pilot_idx, 0)


def distributed_w(spec, params, strip: Strip) -> torch.Tensor:
    """This rank's (n_loc, N) rows of W = L⁻¹, L the factor of
    K + diag(nv): the Gram kernel's strip with the noise on its diagonal,
    then `dist_linalg`'s Cholesky and inverse.  O(N²/S) a rank."""
    K_loc = gram_kernel(spec, params, strip.x_loc, strip.x)
    K_loc[:, strip.rows].diagonal().add_(strip.nv_loc)
    L_loc = dist_cholesky(strip.mesh, K_loc)
    del K_loc  # freed before the inverse's strips are allocated
    return dist_tri_inv(strip.mesh, L_loc)


def seed_distributed(spec, params, strip: Strip, pilot_idx, num_pilot: int,
                     pilot_nv, T: int) -> StripState:
    """The seed in strips: W's rows (`distributed_w`), the pilots
    conditioned on the strip, the pilot delete with one (N, m) sum."""
    mesh, rows, dev = strip.mesh, strip.rows, strip.x.device
    W_loc = distributed_w(spec, params, strip)
    pdiag = psum(torch.sum(W_loc * W_loc, dim=0), mesh.grid_group)[rows].clone()
    st = strip_state(spec, params, strip, pilot_idx, num_pilot, pilot_nv, T)
    F = torch.zeros((strip.n_loc, T), dtype=torch.float32, device=dev)
    G = torch.zeros((T, strip.n_loc), dtype=torch.float32, device=dev)
    if num_pilot:
        m = num_pilot
        valid, vf, idx = _first_valid(pilot_idx, m)
        WE_loc = W_loc.index_select(1, idx) * vf  # (n_loc, m): W's rows here at A
        U0 = psum(W_loc.mT @ WE_loc, mesh.grid_group) * vf  # (N, m) = P0[:, A]
        PA = U0.index_select(0, idx) * vf[:, None]
        pair = valid[:, None] & valid[None, :]
        PA = torch.where(pair, PA, torch.eye(m, dtype=torch.float32, device=dev))
        U0 = U0[rows]
        Z = la.cho_solve(la.cholesky(PA), U0.mT) * vf[:, None]  # (m, n_loc)
        F[:, :m] = U0
        G[:m] = Z
        pdiag = pdiag - torch.sum(U0 * Z.mT, dim=1)
        pdiag = torch.where(acq._mask_of(pilot_idx - strip.g0, valid, strip.n_loc),
                            1.0, pdiag)
    st.precision = exact_precision(strip, W_loc, F, G, pdiag)
    return st


def sharded_greedy_select_mi(
    mesh: Mesh,
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    nv: torch.Tensor,
    pilot_idx: torch.Tensor,
    *,
    rounds: int,
    num_pilot: int,
    distributed_seed: bool = False,
) -> ShardedSelection:
    """Greedy Krause MI with the candidate axis split over the grid ranks:
    `acquisition.greedy_select(strategy="mi")` index for index on
    tie-free fields.  Every rank passes the same x, nv and pilots.
    `distributed_seed`: build the seed in strips (`seed_distributed`)
    instead of on every rank whole (`seed_replicated`)."""
    strip, pilot_idx, pilot_nv = candidate_strip(mesh, x, nv, pilot_idx)
    seed = seed_distributed if distributed_seed else seed_replicated
    st = seed(spec, params, strip, pilot_idx, num_pilot, pilot_nv, num_pilot + rounds)
    return greedy_loop(spec, params, strip, st, rounds=rounds, num_pilot=num_pilot)
