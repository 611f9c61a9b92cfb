"""Config-5 episode planning with the candidate axis split over the mesh's
'grid' ranks (the counterpart of algp_tpu.parallel.sharded_episode).

The single-card step (`acquisition.plan_episode_step`,
`acquisition_lowrank.plan_episode_step_lowrank_factors`) holds every
O(N) buffer on one card.  Here rank g owns the candidate block
[g0, g0 + n_loc), g0 = g · n_loc, of the field padded by `mesh_pad`, and
every rank runs the same plain functions on its block:

  per refit, kept across the steps until the next one:
    W   (n_loc, N)  the exact seed's rows of W = L⁻¹ (`sharded_precision_seed`:
                    the Gram kernel's strip, `dist_linalg`'s factor and inverse)
    VT  (n_loc, M), dinv, pdiag (n_loc,)   the low-rank seed's rows
                    (`sharded_lowrank_seed`; a leading K axis for the
                    z-ensemble)
  per step:
    C   (cap, n_loc)  L_A⁻¹ K(X_A, X_loc): the cross-Gram on the Gram kernel,
                    `acquisition.cond_solve` gated on the unpadded count
    mean, var (n_loc,)  its byproducts
  replicated: the candidates x (N, dim), the sampled set and the path sets.

A step gathers what the set scorer reads at the path sets' rows (and, for
MI, at the sampled set's): each rank takes the rows it owns, zeros
elsewhere, and ONE all-reduce over the grid sums them all, with the
metrics' masked sums.  The per-set blocks are scored on every rank by the
single card's helpers (`acquisition._score_sets_gathered`, `_pblk_finish`,
`_pblk_lowrank_prior`, `path_set_argmax`), so the mesh and the card run
the same arithmetic up to the order of the cross-rank sums (ties only).
The exact MI complement's Schur factor U = (WᵀW)[:, A] is summed only at
the rows the step reads (the sampled set's and the sets'), O((cap + R)·cap)
floats, never O(N).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from algp_tpu_torch import acquisition as acq
from algp_tpu_torch import acquisition_lowrank as acq_lr
from algp_tpu_torch.acquisition_lowrank import LowRankPrecision
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec, gram_diag
from algp_tpu_torch.parallel.sharded import Mesh, psum_many
from algp_tpu_torch.parallel.sharded_lowrank import lowrank_rows
from algp_tpu_torch.parallel.sharded_mi import Strip, distributed_w

#: the candidate padding is a multiple of lcm(_ALIGN, S), as the reference's
_ALIGN = 256


def mesh_pad(x: torch.Tensor, n_shards: int) -> tuple[torch.Tensor, int]:
    """Pad the candidate axis to a multiple of lcm(256, n_shards) with the
    inert far-away sentinels of `acquisition.pad_candidates` (their kernel
    to every candidate is ≈ 0).  Returns (x_pad, n_valid)."""
    a = _ALIGN * n_shards // math.gcd(_ALIGN, n_shards)
    N = x.shape[0]
    x_pad, _ = acq.pad_candidates(
        x, torch.ones((N,), dtype=torch.float32, device=x.device), align=a)
    return x_pad, N


def _strip(mesh: Mesh, params: KernelParams, x: torch.Tensor, n_valid: Optional[int],
           min_noise: float, nv_mult: float) -> Strip:
    """This rank's block of the padded candidates, every candidate at the
    scoring noise nv_mult · max(exp(2·log_noise), min_noise²)."""
    N = x.shape[0]
    if N % mesh.grid:
        raise ValueError(f"{N} candidates do not tile {mesh.grid} grid ranks: "
                         "pad them with mesh_pad")
    n_loc = N // mesh.grid
    nv = acq_lr._candidate_nv(params, N, x.device, min_noise, nv_mult)
    return Strip(mesh, x, nv, mesh.g * n_loc, n_loc, N if n_valid is None else n_valid)


def _rows_at(v: torch.Tensor, idx: torch.Tensor, g0: int, n_loc: int,
             dim: int = 0) -> torch.Tensor:
    """This rank's share of v's entries at the global indices `idx` along
    `dim` (v holds [g0, g0 + n_loc) there): the entries it owns, zeros at
    the others.  Summed over the grid, the entries."""
    loc = idx - g0
    own = (loc >= 0) & (loc < n_loc)
    part = v.index_select(dim, loc.clamp(0, n_loc - 1))
    shape = [1] * v.dim()
    shape[dim] = -1
    return torch.where(own.reshape(shape), part, 0.0)


# ---------------------------------------------------------------------------
# Seeds (built once a refit, kept on their ranks across the steps)
# ---------------------------------------------------------------------------


def sharded_lowrank_seed(
    mesh: Mesh,
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    z: torch.Tensor,
    *,
    min_noise: float = 1e-3,
    nv_mult: float = 1.0,
    n_valid: Optional[int] = None,
) -> LowRankPrecision:
    """`acquisition_lowrank.lowrank_seed_with_z` with its N-axis factors
    built and returned as this rank's rows: VT (n_loc, M), dinv and
    pdiag (n_loc,), O(N·M/S) a rank (K_zx on the Gram kernel, one M × M
    all-reduce).  x must be `mesh_pad`-padded; `n_valid`, the unpadded
    count, gates the solves.  z (K, M, dim) builds the z-ensemble: K
    seeds, stacked on a leading K axis."""
    strip = _strip(mesh, params, x, n_valid, min_noise, nv_mult)
    if z.dim() == 2:
        return lowrank_rows(spec, params, strip, z)
    seeds = [lowrank_rows(spec, params, strip, zk) for zk in z.unbind(0)]
    return LowRankPrecision(*(torch.stack(parts) for parts in zip(
        *((s.VT, s.dinv, s.pdiag) for s in seeds))))


def sharded_precision_seed(
    mesh: Mesh,
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    *,
    min_noise: float = 1e-3,
    nv_mult: float = 1.0,
) -> torch.Tensor:
    """`acquisition.implicit_precision_seed`'s W = L⁻¹ as this rank's rows
    (n_loc, N), by the distributed strip factorization
    (`sharded_mi.distributed_w`): O(N²/S) a rank.  No Wᵀ: the step reads
    columns of its own strip.  x must be `mesh_pad`-padded."""
    return distributed_w(spec, params, _strip(mesh, params, x, None, min_noise, nv_mult))


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _step(mesh, spec, params, x, idx_pad, count, ns_pad, y_pad, sets, set_sizes, costs,
          lr, W, truth, *, strategy, min_noise, nv_mult, n_valid, path_utility):
    """The episode step on this rank's block.  Returns (best, mean, var,
    scores) with mean / var this rank's (n_loc,), or with `truth`
    (f_true, obs_mask, test_mask, padded to x's length) the device metrics
    (best, rmse, rmse_test, mean_var, var_sites)."""
    lowrank = lr is not None or (strategy == "mi" and W is None)
    if strategy == "mi" and lowrank and lr is None:
        raise ValueError("the sharded mi episode step needs the sharded_lowrank_seed "
                         "result (lr=) or the sharded_precision_seed result (W=)")
    strip = _strip(mesh, params, x, n_valid, min_noise, nv_mult)
    g0, n_loc, n_valid = strip.g0, strip.n_loc, strip.n_valid
    dev = x.device
    cap = idx_pad.shape[0]
    S, k = sets.shape
    rows = sets.reshape(-1)  # (R,)
    base = torch.clamp_min(torch.exp(2.0 * params.log_noise), min_noise * min_noise)
    valid = torch.arange(cap, device=dev) < count
    pnv = torch.where(valid, base * ns_pad, 1.0)

    # conditioning on everything sampled, on this rank's block (the
    # cross-Gram on the Gram kernel, `cond_solve` gated on the unpadded
    # count: the single card's family), and the posterior byproducts
    C, d, taken, LA = acq._batch_pilot_condition(
        spec, params, x, pnv, idx_pad, count, gram_diag(spec, params, strip.x_loc),
        n_valid=n_valid, cols=strip.x_loc, col0=g0)
    mean = C.mT @ la.solve_triangular(LA, torch.where(valid, y_pad, 0.0))
    d = torch.clamp_min(d, 0.0)

    # every block the step reads, this rank's share of it: one all-reduce
    parts = [_rows_at(C, rows, g0, n_loc, dim=1),  # (cap, R) basis columns
             _rows_at(taken.to(torch.float32), rows, g0, n_loc)]
    if strategy == "mi":
        # the sampled set's slots taking part in the delete: valid, each
        # index once (a node sampled twice is deleted once)
        vdel = acq_lr._first_occurrence(idx_pad, valid)
        vdf = vdel.to(torch.float32)
        idx_del = torch.where(vdel, idx_pad, 0)
        if lowrank:
            designs = list(zip(lr.VT, lr.dinv)) if lr.VT.dim() == 3 else [(lr.VT, lr.dinv)]
            for VT, dinv in designs:
                parts += [_rows_at(VT, idx_del, g0, n_loc), _rows_at(dinv, idx_del, g0, n_loc),
                          _rows_at(VT, rows, g0, n_loc), _rows_at(dinv, rows, g0, n_loc)]
        else:
            # W's columns are global: U = (WᵀW)[:, A] at the rows read
            # (the sampled set's, then the sets'), and the sets' prior
            # blocks (WᵀW)_SS, from the local strip
            Wc = W.index_select(1, torch.cat([idx_del, rows]))  # (n_loc, cap + R)
            Ws = Wc[:, cap:].reshape(n_loc, S, k).permute(1, 2, 0)  # (S, k, n_loc)
            parts += [Wc.mT @ (Wc[:, :cap] * vdf), Ws @ Ws.mT]
    if truth is not None:
        f_true, obs_m, test_m = (t[g0:g0 + n_loc] for t in truth)
        err = mean - f_true
        live = (strip.gidx < n_valid).to(torch.float32)
        parts += [torch.stack([torch.sum(obs_m * err * err), torch.sum(obs_m),
                               torch.sum(test_m * err * err), torch.sum(test_m),
                               torch.sum(live * d)]),
                  _rows_at(d, rows, g0, n_loc)]
    got = psum_many(mesh.grid_group, *parts)
    Bs = got[0].reshape(cap, S, k).permute(1, 0, 2)  # (S, cap, k)
    tk = (got[1] > 0.5).reshape(S, k)
    xs = x.index_select(0, rows).reshape(S, k, -1)
    nvs = strip.nv.index_select(0, rows).reshape(S, k)

    def score(Pblk, strat):
        return acq._score_sets_gathered(spec, params, xs, Bs, nvs, set_sizes, Pblk,
                                        strategy=strat, sets=sets)

    if strategy != "mi":
        scores = score(None, strategy)
    elif lowrank:
        per_design = []
        for i in range(len(designs)):
            VA, dA, Vr, dr = got[2 + 4 * i: 6 + 4 * i]
            F_rows, ZT_rows = acq_lr._corrections_rows(VA, dA, Vr, dr, rows, idx_del, vdel)
            P0 = acq._pblk_lowrank_prior(sets, Vr.reshape(S, k, -1), dr.reshape(S, k))
            per_design.append(score(acq._pblk_finish(
                P0, F_rows.reshape(S, k, -1), ZT_rows.reshape(S, k, -1), tk), "mi"))
        scores = (per_design[0] if lr.VT.dim() == 2
                  else torch.mean(torch.stack(per_design), dim=0))
    else:
        U, P0 = got[2] * vdf[None, :], got[3]
        PA = U[:cap] * vdf[:, None]
        PA = torch.where(vdel[:, None] & vdel[None, :], PA,
                         torch.eye(cap, dtype=torch.float32, device=dev))
        F_rows = U[cap:]  # (R, cap)
        ZT_rows = la.cho_solve(la.cholesky(PA), F_rows.mT).mT * vdf[None, :]
        scores = score(acq._pblk_finish(
            P0, F_rows.reshape(S, k, -1), ZT_rows.reshape(S, k, -1), tk), "mi")
    best = acq.path_set_argmax(scores, set_sizes, costs, path_utility=path_utility)
    if truth is None:
        return best, mean, d, scores
    sums, d_rows = got[-2], got[-1]
    rmse = torch.sqrt(sums[0] / torch.clamp_min(sums[1], 1.0))
    rmse_test = torch.sqrt(sums[2] / torch.clamp_min(sums[3], 1.0))
    var_sites = d_rows.reshape(S, k).index_select(0, best.reshape(1))[0]
    return best, rmse, rmse_test, sums[4] / float(n_valid), var_sites


def sharded_plan_episode_step(
    mesh: Mesh,
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
    lr: Optional[LowRankPrecision] = None,
    W: Optional[torch.Tensor] = None,
    *,
    strategy: str = "entropy",
    min_noise: float = 1e-3,
    nv_mult: float = 1.0,
    n_valid: Optional[int] = None,
    path_utility: str = "per_cost",
):
    """`acquisition.plan_episode_step` / `plan_episode_step_lowrank` over
    the mesh: returns (best, mean, post_var, scores), best and scores the
    same on every rank, mean and post_var this rank's (n_loc,) block.
    `lr` (`sharded_lowrank_seed`) gives the low-rank MI complement, `W`
    (`sharded_precision_seed`) the exact one; entropy needs neither.  x
    must be `mesh_pad`-padded; `n_valid` is the unpadded count."""
    return _step(mesh, spec, params, x, idx_pad, count, noise_scale_pad, y_pad, sets,
                 set_sizes, costs, lr, W, None, strategy=strategy, min_noise=min_noise,
                 nv_mult=nv_mult, n_valid=n_valid, path_utility=path_utility)


def sharded_plan_episode_step_metrics(
    mesh: Mesh,
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
    f_true: torch.Tensor,
    obs_mask: torch.Tensor,
    test_mask: torch.Tensor,
    lr: Optional[LowRankPrecision] = None,
    W: Optional[torch.Tensor] = None,
    *,
    strategy: str = "entropy",
    min_noise: float = 1e-3,
    nv_mult: float = 1.0,
    n_valid: Optional[int] = None,
    path_utility: str = "per_cost",
):
    """`sharded_plan_episode_step` with the metrics reduced on the device:
    returns (best, rmse, rmse_test, mean_var, var_sites), the same on
    every rank; the O(N) fields stay on their ranks.  The truth and masks
    are zero-padded to x's `mesh_pad` length."""
    return _step(mesh, spec, params, x, idx_pad, count, noise_scale_pad, y_pad, sets,
                 set_sizes, costs, lr, W, (f_true, obs_mask, test_mask), strategy=strategy,
                 min_noise=min_noise, nv_mult=nv_mult, n_valid=n_valid,
                 path_utility=path_utility)
