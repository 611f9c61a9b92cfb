"""Restart data parallelism and the candidate-sharded greedy selection over
`torch.distributed` (the counterpart of algp_tpu.parallel.sharded).

The reference maps the workload onto a 2-D (restarts × grid) device mesh
of one program: the restart batch of the multi-restart fit shards over
'restarts', the candidate axis N of the selection state over 'grid', and
XLA inserts the collectives.  Here every rank of a `torch.distributed`
world runs the same program on its own shard, and the collectives are
written out: rank r sits at (r // grid, r % grid), each axis has its own
process group, and the helpers below (`psum`, `pmax`, `pmin`,
`all_gather`, `global_argmax`, `row_at`, `bcast_from`) see a group that
is None on an axis of size 1, where they are the identity.  Only
`all_reduce` (SUM / MAX / MIN) and list-form `all_gather` are used, which
both gloo and NCCL take.  Every rank is given the same replicated inputs
(the training set, the candidates, the pilots, the restart inits) and
returns the same replicated results.

  * `sharded_fit`: rank (r, g) runs its contiguous slice of the restart
    batch through the fit's optimizer loop; the per-restart NLLs and
    parameters are all-gathered over 'restarts' and the argmin (lowest
    index first) picks the winner, as on one card.
  * `sharded_greedy_select`: "mi" goes to `parallel.sharded_mi`;
    "entropy" is the same sharded loop without the precision column (the
    reference gets it from GSPMD annotations of the single-card loop).
  * `sharded_training_step`: fit, the winner's parameters, the sharded
    greedy rounds.

A world of 1 is a 1 × 1 mesh: every collective is skipped and every path
computes what the single-card functions compute.
"""

from __future__ import annotations

import dataclasses
import math
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from algp_tpu_torch.config import FitConfig
from algp_tpu_torch.models import gp as gp_mod
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec

#: every process group's timeout: a rank that waits longer on a collective
#: raises instead of hanging
TIMEOUT = timedelta(seconds=60)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (restarts × grid) mesh and the process
    group of each axis (None where the axis has size 1)."""

    restarts: int  # the 'restarts' axis' size
    grid: int  # the 'grid' axis' size
    r: int  # this rank's coordinate on 'restarts'
    g: int  # this rank's coordinate on 'grid'
    restarts_group: Optional[dist.ProcessGroup] = None
    grid_group: Optional[dist.ProcessGroup] = None


def make_mesh(restarts_axis: Optional[int] = None) -> Mesh:
    """The (restarts × grid) mesh of the current `torch.distributed` world
    (a 1 × 1 mesh when no process group is initialised).  `restarts_axis`
    defaults to 2 when the world is even and larger than 1; the rest goes
    to the grid, where candidate scoring dominates.  Every rank of the
    world must call it, in the same order as its other group calls."""
    started = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if started else 1
    if restarts_axis is None:
        restarts_axis = 2 if world % 2 == 0 and world > 1 else 1
    if world % restarts_axis:
        raise ValueError(f"make_mesh: {restarts_axis} restarts do not divide {world} ranks")
    grid = world // restarts_axis
    rank = dist.get_rank() if started else 0
    r, g = divmod(rank, grid)
    groups = {}
    # every rank creates every group, in one order
    if grid > 1:
        for ri in range(restarts_axis):
            grp = dist.new_group([ri * grid + k for k in range(grid)], timeout=TIMEOUT)
            if ri == r:
                groups["grid_group"] = grp
    if restarts_axis > 1:
        for gi in range(grid):
            grp = dist.new_group([i * grid + gi for i in range(restarts_axis)],
                                 timeout=TIMEOUT)
            if gi == g:
                groups["restarts_group"] = grp
    return Mesh(restarts=restarts_axis, grid=grid, r=r, g=g, **groups)


# ---------------------------------------------------------------------------
# Collectives over one axis (the identity where its group is None)
# ---------------------------------------------------------------------------


def _reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in place in `t` (a tensor the caller owns)."""
    return _reduce(t, dist.ReduceOp.SUM, group)


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    return _reduce(t, dist.ReduceOp.MAX, group)


def pmin(t: torch.Tensor, group) -> torch.Tensor:
    return _reduce(t, dist.ReduceOp.MIN, group)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors of t's shape, concatenated along dim 0 in group
    rank order (the index order of the axis' blocks)."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def bcast_from(mesh: Mesh, val: torch.Tensor, owner: int) -> torch.Tensor:
    """`val` of grid rank `owner` on every grid rank (a masked sum: the
    others add exact zeros)."""
    if mesh.grid_group is None:
        return val
    out = (val.clone(memory_format=torch.contiguous_format) if mesh.g == owner
           else torch.zeros(val.shape, dtype=val.dtype, device=val.device))
    return psum(out, mesh.grid_group)


def global_argmax(mesh: Mesh, s_loc: torch.Tensor, g0: int, n: int) -> torch.Tensor:
    """The global index (a (1,) device tensor) of the largest score of the
    grid's index-ordered blocks, the lowest index on ties: the local
    argmax (lowest local index first), MAX of the score, then MIN of the
    tying ranks' indices."""
    j_loc = torch.argmax(s_loc).reshape(1)
    gj = j_loc + g0
    if mesh.grid_group is None:
        return gj
    lv = s_loc.index_select(0, j_loc)
    vmax = pmax(lv.clone(), mesh.grid_group)
    return pmin(torch.where(lv == vmax, gj, n), mesh.grid_group)


def psum_many(group, *parts: torch.Tensor) -> list:
    """The group's sums of several f32 tensors in one all-reduce (of their
    flat concatenation), each back in its shape; the tensors themselves
    where the group is None."""
    if group is None:
        return list(parts)
    flat = psum(torch.cat([p.reshape(-1) for p in parts]), group)
    out, off = [], 0
    for p in parts:
        out.append(flat[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
    return out


def row_at(mesh: Mesh, j1: torch.Tensor, g0: int, *tensors: torch.Tensor) -> list:
    """Row j (a (1,) device index) of each (n_loc, ...) tensor of the
    grid's candidate-sharded state, on every grid rank: the owner's row,
    the others' zeros, summed in one collective.  A vector's entry j
    comes back 0-d, so one call gathers the round's rows and scalars."""
    n_loc = tensors[0].shape[0]
    jl = (j1 - g0).clamp(0, n_loc - 1)
    rows = [t.index_select(0, jl)[0] for t in tensors]
    if mesh.grid_group is None:
        return rows
    own = (j1 >= g0) & (j1 < g0 + n_loc)
    return psum_many(mesh.grid_group,
                     *(torch.where(own, r, 0.0).reshape(r.shape) for r in rows))


# ---------------------------------------------------------------------------
# Restart data parallelism
# ---------------------------------------------------------------------------


def opt_loop_restarts(mesh: Mesh, cfg: FitConfig, loss, inits, *,
                      ragged: str = "raise"):
    """`gp._opt_loop` with the restart batch (every leaf's leading axis)
    split over the 'restarts' axis: each rank runs its contiguous slice
    and the slices' (best_p, best_nll, trace) are all-gathered, so every
    rank returns the whole batch's.  A restart count the axis does not
    divide raises (`ragged="raise"`) or runs whole on every rank
    (`"replicate"`)."""
    R = gp_mod.tree_leaves(inits)[0].shape[0]
    n_ax = mesh.restarts
    if R % n_ax:
        if ragged != "replicate":
            raise ValueError(f"{R} restarts do not divide the {n_ax}-rank restarts axis")
        n_ax = 1
    if n_ax == 1:
        return gp_mod._opt_loop(cfg, loss, inits)
    per = R // n_ax
    local = gp_mod.tree_map(lambda a: a[mesh.r * per:(mesh.r + 1) * per], inits)
    best_p, best_nll, trace = gp_mod._opt_loop(cfg, loss, local)
    grp = mesh.restarts_group
    best_p = gp_mod.tree_map(lambda a: all_gather(a, grp), best_p)
    return best_p, all_gather(best_nll, grp), all_gather(trace, grp)


def sharded_fit(
    mesh: Mesh,
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    y: torch.Tensor,
    noise_scale: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    *,
    inits: Optional[KernelParams] = None,
) -> gp_mod.FitResult:
    """Multi-restart MLL fit with the restarts split over the 'restarts'
    axis; the training data is the same on every rank.  `inits`
    (restart axis leading) replaces the inits drawn from `generator`.
    Raises ValueError when the restart count does not divide the axis."""
    if inits is None:
        inits = gp_mod.make_restart_inits(spec, cfg, generator, device=x.device)
    loss = gp_mod._mll_loss(spec, cfg, x, y, noise_scale)
    return gp_mod.best_of(*opt_loop_restarts(mesh, cfg, loss, inits))


def sharded_fit_icm(
    mesh: Mesh,
    spec: KernelSpec,
    cfg: FitConfig,
    x: torch.Tensor,
    Y: torch.Tensor,
    obs_mask: Optional[torch.Tensor] = None,
    noise_scale: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    *,
    rank: int = 1,
    inits=None,
):
    """The coregionalized (ICM) multi-restart fit with its restarts split
    over the 'restarts' axis: `coregional.fit_icm(..., mesh=mesh)`."""
    from algp_tpu_torch.models import coregional as icm_mod

    return icm_mod.fit_icm(spec, cfg, x, Y, obs_mask, noise_scale, generator,
                           rank=rank, inits=inits, mesh=mesh)


# ---------------------------------------------------------------------------
# Candidate-sharded greedy selection
# ---------------------------------------------------------------------------


def mesh_align(mesh: Mesh) -> int:
    """The candidate padding of the mesh paths: a multiple of both 512 and
    the grid size, as in the reference."""
    S = mesh.grid
    return 512 * S // math.gcd(512, S)


def sharded_greedy_select(
    mesh: Mesh,
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    nv: torch.Tensor,
    pilot_idx: torch.Tensor,
    *,
    rounds: int,
    num_pilot: int,
    strategy: str = "entropy",
):
    """Greedy selection with the candidate axis split over 'grid'
    (`acquisition.greedy_select` index for index on tie-free fields).
    Returns a `sharded_mi.ShardedSelection`: this rank's strip of the
    state, the selections replicated.

    mi: `sharded_mi.sharded_greedy_select_mi` (replicated seed).
    entropy: local scores, the global argmax, the posterior column on
    the local rows, the masked gather of B[:, j] and d[j], the local
    rank-1 update; the pilots condition each rank's strip through the
    Gram kernel."""
    from algp_tpu_torch.parallel.sharded_mi import (
        candidate_strip,
        greedy_loop,
        sharded_greedy_select_mi,
        strip_state,
    )

    if strategy == "mi":
        return sharded_greedy_select_mi(
            mesh, spec, params, x, nv, pilot_idx, rounds=rounds, num_pilot=num_pilot)
    if strategy != "entropy":
        raise ValueError(f"unknown strategy {strategy!r}")
    strip, pilot_idx, pilot_nv = candidate_strip(mesh, x, nv, pilot_idx)
    st = strip_state(spec, params, strip, pilot_idx, num_pilot, pilot_nv, num_pilot + rounds)
    return greedy_loop(spec, params, strip, st, rounds=rounds, num_pilot=num_pilot)


def sharded_training_step(
    mesh: Mesh,
    spec: KernelSpec,
    cfg: FitConfig,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    x_grid: torch.Tensor,
    nv: torch.Tensor,
    pilot_idx: torch.Tensor,
    *,
    rounds: int = 4,
    strategy: str = "entropy",
    generator: Optional[torch.Generator] = None,
    inits: Optional[KernelParams] = None,
):
    """The mesh's training step: the restart-sharded fit, the winner's
    parameters, then the candidate-sharded greedy rounds.  Returns
    (params, all restarts' NLLs, selected, post_var), the last the
    posterior variance of every candidate, gathered."""
    fit = sharded_fit(mesh, spec, cfg, x_train, y_train, generator=generator, inits=inits)
    sel = sharded_greedy_select(
        mesh, spec, fit.params, x_grid, nv, pilot_idx, rounds=rounds,
        num_pilot=int(pilot_idx.shape[0]), strategy=strategy)
    return fit.params, fit.all_nlls, sel.selected, sel.gather_post_var(mesh)
