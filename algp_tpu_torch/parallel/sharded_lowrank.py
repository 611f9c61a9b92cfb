"""Greedy low-rank Krause-MI selection with the candidate axis split over the
mesh's 'grid' ranks (the counterpart of algp_tpu.parallel.sharded_lowrank):
O(N·M/S) state a rank.

The FITC seed is built on the strip:

    Ut_loc = L_zz⁻¹ K(z, x_loc)          the Gram kernel, local O(n_loc·M²)
    B_M    = I + Σ_ranks A_loc Ut_locᵀ    one M × M all-reduce
    VT_loc = (L_B⁻¹ A_loc)ᵀ               local, row-major

with A_loc = Ut_loc · D_loc⁻¹, then the pilot conditioning on the strip
and the pilot delete, whose pilot rows of VT and of the Schur factor are
masked-sum gathers.  The rounds are `sharded_mi.greedy_loop` with the
low-rank column P̃0[:, j] = d⁻¹ⱼ eⱼ − VT_loc · v_j, v_j = VT[j] (M floats)
gathered with the round's other rows at j.  The K_zz factor and the
solves are the single-card seed's (`acquisition_lowrank._zz_factor`,
`_seed_solve`, gated on the unpadded N).
"""

from __future__ import annotations

import torch

from algp_tpu_torch import acquisition as acq
from algp_tpu_torch import acquisition_lowrank as lr
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.gram import gram_kernel
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec, gram_diag
from algp_tpu_torch.parallel.sharded import Mesh, psum
from algp_tpu_torch.parallel.sharded_mi import (
    Precision,
    ShardedSelection,
    Strip,
    _first_valid,
    candidate_strip,
    greedy_loop,
    strip_state,
)


def _pilot_rows(mesh: Mesh, strip: Strip, idx, valid, *tensors):
    """The rows at pilot slots `idx` of (n_loc, ...) strip tensors, on every
    grid rank (zeros at invalid slots): the owners' rows, summed."""
    loc = idx - strip.g0
    own = valid & (loc >= 0) & (loc < strip.n_loc)
    loc = loc.clamp(0, strip.n_loc - 1)
    out = []
    for t in tensors:
        rows = t.index_select(0, loc)
        mask = own.reshape(-1, *([1] * (rows.dim() - 1)))
        out.append(psum(torch.where(mask, rows, 0.0), mesh.grid_group))
    return out


def lowrank_rows(spec: KernelSpec, params: KernelParams, strip: Strip,
                 z: torch.Tensor) -> lr.LowRankPrecision:
    """This rank's rows of the low-rank prior precision
    P̃0 = diag(dinv) − VT·VTᵀ of one inducing design z (M, dim): VT
    (n_loc, M), dinv and pdiag (n_loc,).  One M × M all-reduce."""
    M = z.shape[0]
    Ut = lr._seed_solve(lr._zz_factor(spec, params, z),
                        gram_kernel(spec, params, z, strip.x_loc), strip.n_valid)
    qdiag = torch.sum(Ut * Ut, dim=0)
    dfitc = torch.clamp_min(gram_diag(spec, params, strip.x_loc) - qdiag, 0.0) + strip.nv_loc
    dinv = 1.0 / dfitc
    A = Ut * dinv[None, :]  # (M, n_loc) = Uᵀ D⁻¹ on the strip
    BM = lr._eye(M, strip.x.device) + psum(A @ Ut.T, strip.mesh.grid_group)
    VT = lr._seed_solve(la.cholesky(BM), A, strip.n_valid).mT.contiguous()  # (n_loc, M)
    del Ut, A
    return lr.LowRankPrecision(VT=VT, dinv=dinv, pdiag=dinv - torch.sum(VT * VT, dim=1))


def lowrank_seed_strip(spec: KernelSpec, params: KernelParams, strip: Strip,
                       z: torch.Tensor, pilot_idx, num_pilot: int, T: int) -> Precision:
    """The low-rank precision P̃ = diag(dinv) − VT·VTᵀ − F·G on the strip,
    the pilots deleted."""
    mesh, dev, n_loc = strip.mesh, strip.x.device, strip.n_loc
    seed = lowrank_rows(spec, params, strip, z)
    VT, dinv, pdiag = seed.VT, seed.dinv, seed.pdiag
    F = torch.zeros((n_loc, T), dtype=torch.float32, device=dev)
    G = torch.zeros((T, n_loc), dtype=torch.float32, device=dev)
    gidx = strip.gidx
    if num_pilot:
        m = num_pilot
        valid, vf, idx = _first_valid(pilot_idx, m)
        VA, dA = _pilot_rows(mesh, strip, idx, valid, VT, dinv)  # (m, M), (m,)
        own = (gidx[:, None] == idx[None, :]) & valid[None, :]
        U0 = (-(VT @ VA.mT) + torch.where(own, dA[None, :], 0.0)) * vf[None, :]
        PA, = _pilot_rows(mesh, strip, idx, valid, U0)  # (m, m) = U0[A, :]
        pair = valid[:, None] & valid[None, :]
        PA = torch.where(pair, PA, lr._eye(m, dev))
        Z = la.cho_solve(la.cholesky(PA), U0.mT) * vf[:, None]  # (m, n_loc)
        F[:, :m] = U0
        G[:m] = Z
        pdiag = pdiag - torch.sum(U0 * Z.mT, dim=1)
        pdiag = torch.where(acq._mask_of(pilot_idx - strip.g0, valid, n_loc), 1.0, pdiag)

    def column(j1, vj, dinv_j):
        return -(VT @ vj) + torch.where(gidx == j1, dinv_j, 0.0)

    return Precision(F=F, G=G, pdiag=pdiag, column=column, rows=(VT, dinv),
                     shapes={"VT": tuple(VT.shape)})


def sharded_greedy_select_mi_lowrank(
    mesh: Mesh,
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    nv: torch.Tensor,
    pilot_idx: torch.Tensor,
    z: torch.Tensor,
    *,
    rounds: int,
    num_pilot: int,
) -> ShardedSelection:
    """Greedy low-rank Krause MI with the candidate axis split over the grid
    ranks: `acquisition_lowrank.greedy_select_lowrank` index for index on
    tie-free fields (one inducing design z (M, dim))."""
    strip, pilot_idx, pilot_nv = candidate_strip(mesh, x, nv, pilot_idx)
    T = num_pilot + rounds
    st = strip_state(spec, params, strip, pilot_idx, num_pilot, pilot_nv, T)
    st.precision = lowrank_seed_strip(spec, params, strip, z, pilot_idx, num_pilot, T)
    return greedy_loop(spec, params, strip, st, rounds=rounds, num_pilot=num_pilot)
