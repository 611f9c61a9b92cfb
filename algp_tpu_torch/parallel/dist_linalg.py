"""Distributed dense linear algebra over the mesh's 'grid' ranks: each rank
holds its (N/S, N) row strip, O(N²/S) memory (the counterpart of
algp_tpu.parallel.dist_linalg).

Panel k is rank k's strip of columns, so the S panels run in order:

  Cholesky, k = 0..S−1:
    1. rank k's diagonal block D_k reaches every rank (a masked sum,
       (nl, nl));
    2. every rank factors D_k itself; the ranks below the panel form
       W_kk = L_kk⁻¹;
    3. the ranks below the panel solve their rows of the panel
       (C = A[:, panel] · W_kkᵀ, one product), rank k writes L_kk;
    4. the panel's columns are all-gathered ((N, nl), N² floats over the
       whole factorization) and the ranks below update their trailing
       columns: A_loc[:, later] −= C_loc · C_laterᵀ.

  Triangular inverse (block forward substitution), k = 0..S−1:
    W_k = W_kk · [−L_k,<k · W_<k | I | 0]: rank k's row block of L left of
    the panel reaches every rank, the earlier ranks' partial products are
    summed in one all-reduce, and rank k writes its strip.

Every product is an f32 matmul with TF32 off; the (nl, nl) factors are
`la.cholesky` and `la.tri_inv`, as the single-card seed's are.  The block
arithmetic differs from a one-piece factor in the last ulp.
"""

from __future__ import annotations

import torch

from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.parallel.sharded import Mesh, all_gather, bcast_from, psum


def _panels(mesh: Mesh, A_loc: torch.Tensor) -> int:
    nl, N = A_loc.shape
    if mesh.grid * nl != N:
        raise ValueError(f"a ({nl}, {N}) strip does not tile {mesh.grid} grid ranks")
    return nl


def dist_cholesky(mesh: Mesh, A_loc: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the lower Cholesky factor of the SPD matrix whose
    row strip is A_loc (nl, N); zeros above the diagonal.  A failed
    pivot gives NaN, as `la.cholesky` does.  (The reference's
    `dist_cholesky_strip` inside its `dist_cholesky`.)"""
    nl = _panels(mesh, A_loc)
    me = mesh.g
    A = A_loc.clone()
    for k in range(mesh.grid):
        c0, c1 = k * nl, (k + 1) * nl
        L_kk = la.cholesky(bcast_from(mesh, A[:, c0:c1], k))
        if me > k:
            A[:, c0:c1] = A[:, c0:c1] @ la.tri_inv(L_kk).mT
        elif me == k:
            A[:, c0:c1] = L_kk
        if k + 1 < mesh.grid:
            C = all_gather(A[:, c0:c1], mesh.grid_group)  # (N, nl)
            if me > k:
                A[:, c1:] -= A[:, c0:c1] @ C[c1:].mT
    return torch.tril(A, diagonal=me * nl)  # columns ≤ the global row


def dist_tri_inv(mesh: Mesh, L_loc: torch.Tensor) -> torch.Tensor:
    """This rank's rows of W = L⁻¹ for the lower factor whose row strip is
    L_loc (nl, N).  (The reference's `dist_tri_inv_strip` inside its
    `dist_tri_inv`.)"""
    nl = _panels(mesh, L_loc)
    me = mesh.g
    W = torch.zeros_like(L_loc)
    for k in range(mesh.grid):
        c0, c1 = k * nl, (k + 1) * nl
        W_kk = la.tri_inv(bcast_from(mesh, L_loc[:, c0:c1], k))
        if k:
            Lrow = bcast_from(mesh, L_loc[:, :c0], k)  # (nl, c0), rank k's
            # rank t < k adds L_k,t · W_t; later ranks add zeros
            part = (Lrow[:, me * nl:(me + 1) * nl] @ W if me < k
                    else torch.zeros_like(W))
            P = psum(part, mesh.grid_group)  # (nl, N) = L_k,<k · W_<k
            if me == k:
                W[:, :c0] = -(W_kk @ P[:, :c0])
        if me == k:
            W[:, c0:c1] = W_kk
    return W

