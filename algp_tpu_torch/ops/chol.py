"""Blocked Cholesky factorization from the hand-written CUDA kernel
`csrc/chol.cu` (the counterpart of algp_tpu.ops.pallas_chol, whose two
Pallas kernels — `cholesky_pallas` and the lookahead `cholesky_pallas_la`
— it replaces).

`cholesky(K)` returns tril(L) with L Lᵀ = K: the kernel for a CUDA K,
the plain version `cholesky_reference` for a CPU K (what the reference
computes off the TPU), and for nothing else.  A failed factorization is
NaN, never an exception: the kernel's NaN starts at the failing pivot's
column and spreads through every later column; the plain version is NaN
throughout (the `la.cholesky` contract), and `nan_if_failed` widens the
kernel's NaN to that contract on the device.

The kernel factors a copy of K padded to a multiple of 128 with the
identity (rows 128-byte aligned at any n; the padded factor is
[[L, 0], [0, I]]), so K is never modified; at n = 10 000 the pad and the
final n × n copy take 0.67 ms of the call's 12.8 ms on the H100 (PERF.md).

No path of the port calls it: the MI seed of both paths
(`acquisition._seed_factor`), the fit and the episode keep
`ops.linalg.cholesky` (cuSOLVER).  The kernel is faster on the H100, but
the main path's MI selections seeded by it part from the cuSOLVER-seeded
ones at the first round, where candidates' scores tie within f32 noise
(PERF.md §6), so the seed keeps the library factor.  `chip_smoke.py`
runs the kernel on the seed matrices of both paths.
"""

from __future__ import annotations

import ctypes

import torch

from algp_tpu_torch.ops import _cuda
from algp_tpu_torch.ops import linalg as la

#: kernel launches so far: factorizations, each 5·⌈N/256⌉ − 6 device
#: launches for the padded size N > 256
LAUNCHES = 0


def cholesky_reference(K: torch.Tensor) -> torch.Tensor:
    """Plain version: tril of the library factor, NaN on failure."""
    return torch.tril(la.cholesky(K))


def nan_if_failed(L: torch.Tensor) -> torch.Tensor:
    """All NaN if the factorization failed, else L, with no host read: a
    failed factor of `cholesky` is NaN from the failing column on, so its
    last diagonal entry is NaN whenever any entry is."""
    if L.numel() == 0:
        return L
    return torch.where(torch.isnan(L[-1, -1]), torch.nan, L)


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """tril(L), L Lᵀ = K, for a symmetric positive-definite (n, n) f32 K:
    the CUDA kernel for a CUDA K (any n; K is not modified), the plain
    version for a CPU K."""
    global LAUNCHES
    if K.dtype != torch.float32 or K.dim() != 2 or K.shape[0] != K.shape[1]:
        raise ValueError(
            f"cholesky: K must be square 2-D float32, got {K.dtype} {tuple(K.shape)}"
        )
    if K.device.type == "cpu":
        return cholesky_reference(K)
    if K.device.type != "cuda":
        raise ValueError(f"cholesky: unsupported device {K.device}")
    n = K.shape[0]
    if n == 0:
        return K.clone()
    lib = _cuda.library()
    tile = lib.algp_chol_tile()
    N = -(-n // tile) * tile
    if N == n:
        A = K.clone(memory_format=torch.contiguous_format)  # factored in place
    else:
        A = torch.empty((N, N), dtype=torch.float32, device=K.device)
        A[:n, :n] = K
        A[n:].zero_()
        A[n:, n:].diagonal().fill_(1.0)
    lt = torch.empty((lib.algp_chol_lt_floats(N),), dtype=torch.float32,
                     device=K.device)
    wbuf = torch.empty((lib.algp_chol_w_floats(),), dtype=torch.float32,
                       device=K.device)
    code = lib.algp_cholesky(
        ctypes.c_void_p(A.data_ptr()), ctypes.c_void_p(lt.data_ptr()),
        ctypes.c_void_p(wbuf.data_ptr()), N, _cuda.stream_ptr(K.device),
    )
    _cuda.check(code, "cholesky kernel launch")
    LAUNCHES += 1
    return A if N == n else A[:n, :n].contiguous()
