"""Blocked Cholesky factorization from the hand-written CUDA kernel
`csrc/chol.cu` (the counterpart of algp_tpu.ops.pallas_chol, whose two
Pallas kernels — `cholesky_pallas` and the lookahead `cholesky_pallas_la`
— it replaces).

`cholesky(K)` returns tril(L) with L Lᵀ = K: the kernel for a CUDA K,
the plain version `cholesky_reference` for a CPU K (what the reference
computes off the TPU), and for nothing else.  A failed factorization is
NaN, never an exception: the kernel's NaN starts at the failing pivot's
column and spreads through every later column; the plain version is NaN
throughout (the `la.cholesky` contract).

No path of the port calls it yet: the fit, the MI seed and the episode
keep `ops.linalg.cholesky` (cuSOLVER), as the reference keeps XLA's
factor in its hot paths.  `chip_smoke.py` runs it on the seed matrices
of the main path and the episode.
"""

from __future__ import annotations

import ctypes

import torch

from algp_tpu_torch.ops import _cuda
from algp_tpu_torch.ops import linalg as la

#: kernel launches so far: factorizations, each 3·⌈n/64⌉ − 2 device launches
LAUNCHES = 0


def cholesky_reference(K: torch.Tensor) -> torch.Tensor:
    """Plain version: tril of the library factor, NaN on failure."""
    return torch.tril(la.cholesky(K))


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """tril(L), L Lᵀ = K, for a symmetric positive-definite (n, n) f32 K:
    the CUDA kernel for a CUDA K (any n; K is not modified), the plain
    version for a CPU K."""
    global LAUNCHES
    if K.device.type == "cpu":
        return cholesky_reference(K)
    if K.device.type != "cuda":
        raise ValueError(f"cholesky: unsupported device {K.device}")
    if K.dtype != torch.float32 or K.dim() != 2 or K.shape[0] != K.shape[1]:
        raise ValueError(
            f"cholesky: K must be square 2-D float32, got {K.dtype} {tuple(K.shape)}"
        )
    L = K.clone(memory_format=torch.contiguous_format)  # factored in place
    n = L.shape[0]
    if n == 0:
        return L
    lib = _cuda.library()
    winv = torch.empty((lib.algp_chol_scratch(),), dtype=torch.float32,
                       device=K.device)
    code = lib.algp_cholesky(
        ctypes.c_void_p(L.data_ptr()), ctypes.c_void_p(winv.data_ptr()), n,
        _cuda.stream_ptr(K.device),
    )
    _cuda.check(code, "cholesky kernel launch")
    LAUNCHES += 1
    return L
