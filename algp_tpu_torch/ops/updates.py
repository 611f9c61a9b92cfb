"""The Krause-MI loop's precision column from the hand-written CUDA kernel
`csrc/wtw_column.cu` (the counterpart of algp_tpu.ops.updates, whose two
bitwise-identical Pallas kernels it replaces).

u = (WᵀW)[:, j] for the lower-triangular seed factor W = L⁻¹, with j a
device tensor: the kernel reads j from device memory, so the selection
loop never waits for the host.
"""

from __future__ import annotations

import ctypes

import torch

from algp_tpu_torch.ops import _cuda

#: kernel launches so far (a run can show that it went through the kernel)
LAUNCHES = 0


def _as_index(j, device) -> torch.Tensor:
    return torch.as_tensor(j, device=device).reshape(1)


def wtw_column_reference(W: torch.Tensor, j) -> torch.Tensor:
    """Plain version: W[:, j] @ W (f32, TF32 off)."""
    return W.index_select(1, _as_index(j, W.device))[:, 0] @ W


def wtw_column(W: torch.Tensor, j) -> torch.Tensor:
    """(WᵀW)[:, j] for lower-triangular W: the CUDA kernel for a CUDA W,
    the plain version for a CPU W.  Only the lower triangle of W is read
    by the kernel, so W must hold exact zeros above its diagonal for the
    two to agree.  An out-of-range j yields a NaN column."""
    global LAUNCHES
    if W.device.type == "cpu":
        return wtw_column_reference(W, j)
    if W.device.type != "cuda":
        raise ValueError(f"wtw_column: unsupported device {W.device}")
    if W.dtype != torch.float32 or W.dim() != 2 or W.shape[0] != W.shape[1]:
        raise ValueError(
            f"wtw_column: W must be square 2-D float32, got {W.dtype} "
            f"{tuple(W.shape)}"
        )
    if not W.is_contiguous():
        raise ValueError("wtw_column: W must be contiguous (row-major)")
    n = W.shape[0]
    jj = _as_index(j, W.device).to(torch.int32)
    out = torch.empty((n,), dtype=torch.float32, device=W.device)
    if n == 0:
        return out
    lib = _cuda.library()
    partial = torch.empty(
        (lib.algp_wtw_splits(n), n), dtype=torch.float32, device=W.device
    )
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    code = lib.algp_wtw_column(
        ptr(W), ptr(jj), ptr(partial), ptr(out), n, _cuda.stream_ptr(W.device)
    )
    _cuda.check(code, "wtw_column kernel launch")
    LAUNCHES += 1
    return out
