"""The Krause-MI loop's precision column from the hand-written CUDA kernel
`csrc/wtw_column.cu` (the counterpart of algp_tpu.ops.updates, whose two
bitwise-identical Pallas kernels it replaces).

u = (WᵀW)[:, j] for the lower-triangular seed factor W = L⁻¹, with j a
device tensor: the kernel reads j from device memory, so the selection
loop never waits for the host.  `wtw_column_strip` is the same sum over a
row strip W[row0 : row0 + rows] of W, the part of the column a rank of
the mesh paths (`algp_tpu_torch.parallel`) adds to the others'.

A call is one kernel launch and allocates nothing when given `out`: the
selection loops allocate the (N,) column once and pass it every round
(each round's column is consumed before the next one is written).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from algp_tpu_torch.ops import _cuda

#: kernel launches so far (a run can show that it went through the kernel)
LAUNCHES = 0


def _as_index(j, device) -> torch.Tensor:
    return torch.as_tensor(j, device=device).reshape(1)


def wtw_column_reference(W: torch.Tensor, j) -> torch.Tensor:
    """Plain version: W[:, j] @ W (f32, TF32 off), of a square W or of a row
    strip (the strip form needs no row offset: its zeros are W's)."""
    return W.index_select(1, _as_index(j, W.device))[:, 0] @ W


def wtw_column(W: torch.Tensor, j, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(WᵀW)[:, j] for lower-triangular W: the CUDA kernel for a CUDA W,
    the plain version for a CPU W.  Only the lower triangle of W is read
    by the kernel, so W must hold exact zeros above its diagonal for the
    two to agree.  An out-of-range j yields a NaN column.  `out`: an (N,)
    buffer of W's type on W's device to write the column into (a loop
    allocates it once and passes it every round); returned."""
    if W.dim() != 2 or W.shape[0] != W.shape[1]:
        raise ValueError(f"wtw_column: W must be square 2-D, got {tuple(W.shape)}")
    return wtw_column_strip(W, j, 0, out=out)


def wtw_column_strip(W_loc: torch.Tensor, j, row0: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_k W[k, j] · W[k, :] over the rows k ∈ [row0, row0 + rows) of a
    lower-triangular W (N × N), given its row strip W_loc = W[row0 : row0
    + rows] (rows × N): the CUDA kernel for a CUDA strip, the plain
    version for a CPU one.  Adding the (N,) results of strips that tile W
    gives (WᵀW)[:, j].  The kernel reads only the strip's entries at
    columns ≤ their row, which must hold W's zeros elsewhere.  j: an index
    (an int64 device tensor of one element is read by the kernel as it
    is; anything else is converted first); `out` as for `wtw_column`."""
    global LAUNCHES
    if W_loc.dim() != 2 or not 0 <= row0 <= W_loc.shape[1] - W_loc.shape[0]:
        raise ValueError(f"wtw_column: a {tuple(W_loc.shape)} strip at row {row0} lies "
                         "outside its square")
    rows, n = W_loc.shape
    if out is not None and (out.shape != (n,) or out.dtype != W_loc.dtype
                            or out.device != W_loc.device or not out.is_contiguous()):
        raise ValueError(f"wtw_column: out must be a contiguous ({n},) {W_loc.dtype} tensor "
                         f"on {W_loc.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    if W_loc.device.type == "cpu":
        u = wtw_column_reference(W_loc, j)
        return u if out is None else out.copy_(u)
    if W_loc.device.type != "cuda":
        raise ValueError(f"wtw_column: unsupported device {W_loc.device}")
    if W_loc.dtype != torch.float32:
        raise ValueError(f"wtw_column: W must be float32, got {W_loc.dtype}")
    if not W_loc.is_contiguous():
        raise ValueError("wtw_column: W must be contiguous (row-major)")
    if not (isinstance(j, torch.Tensor) and j.dtype == torch.int64
            and j.device == W_loc.device and j.numel() == 1):
        j = _as_index(j, W_loc.device).to(torch.int64)
    if out is None:
        out = torch.empty((n,), dtype=torch.float32, device=W_loc.device)
    if n == 0:
        return out
    code = _launcher()(W_loc.data_ptr(), j.data_ptr(), out.data_ptr(), n, row0, rows,
                       _cuda.stream_ptr(W_loc.device))
    _cuda.check(code, "wtw_column kernel launch")
    LAUNCHES += 1
    return out


@functools.cache
def _launcher():
    """The bound C entry point (its argtypes take Python ints)."""
    return _cuda.library().algp_wtw_column
