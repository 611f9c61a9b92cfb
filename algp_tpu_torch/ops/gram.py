"""Gram matrices from the hand-written CUDA kernel `csrc/gram.cu`
(the counterpart of algp_tpu.ops.gram, whose Pallas kernels it replaces).

`gram_kernel` launches the kernel for CUDA tensors and runs the plain
version `gram_reference` (= ops.kernels.gram) for CPU tensors, and for
nothing else: a CUDA input the kernel does not take raises.  For a
spatial-only kernel the ARD lengthscales are folded into the inputs
before the kernel runs, as in the reference; a composite kernel takes the
raw rows and the inverse lengthscales and scales them itself (the same
IEEE products).  The outputscale reaches the kernel as a one-element
device tensor, so nothing here waits for the device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from algp_tpu_torch.ops import _cuda
from algp_tpu_torch.ops.kernels import KERNEL_KINDS, KernelParams, KernelSpec
from algp_tpu_torch.ops.kernels import gram as gram_reference

#: kernel launches so far (a run can show that it went through the kernel)
LAUNCHES = 0
#: of those, the composite template's (a feature segment, spec.df > 0)
COMPOSITE_LAUNCHES = 0

_MAX_DIM = 64  # coordinates per segment the kernel takes


def _scaled(x1: torch.Tensor, x2: torch.Tensor, log_ls: torch.Tensor):
    """x1 and x2 times exp(-log_ls), as the plain version scales them."""
    inv = torch.exp(-log_ls)
    return (x1 * inv).contiguous(), (x2 * inv).contiguous()


def _check(spec: KernelSpec, params: KernelParams, x1, x2) -> None:
    for name, x in (("x1", x1), ("x2", x2)):
        if x.device != x1.device:
            raise ValueError(f"gram_kernel: x1 on {x1.device}, x2 on {x2.device}")
        if x.dtype != torch.float32 or x.dim() != 2:
            raise ValueError(
                f"gram_kernel: {name} must be a 2-D float32 tensor, got "
                f"{x.dtype} {tuple(x.shape)}"
            )
        if x.shape[1] != spec.dim:
            raise ValueError(
                f"gram_kernel: {name} has {x.shape[1]} columns, spec needs "
                f"{spec.dim}"
            )
    if spec.ds > _MAX_DIM or spec.df > _MAX_DIM:
        raise ValueError(f"gram_kernel: at most {_MAX_DIM} dims per segment")
    if params.log_outputscale.dim() != 0:
        raise ValueError("gram_kernel: batched params are not supported")
    for p in (params.log_ls_spatial, params.log_ls_feature, params.log_outputscale):
        if p.device != x1.device or p.dtype != torch.float32:
            raise ValueError(
                f"gram_kernel: params must be float32 on {x1.device}, got "
                f"{p.dtype} on {p.device}"
            )


def gram_kernel(
    spec: KernelSpec, params: KernelParams, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Cross-covariance K(X1, X2), (n1, n2) f32: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    global LAUNCHES, COMPOSITE_LAUNCHES
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return gram_reference(spec, params, x1, x2)
    _check(spec, params, x1, x2)
    if x1.device.type != "cuda":
        raise ValueError(f"gram_kernel: unsupported device {x1.device}")
    n1, n2 = x1.shape[0], x2.shape[0]
    out = torch.empty((n1, n2), dtype=torch.float32, device=x1.device)
    if n1 == 0 or n2 == 0:
        return out
    if spec.df:
        # the composite scales its rows in the kernel
        x1, x2 = x1.contiguous(), x2.contiguous()
        inv = torch.exp(-torch.cat((params.log_ls_spatial, params.log_ls_feature)))
        fk = KERNEL_KINDS.index(spec.feature_kind)
    else:
        x1, x2 = _scaled(x1, x2, params.log_ls_spatial)
        inv, fk = None, -1
    scale = torch.exp(params.log_outputscale).reshape(1)
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())
    code = _cuda.library().algp_gram(
        ptr(x1), ptr(x2), ptr(inv), ptr(scale), ptr(out),
        n1, n2, spec.ds, spec.df, KERNEL_KINDS.index(spec.spatial_kind), fk,
        _cuda.stream_ptr(out.device),
    )
    _cuda.check(code, "gram kernel launch")
    LAUNCHES += 1
    if fk >= 0:
        COMPOSITE_LAUNCHES += 1
    return out


def gram_kernel_with_noise(
    spec: KernelSpec,
    params: KernelParams,
    x: torch.Tensor,
    noise_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K(X, X) + diag noise (heteroscedastic via `noise_scale`).  The noise
    is added to the kernel's output in place, on its diagonal only."""
    K = gram_kernel(spec, params, x, x)
    nv = params.noise_var
    if noise_scale is not None:
        nv = nv * noise_scale
    K.diagonal().add_(nv)
    return K
