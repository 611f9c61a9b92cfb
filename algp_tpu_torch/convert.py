"""KernelParams to and from numpy mappings keyed by the field names.

The reference's `KernelParams` has the same field names, so a test hands
the reference's parameters (or its `make_restart_inits` output, with a
leading restart axis) to the port as
`{f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from algp_tpu_torch.ops.kernels import KernelParams

_NAMES = tuple(f.name for f in dataclasses.fields(KernelParams))


def kernel_params_from_numpy(mapping: Mapping, device="cpu") -> KernelParams:
    """f32 tensors on `device` from a mapping of the KernelParams fields."""
    missing = set(_NAMES) - set(mapping)
    if missing:
        raise KeyError(f"missing KernelParams fields: {sorted(missing)}")
    return KernelParams(**{
        name: torch.tensor(np.asarray(mapping[name], np.float32), device=device)
        for name in _NAMES
    })


def kernel_params_to_numpy(params: KernelParams) -> dict:
    """{field name: f32 numpy array} of a KernelParams."""
    return {
        name: getattr(params, name).detach().cpu().numpy() for name in _NAMES
    }
