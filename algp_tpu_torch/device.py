"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` when given, else the current CUDA card.  Without a card,
    raises unless the caller passed the CPU: nothing moves to the CPU on
    its own."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but CUDA is not available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: algp_tpu_torch runs on the card by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
