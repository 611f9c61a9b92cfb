"""Shared fixtures of the benchmark's own tests (CPU unless marked cuda)."""

import json
from pathlib import Path

import pytest
import torch

SMALL_DIR = Path(__file__).resolve().parent / "small"


def small_config(config_name: str) -> dict:
    """The keys that cut a configuration to a size a CPU test holds:
    `small/<config>.json`, one file a configuration."""
    return json.loads((SMALL_DIR / f"{config_name}.json").read_text())


def small(manifest, cell_name: str) -> dict:
    """The cut of the cell's configuration."""
    from portbench import harness

    return small_config(harness.cell(manifest, cell_name)["config"])


@pytest.fixture
def one_thread():
    """Small references on one thread: torch's intra-op threads spin on a
    busy host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
