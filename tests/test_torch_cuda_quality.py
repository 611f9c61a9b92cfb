"""The deep-kernel c2 episode's final posterior on the card against the
same run on the CPU, within the bounds the CPU tests hold the port to
against the reference (`posterior_parity.same_posterior`).

Both runs start from the same draws made on the host (`chip_smoke.
quality_run`): the 25 × 40 field with its tanh-warped features and
sensing noise, every fit's inits from the port's CPU generators.  The
joint MLP fit is chaotic in f32, so the CPU run replays the card's deep
fits; what differs is the card's arithmetic (the Gram kernels, cuSOLVER,
reduction order) on the same sites.

This needs an NVIDIA GPU and nvcc and skips without one.  It imports no
JAX, so run it on the card without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_quality.py -q
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from posterior_parity import same_posterior

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_deep_episode_variance_on_the_card_matches_the_cpu(dev):
    from algp_tpu_torch.field import FieldEnv
    from algp_tpu_torch.ops import gram as G

    smoke = _chip_smoke()
    (tag, cfg, steps), = [c for c in smoke.quality_cases() if c[0] == "deep_c2"]
    base = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    fits = []
    launches = G.COMPOSITE_LAUNCHES
    card, env, _, _ = smoke.quality_run(cfg, base, dev, steps, fits)
    assert G.COMPOSITE_LAUNCHES > launches  # the composite Gram kernel ran
    cpu, _, _, _ = smoke.quality_run(cfg, base, "cpu", steps, fits)
    assert len(fits) == card.state.step + 1  # a refit every step, each replayed
    np.testing.assert_array_equal(card.state.sampled_idx, cpu.state.sampled_idx)
    same_posterior(cpu, card, env, tag, names=("cpu", "card"))
