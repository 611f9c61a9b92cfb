"""The mesh episode (`episode.Agent(mesh=)`) on the card: a world of one
NCCL rank, started by `algp_tpu_torch.parallel.launch`, samples the
single-card Agent's sites index for index, and its plan steps and seeds
launch the Gram kernel.

Needs an NVIDIA GPU and nvcc and skips without one; imports no JAX, so
run it on the card's machine without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_mesh_episode.py -q
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from algp_tpu_torch.config import PRESETS
from algp_tpu_torch.convert import field_env_attrs, field_env_like
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.field import FieldEnv
from algp_tpu_torch.ops import gram as G
from algp_tpu_torch.parallel import launch

pytestmark = pytest.mark.cuda

JOBS = str(Path(__file__).resolve().parent / "torch_mesh_episode_jobs.py") + ":run_cases"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("num_inducing,device_metrics", [(0, False), (24, True)],
                         ids=["exact", "lowrank"])
def test_nccl_mesh_episode_samples_the_single_card_sites(dev, num_inducing, device_metrics):
    base = PRESETS["c5_episode"]
    cfg = dataclasses.replace(
        base, field=dataclasses.replace(base.field, num_rows=8, num_cols=12, seed=3),
        acquisition=dataclasses.replace(base.acquisition, strategy="mi",
                                        num_inducing=num_inducing),
        episode=dataclasses.replace(base.episode, num_pilot=10, budget=30.0,
                                    samples_per_step=5, refit_every=2,
                                    device_metrics=device_metrics, seed=1))
    env = FieldEnv(cfg.field, cfg.kernel, device=dev)
    case = ("episode", 1, dict(cfg=cfg, env=field_env_attrs(env), max_steps=4))
    out, = launch.run(JOBS, 1, backend="nccl", device="cuda", timeout=300,
                      kwargs={"cases": {"e": case}, "device": "cuda"})
    before = G.LAUNCHES
    want = Agent(field_env_like(env, dev), cfg).run(max_steps=4)
    assert G.LAUNCHES > before  # the single card's steps run the kernel too
    np.testing.assert_array_equal(out["e/sites"], want.state.sampled_idx)
    assert int(out["e/gram_launches"]) >= len(out["e/steps"])  # one a plan step at least
