"""Deep-kernel episodes of algp_tpu_torch against algp_tpu's on the CPU:
the same sites step for step from the reference's MLP and restart inits,
checkpoint / resume of the embedding (the port's own checkpoints and the
reference's), and the CLI's deep-kernel flags."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from algp_tpu import config as jc
from algp_tpu.episode import Agent as JAgent
from algp_tpu.field import FieldEnv as JFieldEnv
from algp_tpu.ops.kernels import KernelSpec as JKernelSpec
from algp_tpu.utils import checkpoint as jckpt
from algp_tpu_torch import cli
from algp_tpu_torch import config as tc
from algp_tpu_torch.convert import field_env_like
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.field import FieldEnv
from algp_tpu_torch.models import networks as tnets
from algp_tpu_torch.ops.kernels import KernelSpec
from algp_tpu_torch.utils import checkpoint as ckpt
from test_torch_episode import _plan_records, _same_posterior
from test_torch_episode_fields import _same_sites
from test_torch_networks import reference_deep_inits


def _reference_deep_step_inits(kspec, mspec, cfg, seed, step, device):
    """The reference Agent's deep refit inits at `step`: fit_deep under
    fold_in(PRNGKey(seed), step)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.asarray(step, jnp.uint32))
    mlp0, kinits = reference_deep_inits(kspec, mspec, cfg, key)
    return [(W.to(device), b.to(device)) for W, b in mlp0], kinits.map(lambda a: a.to(device))


def _deep_configs():
    """A composite-kernel field with 3 features (8 × 12), a 6-wide hidden
    layer embedding to 2, 2 restarts × 10 Adam steps, refits every 2
    steps; both packages' configs."""
    def build(mod, KS):
        return mod.ExperimentConfig(
            kernel=KS("matern52", "rbf", ds=2, df=3),
            field=mod.FieldConfig(num_rows=8, num_cols=12, num_features=3, seed=3),
            fit=mod.FitConfig(iters=10, restarts=2),
            acquisition=mod.AcquisitionConfig(strategy="mi"),
            episode=mod.EpisodeConfig(num_pilot=8, budget=24.0, refit_every=2, seed=3),
            deep=mod.MLPSpec(hidden=(6,), out=2),
        )
    return build(jc, JKernelSpec), build(tc, KernelSpec)


def test_deep_episode_matches_reference(monkeypatch):
    """The port's deep-kernel episode samples the reference's sites step
    for step (held-out RMSE within 1e-3 relative); every refit re-embeds
    the candidates, and the state carries the last refit's weights."""
    monkeypatch.setattr(tnets, "step_inits", _reference_deep_step_inits)
    jcfg, tcfg = _deep_configs()
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")
    want = JAgent(jenv, jcfg).run()
    agent = Agent(tenv, tcfg)
    got = agent.run()
    _same_sites(want, got)
    _same_posterior(want, got, tenv)
    assert agent.spec == KernelSpec("matern52", "rbf", ds=2, df=2)
    assert agent._Xdev.shape == (96, 4)
    np.testing.assert_allclose(
        agent._Xdev.numpy(),
        tnets.embed_inputs(tcfg.deep, got.state.mlp, tenv.X, 2).numpy(), rtol=0, atol=0)
    for (W, _), (jW, _) in zip(got.state.mlp, want.state.mlp):
        np.testing.assert_allclose(W.numpy(), np.asarray(jW), atol=1e-3)


def test_deep_checkpoint_resumes_exactly(tmp_path):
    """A deep episode's checkpoint (params and MLP weights) loads and
    resumes to the uninterrupted run's sites and metrics."""
    _, cfg = _deep_configs()
    env = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    full = Agent(field_env_like(env, "cpu"), cfg).run()
    half = Agent(field_env_like(env, "cpu"), cfg).run(max_steps=2)
    path = str(tmp_path / "deep.npz")
    ckpt.save(path, half.state)
    loaded = ckpt.load(path, "cpu")
    assert len(loaded.mlp) == 2
    for (W, b), (W0, b0) in zip(loaded.mlp, half.state.mlp):
        assert torch.equal(W, W0) and torch.equal(b, b0)
    resumed = Agent(field_env_like(env, "cpu"), cfg).run(resume_from=loaded)
    np.testing.assert_array_equal(resumed.state.sampled_idx, full.state.sampled_idx)
    assert resumed.rmse_test == pytest.approx(full.rmse_test, abs=1e-6)


def test_reference_deep_checkpoint_loads_and_resumes_in_the_port(tmp_path, monkeypatch):
    """A checkpoint the reference writes mid-episode (its `mlp_*` blobs)
    loads in the port with the same weights, and both packages resumed
    from it sample the same sites."""
    monkeypatch.setattr(tnets, "step_inits", _reference_deep_step_inits)
    jcfg, tcfg = _deep_configs()
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")
    half = JAgent(jenv, jcfg).run(max_steps=2)
    path = str(tmp_path / "ref.npz")
    jckpt.save(path, half.state)
    loaded = ckpt.load(path, "cpu")
    for (W, b), (jW, jb) in zip(loaded.mlp, half.state.mlp):
        np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(loaded.params.log_ls_feature.numpy(),
                                  np.asarray(half.state.params.log_ls_feature))
    want = JAgent(JFieldEnv(jcfg.field, jcfg.kernel), jcfg).run(
        resume_from=jckpt.load(path))
    got = Agent(tenv, tcfg).run(resume_from=loaded)
    hj, ht = _plan_records(want.history), _plan_records(got.history)
    assert [h["n_sampled"] for h in ht] == [h["n_sampled"] for h in hj]
    np.testing.assert_array_equal(got.state.sampled_idx, want.state.sampled_idx)


def test_deep_kernel_without_features_raises():
    """As the reference's Agent, the port's refuses a deep kernel on a
    field without feature columns."""
    _, cfg = _deep_configs()
    cfg = dataclasses.replace(cfg, kernel=KernelSpec("matern52", ds=2),
                              field=dataclasses.replace(cfg.field, num_features=0))
    env = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    with pytest.raises(ValueError, match="feature dims"):
        Agent(env, cfg)


def test_cli_runs_the_deep_kernel_on_the_cpu(tmp_path, capsys):
    """--deep-hidden / --deep-out through cli.main: the greedy run embeds
    then selects (a 3-trait field, ICM at the end), the episode writes a
    checkpoint with the weights and resumes from it; without features the
    flag is refused, as the reference refuses it."""
    small = ["--preset", "c2_composite_restarts", "--rows", "6", "--cols", "8",
             "--num-pilot", "8", "--iters", "6", "--restarts", "2",
             "--deep-hidden", "6", "--deep-out", "2", "--device", "cpu"]
    assert cli.main([*small, "--mode", "greedy", "--acq-rounds", "5", "--num-traits", "3",
                     "--trait-obs-frac", "0.5", "--multi-fit", "icm"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_sampled"] == 8 + 5 and rec["multi_fit"] == "icm"
    assert np.isfinite([rec["final_rmse"], *rec["trait_rmse_test"]]).all()
    state = tmp_path / "d.npz"
    assert cli.main([*small, "--budget", "10", "--checkpoint", str(state)]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    st = ckpt.load(str(state), "cpu")
    assert [tuple(W.shape) for W, _ in st.mlp] == [(3, 6), (6, 2)]
    assert cli.main([*small, "--budget", "10", "--resume", str(state)]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["n_sampled"] == first["n_sampled"] and np.isfinite(again["final_rmse"])
    with pytest.raises(SystemExit, match="feature dims"):
        cli.main(["--preset", "c5_episode", "--deep-hidden", "8", "--device", "cpu"])
