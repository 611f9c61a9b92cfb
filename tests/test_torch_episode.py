"""The config-5 episode of algp_tpu_torch against algp_tpu's, on the CPU.

Both Agents run on the same field truth (carried across by
`convert.field_env_like`) and fit from the reference's restart inits (the
port's own come from a torch generator seeded by (seed, step), which
cannot reproduce JAX's fold_in keys).  They must sample the same sites at
every step, with per-step RMSE within 1e-3 relative."""

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
from algp_tpu.models import gp as jgp
from algp_tpu.ops.kernels import KernelSpec as JKernelSpec
from algp_tpu_torch import cli
from algp_tpu_torch import config as tc
from algp_tpu_torch.convert import field_env_like, kernel_params_from_numpy
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.field import FieldEnv
from algp_tpu_torch.models import gp as tgp
from algp_tpu_torch.ops import gram as tgram
from algp_tpu_torch.ops.kernels import KernelSpec
from algp_tpu_torch.utils import checkpoint as ckpt
from posterior_parity import same_posterior as _same_posterior


def _reference_step_inits(spec, cfg, seed, step, device):
    """The reference's inits of the fit at `step`: make_restart_inits under
    fold_in(PRNGKey(seed), step), as its Agent derives them."""
    jcfg = jc.FitConfig(**dataclasses.asdict(cfg))
    key = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.asarray(step, jnp.uint32))
    p = jgp.make_restart_inits(JKernelSpec(**dataclasses.asdict(spec)), jcfg, key)
    return kernel_params_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)},
        device)


def _configs(strategy, modality="precise", **ep):
    def build(mod, KS):
        return mod.ExperimentConfig(
            kernel=KS("matern32", ds=2),
            field=mod.FieldConfig(num_rows=8, num_cols=12, seed=3),
            fit=mod.FitConfig(iters=10, restarts=2, refit_iters=5, refit_restarts=2),
            acquisition=mod.AcquisitionConfig(strategy=strategy),
            episode=mod.EpisodeConfig(**{**dict(
                num_pilot=8, budget=24.0, refit_every=2, seed=3, modality=modality),
                **ep}),
        )
    return build(jc, JKernelSpec), build(tc, KernelSpec)


def _plan_records(history):
    return [h for h in history if h["phase"] in ("pilot", "plan")]


@pytest.mark.parametrize("strategy,modality", [
    ("mi", "precise"), ("entropy", "precise"), ("uniform", "precise"),
    ("naive", "precise"), ("mi", "mixed"),
])
def test_episode_matches_reference(monkeypatch, strategy, modality):
    monkeypatch.setattr(tgp, "step_inits", _reference_step_inits)
    jcfg, tcfg = _configs(strategy, modality)
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")
    want = JAgent(jenv, jcfg).run()
    launches = tgram.LAUNCHES
    got = Agent(tenv, tcfg).run()
    assert tgram.LAUNCHES == launches  # the CPU runs the plain Gram

    hj, ht = _plan_records(want.history), _plan_records(got.history)
    assert len(ht) == len(hj) >= 3
    for a, b in zip(hj, ht):  # the same sites at every step
        assert (b["step"], b["n_sampled"]) == (a["step"], a["n_sampled"])
        assert b["rmse"] == pytest.approx(a["rmse"], rel=1e-3)
        assert b["rmse_test"] == pytest.approx(a["rmse_test"], rel=1e-3)
    np.testing.assert_array_equal(got.state.sampled_idx, want.state.sampled_idx)
    np.testing.assert_array_equal(got.state.noise_scale, want.state.noise_scale)
    np.testing.assert_allclose(got.state.y, want.state.y, rtol=1e-6)
    assert got.state.budget_left == pytest.approx(want.state.budget_left)
    assert got.rmse == pytest.approx(want.rmse, rel=1e-3)
    for k, v in want.calibration.items():
        assert got.calibration[k] == pytest.approx(v, rel=1e-2, abs=1e-3), k
    _same_posterior(want, got, tenv, f"{strategy}/{modality}")


def test_resume_from_checkpoint_continues_exactly(tmp_path):
    _, cfg = _configs("mi", num_pilot=6, budget=30.0, num_waypoints=5,
                      samples_per_step=4, seed=2)
    env = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    full = Agent(field_env_like(env, "cpu"), cfg).run(max_steps=8)
    half = Agent(field_env_like(env, "cpu"), cfg).run(max_steps=3)
    path = str(tmp_path / "mid.npz")
    ckpt.save(path, half.state)
    resumed = Agent(field_env_like(env, "cpu"), cfg).run(
        max_steps=8, resume_from=ckpt.load(path, "cpu"))
    np.testing.assert_array_equal(resumed.state.sampled_idx, full.state.sampled_idx)
    assert resumed.rmse == pytest.approx(full.rmse, abs=1e-6)


def test_cli_runs_the_episode_and_greedy_modes_on_the_cpu(tmp_path, capsys):
    small = ["--rows", "6", "--cols", "8", "--num-pilot", "6", "--iters", "5",
             "--device", "cpu"]
    metrics, state = tmp_path / "m.jsonl", tmp_path / "state.npz"
    assert cli.main(["--preset", "c5_episode", "--budget", "12", *small,
                     "--metrics-jsonl", str(metrics), "--checkpoint", str(state)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] >= 1 and np.isfinite(summary["final_rmse_test"])
    history = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert history[0]["phase"] == "pilot" and history[-1]["phase"] == "calibration"
    assert ckpt.load(str(state), "cpu").step == summary["steps"]

    assert cli.main(["--preset", "c3_entropy", "--mode", "greedy",
                     "--acq-rounds", "5", *small]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_sampled"] == 6 + 5 and np.isfinite(rec["final_rmse"])


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs("mi")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FieldEnv(cfg.field, cfg.kernel)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--preset", "c5_episode", "--rows", "4", "--cols", "5"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FieldEnv(cfg.field, cfg.kernel, device="cuda")


_DEEP = dict(kernel=KernelSpec("matern32", ds=2, df=3), deep=tc.MLPSpec(hidden=(4,), out=2))


@pytest.mark.parametrize("change", [
    dict(_DEEP, episode=tc.EpisodeConfig(num_pilot=8, budget=24.0, lagged_refit=True)),
    dict(_DEEP, fit=tc.FitConfig(sparse_threshold=300, sparse_inducing=256)),
])
def test_unported_branches_raise(change):
    """The deep kernel is ported; the combinations the reference refuses
    raise its ValueError at the Agent: with lagged refits and with SGPR
    refits (a field without features: test_torch_episode_deep.py)."""
    _, cfg = _configs("mi")
    cfg = dataclasses.replace(cfg, **change)
    cfg = dataclasses.replace(cfg, field=dataclasses.replace(
        cfg.field, num_features=cfg.kernel.df))
    env = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    with pytest.raises(ValueError, match="deep"):
        Agent(env, cfg)


@pytest.mark.parametrize("strategy,num_inducing", [("entropy", None), ("mi", 32)])
def test_ensemble_branches_equal_the_reference(strategy, num_inducing):
    """mi_ensemble = 2 constructs as the reference's Agent does: the same
    planner, and for the low-rank one the same two designs."""
    jcfg, cfg = _configs("mi")
    jcfg = dataclasses.replace(jcfg, acquisition=jc.AcquisitionConfig(
        strategy=strategy, num_inducing=num_inducing, mi_ensemble=2))
    cfg = dataclasses.replace(cfg, acquisition=tc.AcquisitionConfig(
        strategy=strategy, num_inducing=num_inducing, mi_ensemble=2))
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    ref, got = JAgent(jenv, jcfg), Agent(field_env_like(jenv, "cpu"), cfg)
    for k in ("_strategy", "_num_inducing", "_mi_ensemble", "_max_samples"):
        assert getattr(got, k) == getattr(ref, k), k
    if num_inducing:
        z = got._lowrank_z()
        assert z.shape == (2, 32, 2)
        np.testing.assert_array_equal(z.numpy(), np.asarray(ref._lowrank_z()))


@pytest.mark.parametrize("change,error", [
    (dict(acquisition=tc.AcquisitionConfig(strategy="mi", num_inducing=32)), None),
    (dict(fit=tc.FitConfig(sparse_threshold=50)), ValueError),
    (dict(fit=tc.FitConfig(sparse_threshold=50, sparse_inducing=50)), None),
])
def test_scale_branches_are_ported(change, error):
    """The low-rank planner and SGPR refits construct; a sparse threshold
    below the inducing count (the default 256) is refused, as the
    reference refuses it."""
    _, cfg = _configs("mi")
    env = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    if error is not None:
        with pytest.raises(error, match="sparse_threshold"):
            Agent(env, dataclasses.replace(cfg, **change))
    else:
        Agent(env, dataclasses.replace(cfg, **change))


def test_presets_equal_the_reference():
    for name, cfg in tc.PRESETS.items():
        ref = jc.PRESETS[name]
        for part in ("kernel", "fit", "acquisition", "field", "episode"):
            mine = dataclasses.asdict(getattr(cfg, part))
            theirs = dataclasses.asdict(getattr(ref, part))
            assert mine == {k: theirs[k] for k in mine}, (name, part)
    assert tc.resolve_num_inducing(None, 10_000) == 0
    assert tc.resolve_num_inducing(None, 140 * 140) == 1024
    assert {"c5_10k", "c5_episode", "c5_20k", "c5_100k", "c5_long", "c5_1m",
            "c5_4m", "c5_1m_long"} <= set(tc.PRESETS)
    # the table preset is offered, equal to the reference's (the loop
    # above), reading the same CSV
    assert "c10_table" in tc.PRESETS
    assert tc.PRESETS["c10_table"].field.data_path == jc.PRESETS["c10_table"].field.data_path
