"""Episodes of algp_tpu_torch on the fields this slice added, against
algp_tpu's on the CPU: the composite-kernel c2 field with a feature warp,
the c10 phenotype table, and a 3-trait field.  Both Agents run on the
same truth (`convert.field_env_like`) and fit from the reference's inits;
they sample the same sites at every step.  Also checkpoints with trait
rows, the ICM family's refusal and the CLI's new options."""

import dataclasses
import json

import numpy as np
import pytest

import jax

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
from algp_tpu_torch.models import multifit
from algp_tpu_torch.utils import checkpoint as ckpt
from test_torch_episode import (
    _configs, _plan_records, _reference_step_inits, _same_posterior)


def _reference_trait_inits(spec, cfg, seed, device):
    """The reference's end-of-episode trait-fit inits: make_restart_inits
    under PRNGKey(seed)."""
    jcfg = jc.FitConfig(**dataclasses.asdict(cfg))
    p = jgp.make_restart_inits(JKernelSpec(**dataclasses.asdict(spec)), jcfg,
                               jax.random.PRNGKey(seed))
    return kernel_params_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}, device)


def _shrunk(name, fit=None, field=None, **ep):
    """A preset of both packages with a smaller fit, field and episode."""
    out = []
    for mod in (jc, tc):
        base = mod.PRESETS[name]
        out.append(dataclasses.replace(
            base, fit=dataclasses.replace(base.fit, **(fit or {})),
            field=dataclasses.replace(base.field, **(field or {})),
            episode=dataclasses.replace(base.episode, **ep)))
    return out


def _same_sites(want, got, rel=1e-3):
    hj, ht = _plan_records(want.history), _plan_records(got.history)
    assert len(ht) == len(hj) >= 3
    for a, b in zip(hj, ht):
        assert (b["step"], b["n_sampled"]) == (a["step"], a["n_sampled"])
        assert b["rmse_test"] == pytest.approx(a["rmse_test"], rel=rel)
    np.testing.assert_array_equal(got.state.sampled_idx, want.state.sampled_idx)
    np.testing.assert_array_equal(got.state.noise_scale, want.state.noise_scale)
    assert got.rmse_test == pytest.approx(want.rmse_test, rel=rel)


# the c10_table episode sized as test_episode_golden.py sizes it (two
# restarts, not one); c2's runs at the same sizes on its own 25 × 40 field,
# so the two share the reference's compiled programs
C10_FIT = dict(iters=30, restarts=2)
C10_EPISODE = dict(num_pilot=12, budget=24.0, num_waypoints=4, samples_per_step=4)


def test_c2_composite_episode_matches_reference(monkeypatch):
    """A shrunk c2_composite_restarts episode (its 25 × 40 field with 3
    features, on the tanh-warped truth; 2 restarts × 30 Adam steps, 6
    steps) samples the reference Agent's sites step for step, its
    held-out RMSE within 1e-3 relative.  (L-BFGS is held step for step in
    test_torch_lbfgs.py.)"""
    monkeypatch.setattr(tgp, "step_inits", _reference_step_inits)
    jcfg, tcfg = _shrunk("c2_composite_restarts", fit=C10_FIT,
                         field=dict(feature_warp="tanh"), **C10_EPISODE)
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")
    assert tenv.X.shape == (1000, 5)
    want = JAgent(jenv, jcfg).run(max_steps=6)
    got = Agent(tenv, tcfg).run(max_steps=6)
    _same_sites(want, got)
    _same_posterior(want, got, tenv)


def test_c10_table_episode_matches_reference(monkeypatch):
    """The c10_table episode, sized as test_episode_golden.py's (30 Adam
    steps, 12 pilots, budget 24, 4 waypoints, 4 samples a step, 6 steps;
    two restarts): the reference Agent's sites step for step, both
    sensors."""
    monkeypatch.setattr(tgp, "step_inits", _reference_step_inits)
    jcfg, tcfg = _shrunk("c10_table", fit=C10_FIT, **C10_EPISODE)
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")
    want = JAgent(jenv, jcfg).run(max_steps=6)
    got = Agent(tenv, tcfg).run(max_steps=6)
    _same_sites(want, got)
    _same_posterior(want, got, tenv)
    scales = got.state.noise_scale
    assert (scales == 1.0).any() and (scales > 1.0).any()


def _trait_configs(frac):
    """`_configs("mi", "mixed")` (so the reference Agent's step programs
    are the ones test_episode_matches_reference compiled) on a 3-trait
    field: correlation 0.6, secondary traits measured at `frac` of the
    visits."""
    return [dataclasses.replace(c, field=dataclasses.replace(
        c.field, num_traits=3, trait_corr=0.6, trait_obs_frac=frac))
        for c in _configs("mi", "mixed")]


def test_multi_trait_episode_matches_reference(monkeypatch):
    """A 3-trait episode: every visit measures all traits, as the
    reference's, the same sites, and the end-of-episode per-trait RMSE
    (the batched fit; the per-trait fits where visits skipped traits are
    held in test_torch_multifit.py) within 2e-3 relative of the
    reference's."""
    frac = 1.0
    monkeypatch.setattr(tgp, "step_inits", _reference_step_inits)
    monkeypatch.setattr(multifit, "trait_inits", _reference_trait_inits)
    jcfg, tcfg = _trait_configs(frac)
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")
    want = JAgent(jenv, jcfg).run()
    got = Agent(tenv, tcfg).run()
    _same_sites(want, got)
    _same_posterior(want, got, tenv)
    st = got.state
    assert st.y_traits.shape == (len(st.sampled_idx), 3)
    np.testing.assert_array_equal(st.y_traits[:, 0], st.y)
    np.testing.assert_array_equal(np.isnan(st.y_traits), np.isnan(want.state.y_traits))
    np.testing.assert_allclose(np.nan_to_num(st.y_traits),
                               np.nan_to_num(want.state.y_traits), rtol=1e-6)
    assert not np.isnan(st.y_traits).any()
    np.testing.assert_allclose(got.trait_rmse, want.trait_rmse, rtol=2e-3)
    np.testing.assert_allclose(got.trait_rmse_test, want.trait_rmse_test, rtol=2e-3)
    assert any(h["phase"] == "traits" for h in got.history)


def test_multi_trait_checkpoint_resumes_exactly(tmp_path):
    """A checkpoint with y_traits saves, loads and resumes to the
    uninterrupted run's sites, trait rows and trait RMSE."""
    _, cfg = _trait_configs(0.5)
    env = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    full = Agent(field_env_like(env, "cpu"), cfg).run()
    half = Agent(field_env_like(env, "cpu"), cfg).run(max_steps=2)
    path = str(tmp_path / "mt.npz")
    ckpt.save(path, half.state)
    loaded = ckpt.load(path, "cpu")
    np.testing.assert_array_equal(loaded.y_traits, half.state.y_traits)
    resumed = Agent(field_env_like(env, "cpu"), cfg).run(resume_from=loaded)
    np.testing.assert_array_equal(resumed.state.sampled_idx, full.state.sampled_idx)
    np.testing.assert_array_equal(resumed.state.y_traits, full.state.y_traits)
    assert resumed.trait_rmse == pytest.approx(full.trait_rmse, abs=1e-6)


def test_resume_with_a_trait_mismatch_raises(tmp_path):
    _, cfg3 = _trait_configs(1.0)
    cfg1 = dataclasses.replace(cfg3, field=dataclasses.replace(cfg3.field, num_traits=1))
    path = str(tmp_path / "st.npz")
    for write, read in ((cfg1, cfg3), (cfg3, cfg1)):
        half = Agent(FieldEnv(write.field, write.kernel, device="cpu"), write).run(
            max_steps=1)
        ckpt.save(path, half.state)
        agent = Agent(FieldEnv(read.field, read.kernel, device="cpu"), read)
        with pytest.raises(ValueError, match="trait mismatch"):
            agent.run(resume_from=ckpt.load(path, "cpu"))


def test_icm_family_raises_at_the_agent_and_the_cli(capsys):
    """Since the ICM is ported only an unknown family raises (ValueError at
    the Agent); multi_fit='icm' builds the Agent on a multi-trait field and
    runs through the CLI to per-trait RMSEs."""
    _, cfg = _trait_configs(1.0)
    cfg = dataclasses.replace(cfg, fit=dataclasses.replace(cfg.fit, multi_fit="icm"))
    env = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    assert Agent(env, cfg)._multi_trait
    assert cli.main(["--preset", "c5_episode", "--rows", "4", "--cols", "5",
                     "--budget", "6", "--num-pilot", "6", "--iters", "5",
                     "--num-traits", "2", "--multi-fit", "icm", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rec["trait_rmse_test"]) == 2 and np.isfinite(rec["trait_rmse_test"]).all()
    bogus = dataclasses.replace(cfg, fit=dataclasses.replace(cfg.fit, multi_fit="bogus"))
    with pytest.raises(ValueError, match="multi_fit"):
        Agent(env, bogus)


def test_cli_runs_the_new_field_options_on_the_cpu(tmp_path, capsys):
    """The c2 preset with L-BFGS and a warp, the 3-trait table, and greedy
    mode's per-trait evaluation through cli.main."""
    small = ["--num-pilot", "8", "--iters", "6", "--restarts", "2", "--device", "cpu"]
    assert cli.main(["--preset", "c2_composite_restarts", "--rows", "6", "--cols", "8",
                     "--budget", "10", "--optimizer", "lbfgs", "--feature-warp", "sin",
                     *small]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["steps"] >= 1 and "trait_rmse_test" not in rec
    state = tmp_path / "t.npz"
    assert cli.main(["--preset", "c10_table", "--value-cols", "height,width,stand_count",
                     "--budget", "10", "--checkpoint", str(state), *small]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rec["trait_rmse_test"]) == 3 and np.isfinite(rec["trait_rmse_test"]).all()
    assert ckpt.load(str(state), "cpu").y_traits.shape[1] == 3
    assert cli.main(["--mode", "greedy", "--strategy", "entropy", "--rows", "5",
                     "--cols", "8", "--acq-rounds", "6", "--num-traits", "3",
                     "--trait-obs-frac", "0.5", "--trait-corr", "0.5", *small]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["multi_fit"] == "independent" and len(rec["trait_rmse"]) == 3
    assert np.isfinite(rec["trait_rmse"]).all()
