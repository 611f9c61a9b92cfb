"""The mesh episode of algp_tpu_torch (`parallel.sharded_episode`,
`episode.Agent(mesh=)`) on the CPU, against the JAX package and against the
port's single-rank Agent.

One world of four gloo ranks is started once for the module by
`algp_tpu_torch.parallel.launch`; its ranks run tests/torch_mesh_episode_jobs.py
(no JAX) on a 2 × 2 and a 1 × 4 mesh while this process computes what each
case is held to:
  * the JAX single-device `Agent` (exact-W and low-rank MI), both packages
    fitting from the reference's inits on the reference's env;
  * twins of the reference's mesh-episode tests (tests/test_sharded.py:318-460)
    against the port's single-rank Agent, at their sizes and tolerances;
  * twins of tests/test_sharded_residency.py: the seeds and the step's
    fields are held at N/S rows a rank;
  * the dry run's episode blocks (`parallel.dryrun.episode_checks`).
A rank waiting on a collective that never completes raises after its
process group's 60 s timeout; a world that outlives DEADLINE is killed."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from algp_tpu import acquisition_lowrank as jlr
from algp_tpu import config as jc
from algp_tpu.episode import Agent as JAgent
from algp_tpu.field import FieldEnv as JFieldEnv
from algp_tpu.models import gp as jgp
from algp_tpu.ops.kernels import KernelSpec as JKernelSpec
from algp_tpu_torch import acquisition as tacq
from algp_tpu_torch import config as tc
from algp_tpu_torch.convert import field_env_attrs, field_env_like
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.field import FieldEnv
from algp_tpu_torch.ops.kernels import KernelSpec
from algp_tpu_torch.parallel import launch

JOBS = str(Path(__file__).resolve().parent / "torch_mesh_episode_jobs.py") + ":run_cases"
WORLD = 4
DEADLINE = 300.0  # s for the world's start-up and all its cases, on a loaded host
MESH, GRID = 2, 1  # the cases' restarts axes: 2 × 2 (`make_mesh()`) and 1 × 4
JSPEC = JKernelSpec("rbf", ds=2)


def _np(p) -> dict:
    return {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}


# ---------------------------------------------------------------------------
# (a) against the JAX Agent
# ---------------------------------------------------------------------------


def _jax_configs(num_inducing: int, device_metrics: bool):
    """tests/test_torch_episode.py's MI episode with the given planner, in
    both packages."""
    def build(mod, KS):
        return mod.ExperimentConfig(
            kernel=KS("matern32", ds=2),
            field=mod.FieldConfig(num_rows=8, num_cols=12, seed=3),
            fit=mod.FitConfig(iters=10, restarts=2, refit_iters=5, refit_restarts=2),
            acquisition=mod.AcquisitionConfig(strategy="mi", num_inducing=num_inducing),
            episode=mod.EpisodeConfig(num_pilot=8, budget=24.0, refit_every=2, seed=3,
                                      device_metrics=device_metrics))
    return build(jc, JKernelSpec), build(tc, KernelSpec)


def _reference_inits(jcfg, steps: int) -> dict:
    """The reference Agent's fit inits, by (step, restarts): make_restart_inits
    under fold_in(PRNGKey(seed), step), the full fit's at step 0, the warm
    refit's after."""
    out = {}
    fit, seed = jcfg.fit, jcfg.episode.seed
    rfit = dataclasses.replace(fit, iters=fit.refit_iters, restarts=fit.refit_restarts)
    for step in range(steps + 1):
        cfg = fit if step == 0 else rfit
        key = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.asarray(step, jnp.uint32))
        out[(step, cfg.restarts)] = _np(jgp.make_restart_inits(jcfg.kernel, cfg, key))
    return out


JAX_CASES = {"jax_exact": (0, False), "jax_lowrank": (24, True)}
JAX_STEPS = 6


def _jax_inputs(cases: dict, ref: dict) -> None:
    for name, (m, dm) in JAX_CASES.items():
        jcfg, tcfg = _jax_configs(m, dm)
        jenv = JFieldEnv(jcfg.field, jcfg.kernel)
        cases[name] = ("episode", GRID, dict(
            cfg=tcfg, env=field_env_attrs(jenv), max_steps=JAX_STEPS,
            inits=_reference_inits(jcfg, JAX_STEPS)))
        ref[name] = lambda jenv=jenv, jcfg=jcfg: JAgent(jenv, jcfg).run(max_steps=JAX_STEPS)


# ---------------------------------------------------------------------------
# (b) twins of tests/test_sharded.py's mesh-episode tests, (d) the dry run
# ---------------------------------------------------------------------------


def _episode_cfg(strategy, num_inducing, device_metrics, modality="precise",
                 path_utility="per_cost", mi_ensemble=1):
    """tests/test_sharded.py's `_episode_cfg`, in the port's config."""
    base = tc.PRESETS["c5_episode"]
    return dataclasses.replace(
        base, field=dataclasses.replace(base.field, num_rows=8, num_cols=12, seed=3),
        acquisition=dataclasses.replace(base.acquisition, strategy=strategy,
                                        num_inducing=num_inducing, path_utility=path_utility,
                                        mi_ensemble=mi_ensemble),
        episode=dataclasses.replace(base.episode, num_pilot=10, budget=30.0,
                                    samples_per_step=5, refit_every=2,
                                    device_metrics=device_metrics, modality=modality, seed=1))


TWINS = {  # name: (config args, steps, COND_MATMUL_N or None)
    "exact": (("mi", 0, False), 4, None),
    "lowrank": (("mi", 24, True), 4, None),
    "entropy": (("entropy", 0, True), 4, None),
    "per_sample": (("mi", 24, True, "precise", "per_sample"), 4, None),
    "mixed": (("mi", 24, True, "mixed"), 3, None),
    "ensemble": (("mi", 24, True, "precise", "per_cost", 3), 4, None),
    "gate_lowrank": (("mi", 24, True), 4, 1),
    "gate_exact": (("mi", 0, False), 3, 1),
    "residency_agent": (("mi", 24, True), 3, None),
}


def _single_rank(cfg, env, steps: int, gate):
    """The port's single-rank Agent on a copy of `env`, the conditioning
    gate set to `gate` where given."""
    saved = tacq.COND_MATMUL_N
    tacq.COND_MATMUL_N = saved if gate is None else gate
    try:
        return Agent(field_env_like(env, "cpu"), cfg).run(max_steps=steps)
    finally:
        tacq.COND_MATMUL_N = saved


def _twin_inputs(cases: dict, ref: dict) -> None:
    for name, (args, steps, gate) in TWINS.items():
        cfg = _episode_cfg(*args)
        env = FieldEnv(cfg.field, cfg.kernel, device="cpu")
        c = dict(cfg=cfg, env=field_env_attrs(env), max_steps=steps)
        if gate is not None:
            c["cond_matmul_n"] = gate
        cases[name] = ("episode", MESH, c)
        ref[name] = lambda cfg=cfg, env=env, steps=steps, gate=gate: _single_rank(
            cfg, env, steps, gate)


def _step_inputs(cases: dict, ref: dict) -> None:
    """tests/test_sharded.py:366: one low-rank plan step on the 2 × 2 mesh
    against the JAX `plan_episode_step_lowrank`."""
    rng = np.random.default_rng(0)
    params = JSPEC.init_params(ls_spatial=2.0, outputscale=1.3, noise=0.12)
    n, cap, S_sets, k = 220, 16, 12, 5
    x = rng.uniform(0, 11, (n, 2)).astype(np.float32)
    idx = rng.choice(n, 10, replace=False)
    c = dict(params=_np(params), x=x, idx_pad=np.pad(idx, (0, cap - 10)), count=10,
             ns_pad=np.pad(rng.uniform(1.0, 4.0, 10).astype(np.float32), (0, cap - 10),
                           constant_values=1.0),
             y_pad=np.pad(rng.standard_normal(10).astype(np.float32), (0, cap - 10)),
             sets=rng.integers(0, n, (S_sets, k)), sizes=rng.integers(1, k + 1, S_sets),
             costs=rng.uniform(2.0, 6.0, S_sets).astype(np.float32))
    c["z"] = x[np.asarray(jlr.kcenter_indices(jnp.asarray(x), 32))]
    cases["step"] = ("step", MESH, c)

    def want():
        xj = jnp.asarray(x)
        lr1 = jlr.lowrank_seed_with_z(JSPEC, params, xj, jnp.asarray(c["z"]))
        return jlr.plan_episode_step_lowrank(
            JSPEC, params, xj, jnp.asarray(c["idx_pad"], jnp.int32), jnp.asarray(10, jnp.int32),
            jnp.asarray(c["ns_pad"]), jnp.asarray(c["y_pad"]),
            jnp.asarray(c["sets"], jnp.int32), jnp.asarray(c["sizes"], jnp.int32),
            jnp.asarray(c["costs"]), lr1)

    ref["step"] = want


# ---------------------------------------------------------------------------
# (c) twins of tests/test_sharded_residency.py
# ---------------------------------------------------------------------------


def _residency_inputs(cases: dict) -> None:
    rng = np.random.default_rng(1)
    p = _np(JSPEC.init_params(ls_spatial=2.0, outputscale=1.2, noise=0.15))
    cases["w_seed"] = ("w_seed", GRID, dict(params=p, x=rng.uniform(0, 40, (2048, 2))))
    p = _np(JSPEC.init_params(ls_spatial=6.0, outputscale=1.0, noise=0.1))
    N, M, cap, P, k = 32768, 64, 32, 8, 4
    x = rng.uniform(0, 180, (N, 2)).astype(np.float32)
    z = x[np.linspace(0, N - 1, M).round().astype(np.int64)]
    cases["lr_seed"] = ("lr_seed", GRID, dict(params=p, x=x, z=z))
    sampled = rng.choice(N, 12, replace=False)
    cases["step_fields"] = ("step", GRID, dict(
        params=p, x=x, z=z, idx_pad=np.pad(sampled, (0, cap - 12)), count=12,
        ns_pad=np.ones(cap, np.float32),
        y_pad=np.pad(rng.standard_normal(12).astype(np.float32), (0, cap - 12)),
        sets=rng.integers(0, N, (P, k)), sizes=np.full(P, k),
        costs=rng.uniform(2, 9, P).astype(np.float32)))
    N, M, K = 8192, 32, 3
    x = rng.uniform(0, 90, (N, 2)).astype(np.float32)
    z = np.stack([x[np.linspace(j, N - 1, M).round().astype(np.int64)] for j in range(K)])
    cases["ens_seed"] = ("lr_seed", GRID, dict(params=p, x=x, z=z))


DRYRUN = ("exact", "lowrank", "ensemble", "traits_lagged", "traits_icm")


@dataclasses.dataclass
class Runs:
    outs: list  # the world's outputs, by rank
    want: dict  # what each case is held to, by case
    inputs: dict  # the cases' inputs, by case


@pytest.fixture(scope="module")
def runs():
    """The world's outputs and the references, the world running while this
    process computes the references."""
    cases, ref = {}, {}
    _jax_inputs(cases, ref)
    _twin_inputs(cases, ref)
    _step_inputs(cases, ref)
    _residency_inputs(cases)
    cases["dryrun"] = ("dryrun_episodes", MESH, {})
    # one intra-op thread for these small references: with the host's cores
    # oversubscribed (the suite's other workers), eight threads spin-waiting
    # on each other made them 50x slower
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(launch.run, JOBS, WORLD, device="cpu", kwargs={"cases": cases},
                              timeout=DEADLINE)
            want = {name: fn() for name, fn in ref.items()}
            return Runs(fut.result(), want, {name: c for name, (_, _, c) in cases.items()})
    finally:
        torch.set_num_threads(threads)


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], outs[0][key])
    return outs[0][key]


def _plan_records(history):
    return [h for h in history if "rmse" in h]


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_mesh_episode_samples_the_jax_agents_sites(runs, name):
    """Exact-W MI on the 1 × 4 mesh, and low-rank MI with device metrics:
    the JAX single-device Agent's sites index for index, each step's RMSE,
    held-out RMSE and mean variance within 1e-3 relative."""
    want = runs.want[name]
    np.testing.assert_array_equal(_same_on_every_rank(runs.outs, f"{name}/sites"),
                                  want.state.sampled_idx)
    recs = _plan_records(want.history)
    o = runs.outs[0]
    np.testing.assert_array_equal(o[f"{name}/steps"], [h["step"] for h in recs])
    for k in ("rmse", "rmse_test", "mean_var"):
        np.testing.assert_allclose(o[f"{name}/{k}"], [h[k] for h in recs], rtol=1e-3)


@pytest.mark.parametrize("name", ["exact", "lowrank", "entropy", "per_sample"])
def test_sharded_episode_matches_single_rank(runs, name):
    """tests/test_sharded.py:318 (its four cases): the same sites, each
    step's metrics within rtol 5e-4 / atol 5e-5, the final field within
    rtol 5e-3 / atol 5e-4."""
    want, o = runs.want[name], runs.outs[0]
    np.testing.assert_array_equal(_same_on_every_rank(runs.outs, f"{name}/sites"),
                                  want.state.sampled_idx)
    recs = _plan_records(want.history)
    assert len(recs) == len(o[f"{name}/rmse"])
    for k in ("rmse", "rmse_test", "mean_var"):
        np.testing.assert_allclose(o[f"{name}/{k}"], [h[k] for h in recs],
                                   rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(o[f"{name}/final_rmse"], want.rmse, rtol=5e-4)
    np.testing.assert_allclose(o[f"{name}/mean"], want.mean, rtol=5e-3, atol=5e-4)


def test_sharded_episode_mixed_modality_matches(runs):
    """tests/test_sharded.py:350: the precise sensor goes to the same site."""
    want = runs.want["mixed"]
    np.testing.assert_array_equal(_same_on_every_rank(runs.outs, "mixed/sites"),
                                  want.state.sampled_idx)
    np.testing.assert_array_equal(runs.outs[0]["mixed/noise_scale"], want.state.noise_scale)


def test_sharded_plan_step_lowrank_matches_jax(runs):
    """tests/test_sharded.py:366, the port's mesh step against the JAX step."""
    b1, mean1, d1, s1 = runs.want["step"]
    o, n = runs.outs[0], len(runs.inputs["step"]["x"])
    assert int(_same_on_every_rank(runs.outs, "step/best")) == int(b1)
    np.testing.assert_allclose(o["step/scores"], np.asarray(s1), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(o["step/mean"][:n], np.asarray(mean1), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(o["step/var"][:n], np.asarray(d1), rtol=2e-4, atol=2e-5)


def test_sharded_episode_z_ensemble_matches_single_rank(runs):
    """tests/test_sharded.py:419: the K = 3 z-ensemble on the mesh."""
    want, o = runs.want["ensemble"], runs.outs[0]
    np.testing.assert_array_equal(_same_on_every_rank(runs.outs, "ensemble/sites"),
                                  want.state.sampled_idx)
    for k in ("rmse", "rmse_test", "mean_var"):
        np.testing.assert_allclose(o[f"ensemble/{k}"], [h[k] for h in
                                                        _plan_records(want.history)],
                                   rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("name", ["gate_lowrank", "gate_exact"])
def test_sharded_episode_matches_single_under_matmul_conditioning(runs, name):
    """tests/test_sharded.py:440: `acquisition.COND_MATMUL_N = 1` in the
    ranks and in the single-rank run, so both take the explicit-inverse
    conditioning; the gate reads the unpadded count on both sides."""
    want = runs.want[name]
    np.testing.assert_array_equal(_same_on_every_rank(runs.outs, f"{name}/sites"),
                                  want.state.sampled_idx)
    if name == "gate_lowrank":
        got = runs.outs[0][f"{name}/rmse_test"][-1]
        assert got == pytest.approx(_plan_records(want.history)[-1]["rmse_test"], abs=2e-3)


@pytest.mark.parametrize("name", list(JAX_CASES) + list(TWINS))
def test_ranks_agree_on_every_fit(runs, name):
    """The fit runs whole on every rank: after each fit the ranks hold the
    same parameters, bit for bit, and sample the same sites."""
    _same_on_every_rank(runs.outs, f"{name}/fit_params")
    _same_on_every_rank(runs.outs, f"{name}/sites")


def test_exact_w_seed_lives_at_n2_over_s_per_rank(runs):
    """tests/test_sharded_residency.py:41: W is (N/S, N) a rank."""
    for o in runs.outs:
        assert tuple(o["w_seed/W"]) == (2048 // WORLD, 2048)


def test_lowrank_seed_lives_at_nm_over_s_per_rank(runs):
    """tests/test_sharded_residency.py:61: VT (N/S, M), dinv and pdiag (N/S,)."""
    n_loc = 32768 // WORLD
    for o in runs.outs:
        assert tuple(o["lr_seed/VT"]) == (n_loc, 64)
        assert tuple(o["lr_seed/dinv"]) == tuple(o["lr_seed/pdiag"]) == (n_loc,)


def test_sharded_step_fields_stay_sharded_at_n_over_s(runs):
    """tests/test_sharded_residency.py:82: the step's mean and variance are
    (N/S,) a rank; the decision is the same on every rank."""
    for o in runs.outs:
        assert tuple(o["step_fields/mean_local"]) == tuple(o["step_fields/var_local"]) == (
            32768 // WORLD,)
    assert 0 <= int(_same_on_every_rank(runs.outs, "step_fields/best")) < 8


def test_mesh_episode_agent_keeps_seed_sharded_across_steps(runs):
    """tests/test_sharded_residency.py:123, on the 2 × 2 mesh: the Agent's
    cached seed is VT (N_pad/S, M) a rank, built once a fit (the pilot's,
    then at each refit step) and reused by the steps between."""
    for o in runs.outs:
        S = o["residency_agent/mesh"][1]
        n_pad = int(o["residency_agent/n_pad"])
        assert n_pad % S == 0
        assert tuple(o["residency_agent/seed_VT"]) == (n_pad // S, 24)
        assert tuple(o["residency_agent/seed_dinv"]) == (n_pad // S,)
        fits_by_plan = 1 + o["residency_agent/steps"] // 2  # refit_every = 2
        np.testing.assert_array_equal(o["residency_agent/seed_builds"], fits_by_plan)


def test_ensemble_seed_lives_at_knm_over_s_per_rank(runs):
    """tests/test_sharded_residency.py:161: the K = 3 ensemble's VT is
    (K, N/S, M) a rank."""
    for o in runs.outs:
        assert tuple(o["ens_seed/VT"]) == (3, 8192 // WORLD, 32)
        assert tuple(o["ens_seed/dinv"]) == (3, 8192 // WORLD)


@pytest.mark.parametrize("name", DRYRUN)
def test_dryrun_episode_blocks_pass_on_the_2x2_mesh(runs, name):
    """The dry run's episode blocks (each mesh episode samples the
    single-rank Agent's sites, the trait episodes' RMSE within 1e-5,
    checked in the ranks) on every rank alike."""
    _same_on_every_rank(runs.outs, f"dryrun/episode_{name}_sites")
    if name.startswith("traits"):
        rmse = _same_on_every_rank(runs.outs, f"dryrun/episode_{name}_trait_rmse")
        assert rmse.shape == (3,) and np.isfinite(rmse).all()


def test_mesh_pad_aligns_to_lcm_of_256_and_the_grid():
    """`mesh_pad` pads to lcm(256, S) with the inert sentinels, as the
    reference's does (not the greedy paths' lcm(512, S))."""
    from algp_tpu.parallel import sharded_episode as jsep

    from algp_tpu_torch.parallel.sharded_episode import mesh_pad

    x = np.random.default_rng(2).uniform(0, 10, (1000, 2)).astype(np.float32)
    for S in (1, 3, 4, 6):
        got, n = mesh_pad(torch.tensor(x), S)
        want, n_ref = jsep.mesh_pad(jnp.asarray(x), S)
        assert n == n_ref == 1000
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
