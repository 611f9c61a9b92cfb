"""algp_tpu_torch.parallel (the mesh paths over torch.distributed) against
algp_tpu.parallel on the virtual CPU mesh of tests/conftest.py, at the same
mesh shapes: 2 × 2 (the reference's `make_mesh(4)`) and 1 × 4 (`restarts_axis=1`).

The port runs in two worlds of four gloo ranks on the CPU, each started
once for the module by `algp_tpu_torch.parallel.launch` (the ranks run
tests/torch_mesh_jobs.py, which imports no JAX) while this process runs
the reference; every case compares the two.  Nothing can hang: a rank
waiting on a collective that never completes raises after its process
group's 60 s timeout and the launcher then raises with its output; a
world that outlives DEADLINE is killed all the same."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg as sla

import jax
import jax.numpy as jnp

import oracle
from algp_tpu import acquisition_lowrank as jlr
from algp_tpu.config import FitConfig as JFitConfig
from algp_tpu.models import coregional as jicm
from algp_tpu.models import gp as jgp
from algp_tpu.ops.kernels import KernelSpec as JKernelSpec
from algp_tpu.parallel import make_mesh as jmake_mesh
from algp_tpu.parallel import sharded as jsh
from algp_tpu.parallel.sharded_lowrank import sharded_greedy_select_mi_lowrank as jlowrank
from algp_tpu.parallel.sharded_mi import sharded_greedy_select_mi as jmi
from algp_tpu_torch.parallel import launch

JOBS = str(Path(__file__).resolve().parent / "torch_mesh_jobs.py") + ":run_cases"
JSPEC = JKernelSpec("rbf", ds=2)
WORLD = 4
DEADLINE = 300.0  # s for a world's start-up and all its cases, on a loaded host


def _np(tree) -> dict:
    """A reference params dataclass as {field: numpy}, nested for ICM."""
    return {f.name: (_np(v) if dataclasses.is_dataclass(v := getattr(tree, f.name))
                     else np.asarray(v)) for f in dataclasses.fields(tree)}


def _inputs():
    """The cases of both worlds (numpy inputs, the reference's inits) and
    the reference calls that go with them."""
    rng = np.random.default_rng(0)
    a, b, ref = {}, {}, {}
    mesh_a, mesh_b = jmake_mesh(WORLD), jmake_mesh(WORLD, restarts_axis=1)

    x = rng.uniform(0, 10, (64, 2)).astype(np.float32)
    y = rng.standard_normal(64).astype(np.float32)
    cfg = dict(iters=30, restarts=4)
    key = jax.random.PRNGKey(0)
    a["fit"] = ("fit", dict(x=x, y=y, cfg=cfg,
                            inits=_np(jgp.make_restart_inits(JSPEC, JFitConfig(**cfg), key))))
    ref["fit"] = partial(jsh.sharded_fit, mesh_a, JSPEC, JFitConfig(**cfg), jnp.asarray(x),
                         jnp.asarray(y), key=key)

    x = rng.uniform(0, 10, (48, 2)).astype(np.float32)
    Y = rng.standard_normal((48, 3)).astype(np.float32)
    obs = rng.uniform(size=(48, 3)) < 0.7
    key = jax.random.PRNGKey(1)
    for restarts in (4, 3):  # 3 does not divide the 2-wide restarts axis
        cfg = dict(iters=25, restarts=restarts)
        inits = jicm.make_icm_inits(JSPEC, JFitConfig(**cfg), 3, 1, key)
        a[f"icm{restarts}"] = ("fit_icm", dict(x=x, Y=Y, obs=obs, cfg=cfg, inits=_np(inits)))
        ref[f"icm{restarts}"] = partial(
            jsh.sharded_fit_icm, mesh_a, JSPEC, JFitConfig(**cfg), jnp.asarray(x),
            jnp.asarray(Y), jnp.asarray(obs), key=key, rank=1)

    params = JSPEC.init_params(ls_spatial=2.0, noise=0.15)
    x = rng.uniform(0, 12, (300, 2)).astype(np.float32)
    nv = np.full(300, 0.15 ** 2, np.float32)
    for num_pilot in (0, 3):
        pilot = rng.choice(300, num_pilot, replace=False).astype(np.int64)
        for strategy in ("entropy", "mi"):
            name = f"greedy_{strategy}_{num_pilot}"
            a[name] = ("greedy", dict(params=_np(params), x=x, nv=nv, pilot=pilot, rounds=15,
                                      strategy=strategy))
            ref[name] = partial(
                jsh.sharded_greedy_select, mesh_a, JSPEC, params, jnp.asarray(x),
                jnp.asarray(nv), jnp.asarray(pilot, jnp.int32), rounds=15,
                num_pilot=len(pilot), strategy=strategy)

    cfg = dict(iters=10, restarts=4)
    xt = rng.uniform(0, 10, (24, 2)).astype(np.float32)
    yt = rng.standard_normal(24).astype(np.float32)
    xg = rng.uniform(0, 10, (256, 2)).astype(np.float32)
    nvg = np.full(256, 0.01, np.float32)
    pilot = np.array([0, 7])
    key = jax.random.PRNGKey(3)
    inits = _np(jgp.make_restart_inits(JSPEC, JFitConfig(**cfg), key))
    for strategy in ("entropy", "mi"):
        a[f"step_{strategy}"] = ("step", dict(cfg=cfg, x_train=xt, y_train=yt, x_grid=xg,
                                              nv=nvg, pilot=pilot, rounds=4,
                                              strategy=strategy, inits=inits))
        ref[f"step_{strategy}"] = partial(
            jsh.sharded_training_step, mesh_a, JSPEC, JFitConfig(**cfg), jnp.asarray(xt),
            jnp.asarray(yt), jnp.asarray(xg), jnp.asarray(nvg),
            jnp.asarray(pilot, jnp.int32), rounds=4, strategy=strategy, key=key)
    a["dryrun"] = ("dryrun", {})

    N = 64 * WORLD
    A = rng.standard_normal((N, N + 16)).astype(np.float32)
    b["linalg"] = ("dist_linalg", dict(K=A @ A.T / N + 0.5 * np.eye(N, dtype=np.float32)))

    x = rng.uniform(0, 12, (300, 2)).astype(np.float32)
    for num_pilot in (0, 4):
        pilot = np.array([0, 100, 100, 200])[:num_pilot]  # incl. a duplicate
        for seed in ("dist", "rep"):
            name = f"mi_{seed}_{num_pilot}"
            b[name] = ("mi", dict(params=_np(params), x=x, nv=nv, pilot=pilot, rounds=15,
                                  distributed_seed=seed == "dist"))
            ref[name] = partial(
                jmi, mesh_b, JSPEC, params, jnp.asarray(x), jnp.asarray(nv),
                jnp.asarray(pilot, jnp.int32), rounds=15, num_pilot=len(pilot),
                distributed_seed=seed == "dist")

    lp = JSPEC.init_params(ls_spatial=2.0, outputscale=1.4, noise=0.12)
    x = rng.uniform(0, 11, (260, 2)).astype(np.float32)
    nvl = np.full(260, 0.12 ** 2, np.float32)
    pilot = np.array([3, 77, 3, 201])  # incl. a duplicate
    zidx = np.asarray(jlr.kcenter_indices(jnp.asarray(x), 64))
    b["lowrank"] = ("lowrank", dict(params=_np(lp), x=x, nv=nvl, pilot=pilot, z=x[zidx],
                                    rounds=15))
    ref["lowrank"] = partial(jlowrank, mesh_b, JSPEC, lp, jnp.asarray(x), jnp.asarray(nvl),
                             jnp.asarray(pilot, jnp.int32), jnp.asarray(x[zidx]),
                             rounds=15, num_pilot=4)
    x64 = x.astype(np.float64)
    ref["lowrank_oracle"] = partial(
        oracle.greedy_mi_selection_lowrank,
        oracle.gram(x64, x64, ls_spatial=2.0, outputscale=1.4), zidx, 0.12 ** 2, 15, pilot)
    return a, b, ref


@dataclasses.dataclass
class Runs:
    a: list  # the 2 × 2 world's outputs, by rank
    b: list  # the 1 × 4 world's
    want: dict  # the reference's results, by case
    inputs: dict  # the cases' inputs, by case


@pytest.fixture(scope="module")
def runs():
    """Both worlds' outputs and the reference's, the worlds running while
    this process computes the reference."""
    a, b, ref = _inputs()
    with ThreadPoolExecutor(2) as pool:
        fa = pool.submit(launch.run, JOBS, WORLD, device="cpu",
                         kwargs={"restarts_axis": 2, "cases": a}, timeout=DEADLINE)
        fb = pool.submit(launch.run, JOBS, WORLD, device="cpu",
                         kwargs={"restarts_axis": 1, "cases": b}, timeout=DEADLINE)
        want = {name: fn() for name, fn in ref.items()}
        return Runs(fa.result(), fb.result(), want,
                    {name: c for name, (_, c) in {**a, **b}.items()})


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], outs[0][key])
    return outs[0][key]


@pytest.mark.parametrize("world", ["a", "b"], ids=["2x2", "1x4"])
def test_ranks_sit_at_their_mesh_coordinates(runs, world):
    shape = (2, 2) if world == "a" else (1, 4)
    for r, o in enumerate(getattr(runs, world)):
        assert tuple(o["mesh"]) == (*shape, r // shape[1], r % shape[1])


def _nlls_match(outs, name, want):
    np.testing.assert_allclose(_same_on_every_rank(outs, f"{name}/all_nlls"),
                               np.asarray(want.all_nlls), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_same_on_every_rank(outs, f"{name}/nll"),
                               np.asarray(want.nll), rtol=1e-4, atol=1e-4)


def test_sharded_fit_matches_jax_mesh(runs):
    _nlls_match(runs.a, "fit", runs.want["fit"])


@pytest.mark.parametrize("restarts", [4, 3], ids=["sharded", "replicated"])
def test_sharded_fit_icm_matches_jax_mesh(runs, restarts):
    _nlls_match(runs.a, f"icm{restarts}", runs.want[f"icm{restarts}"])


def _selection_matches(outs, name, selected, post_var, atol=1e-5):
    np.testing.assert_array_equal(_same_on_every_rank(outs, f"{name}/selected"),
                                  np.asarray(selected))
    np.testing.assert_allclose(_same_on_every_rank(outs, f"{name}/post_var"),
                               np.asarray(post_var), atol=atol)


@pytest.mark.parametrize("strategy", ["entropy", "mi"])
@pytest.mark.parametrize("num_pilot", [0, 3])
def test_sharded_greedy_matches_jax_mesh(runs, strategy, num_pilot):
    name = f"greedy_{strategy}_{num_pilot}"
    want = runs.want[name]
    _selection_matches(runs.a, name, want.selected, want.post_var)


@pytest.mark.parametrize("strategy", ["entropy", "mi"])
def test_sharded_training_step_matches_jax_mesh(runs, strategy):
    name = f"step_{strategy}"
    _, nlls, selected, post_var = runs.want[name]
    np.testing.assert_allclose(_same_on_every_rank(runs.a, f"{name}/all_nlls"),
                               np.asarray(nlls), rtol=1e-4, atol=1e-4)
    _selection_matches(runs.a, name, selected, post_var)


def test_dist_cholesky_matches_dense(runs):
    """The reference's tolerances (tests/test_sharded.py)."""
    K = runs.inputs["linalg"]["K"]
    L = _same_on_every_rank(runs.b, "linalg/L")
    np.testing.assert_allclose(L, np.linalg.cholesky(K), rtol=2e-4, atol=2e-5)
    assert np.array_equal(L, np.tril(L))


def test_dist_tri_inv_matches_dense(runs):
    K = runs.inputs["linalg"]["K"]
    W = _same_on_every_rank(runs.b, "linalg/W")
    W_ref = sla.solve_triangular(np.linalg.cholesky(K), np.eye(len(K)), lower=True)
    assert np.abs(W - W_ref).max() / np.abs(W_ref).max() < 5e-5


@pytest.mark.parametrize("seed", ["dist", "rep"], ids=["distributed", "replicated"])
@pytest.mark.parametrize("num_pilot", [0, 4])
def test_sharded_mi_matches_jax_mesh_and_oracle(runs, seed, num_pilot):
    """MI on the 1 × 4 mesh from either seed: the reference's selections
    (its post_var within the reference's own distributed-seed tolerance)
    and the f64 oracle's."""
    name = f"mi_{seed}_{num_pilot}"
    want, c = runs.want[name], runs.inputs[name]
    _selection_matches(runs.b, name, want.selected, want.post_var,
                       atol=2e-4 if seed == "dist" else 1e-5)
    x = c["x"].astype(np.float64)
    K = oracle.gram(x, x, ls_spatial=2.0, outputscale=1.0)
    sel, _ = oracle.greedy_mi_selection(K, 0.15 ** 2, 15, c["pilot"])
    np.testing.assert_array_equal(runs.b[0][f"{name}/selected"], sel)


def test_sharded_lowrank_matches_jax_mesh_and_oracle(runs):
    want = runs.want["lowrank"]
    _selection_matches(runs.b, "lowrank", want.selected, want.post_var, atol=2e-3)
    np.testing.assert_array_equal(runs.b[0]["lowrank/selected"], runs.want["lowrank_oracle"][0])


@pytest.mark.parametrize("name,key,cols", [
    ("mi_rep_4", "W", 512), ("mi_dist_4", "W", 512), ("lowrank", "VT", 64)],
    ids=["replicated-W", "distributed-W", "lowrank-VT"])
def test_precision_strips_stay_sharded(runs, name, key, cols):
    """Each of the four grid ranks holds (N/S, N) of W or (N/S, M) of VT
    (N = 512 after the padding, M = 64), never the whole factor."""
    for o in runs.b:
        assert tuple(o[f"{name}/strip_{key}"]) == (512 // WORLD, cols)


def test_dist_linalg_strips_are_row_strips(runs):
    for o in runs.b:
        assert tuple(o["linalg/strip"]) == (64, 64 * WORLD)


def test_dryrun_passes_on_the_2x2_world(runs):
    """The mesh dry run's checks (mesh = single rank) hold on every rank."""
    for o in runs.a:
        assert np.isfinite(o["dryrun/icm_nlls"]).all()
        np.testing.assert_array_equal(o["dryrun/mi_selected"], runs.a[0]["dryrun/mi_selected"])


def test_launcher_raises_with_the_failing_rank_output():
    with pytest.raises(launch.RankError, match="fails on purpose"):
        launch.run(JOBS.replace("run_cases", "fail"), 2, device="cpu",
                   kwargs={"rank_to_fail": 1}, timeout=60)


def test_launcher_deadline_ends_a_hung_world():
    with pytest.raises(launch.RankError, match="still running"):
        launch.run(JOBS.replace("run_cases", "hang"), 2, device="cpu", timeout=10)


def test_launcher_and_dryrun_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    from algp_tpu_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.run(JOBS, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.run(JOBS, 1, device="cuda")
