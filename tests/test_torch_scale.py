"""The million-point regime of algp_tpu_torch against algp_tpu's, on the CPU,
with the size gates forced small in both packages: the explicit-inverse
solves past `COND_MATMUL_N`, the streamed small-factor seed and FITC
truth, the k-center sub-grid, the z-ensemble (greedy, fused step,
episode, CLI) and the c5_1m / c5_4m / c5_1m_long presets.

Tolerances: selections, plan choices, designs and episode sites are equal
index for index.  The explicit inverse's product agrees with the
triangular solve within 1e-5 of the largest entry (a factor of K + I, far
from singular).  Streamed and monolithic factors of one package agree
within rtol 1e-5 / atol 2e-7·max|LB| (only the order of B's sums
changes: the reference's rtol, its atol scaled to LB ≈ 30); the port's
LB with the reference's within 1e-5·max|LB| (two f32 implementations of
the O(N·M²) pass).  The streamed truth equals the one-chunk truth within
1e-5 (220 inducing points, the reference test's case) and the
reference's within 1e-3 of max|f| (100 points; test_torch_lowrank's
bound: an ill-conditioned L_zz amplifies the f32 rounding).  Ensemble
scores agree with the
reference's within rtol 2e-3 / atol 2e-4 (test_torch_lowrank's bound for
one design).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from algp_tpu import acquisition as jacq
from algp_tpu import acquisition_lowrank as jlr
from algp_tpu import config as jc
from algp_tpu import episode as jep
from algp_tpu import field as jfield
from algp_tpu.episode import Agent as JAgent
from algp_tpu.field import FieldEnv as JFieldEnv
from algp_tpu.ops import linalg as jla
from algp_tpu.ops.kernels import KernelSpec
from algp_tpu_torch import acquisition as tacq
from algp_tpu_torch import acquisition_lowrank as tlr
from algp_tpu_torch import cli
from algp_tpu_torch import config as tc
from algp_tpu_torch import episode as tep
from algp_tpu_torch import field as tfield
from algp_tpu_torch.convert import field_env_like
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.field import FieldEnv
from algp_tpu_torch.models import gp as tgp
from algp_tpu_torch.ops import kernels as tk
from algp_tpu_torch.ops import linalg as tla

import oracle
from test_torch_episode import _plan_records, _reference_step_inits, _same_posterior
from test_torch_lowrank import _step_inputs, _t, setup_field

SPEC, TSPEC = KernelSpec("rbf", ds=2), tk.KernelSpec("rbf", ds=2)


@pytest.fixture
def gate(monkeypatch):
    """Set COND_MATMUL_N in both packages (the reference's jitted programs
    read it at trace time, so their caches are dropped around the test)."""
    def set_gate(n):
        monkeypatch.setattr(jacq, "COND_MATMUL_N", n)
        monkeypatch.setattr(tacq, "COND_MATMUL_N", n)
        jax.clear_caches()
    yield set_gate
    jax.clear_caches()


def _counting(monkeypatch, mod, name):
    calls = []
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    return calls


# ------------------------------------------------ the explicit-inverse solves


@pytest.mark.parametrize("n_global,matmul", [(299, False), (300, True)])
def test_cond_solve_matches_reference(rng, gate, monkeypatch, n_global, matmul):
    gate(300)
    x = rng.uniform(0, 10, (24, 2))
    L = np.linalg.cholesky(oracle.gram(x, x, ls_spatial=2.0) + np.eye(24)).astype(np.float32)
    B = rng.standard_normal((24, 300)).astype(np.float32)
    calls = _counting(monkeypatch, tla, "solve_triangular_matmul")
    got = tacq.cond_solve(_t(L), _t(B), n_global).numpy()
    assert bool(calls) == matmul  # the gate is read at the call
    want = np.asarray(jacq.cond_solve(jnp.asarray(L), jnp.asarray(B), n_global))
    exact = np.linalg.solve(L.astype(np.float64), B)
    for a in (got, want):
        assert np.abs(a - exact).max() <= 1e-5 * np.abs(exact).max()
    np.testing.assert_allclose(
        tla.solve_triangular_matmul(_t(L), _t(B)).numpy(),
        np.asarray(jla.solve_triangular_matmul(jnp.asarray(L), jnp.asarray(B))),
        atol=1e-5 * np.abs(exact).max())


def test_cond_solve_gate_uses_unpadded_count(gate, monkeypatch):
    """greedy_select pads 150 candidates to 512: the gate keys on 150."""
    rng = np.random.default_rng(5)
    params, tparams, x, K, nv = setup_field(rng, n=150, ls=3.0, os_=1.0)
    pilot = np.linspace(0, 149, 6).round().astype(np.int64)
    calls = _counting(monkeypatch, tla, "solve_triangular_matmul")

    def run():
        return tacq.greedy_select(TSPEC, tparams, _t(x), torch.full((150,), nv),
                                  torch.tensor(pilot), rounds=5, num_pilot=6,
                                  strategy="mi").selected.numpy()

    gate(200)  # between the true count and the padded length
    window = run()
    assert not calls
    gate(100)
    gated = run()
    assert calls
    want = jacq.greedy_select(SPEC, params, jnp.asarray(x, jnp.float32),
                              jnp.full((150,), nv, jnp.float32),
                              jnp.asarray(pilot, jnp.int32), rounds=5, num_pilot=6,
                              strategy="mi")
    np.testing.assert_array_equal(window, gated)
    np.testing.assert_array_equal(gated, np.asarray(want.selected))


@pytest.mark.parametrize("strategy", ["entropy", "mi"])
def test_conditioning_matmul_gate_preserves_selections(gate, strategy):
    """Gate forced to 1: 30 greedy rounds on a jittered 10 × 15 grid equal
    the f64 oracle's and the reference's under the same gate."""
    rng = np.random.default_rng(17)
    r, c = np.divmod(np.arange(150), 15)
    x = np.stack([c + 0.1 * rng.standard_normal(150), r + 0.1 * rng.standard_normal(150)], 1)
    pilot = np.linspace(0, 149, 8).round().astype(np.int64)
    nv = 0.15**2
    K = oracle.gram(x, x, ls_spatial=3.0, outputscale=1.0)
    gate(1)
    got = tacq.greedy_select(
        TSPEC, TSPEC.init_params(ls_spatial=3.0, noise=0.15), _t(x),
        torch.full((150,), nv), torch.tensor(pilot), rounds=30, num_pilot=8,
        strategy=strategy).selected.numpy()
    want = jacq.greedy_select(
        SPEC, SPEC.init_params(ls_spatial=3.0, noise=0.15), jnp.asarray(x, jnp.float32),
        jnp.full((150,), nv, jnp.float32), jnp.asarray(pilot, jnp.int32), rounds=30,
        num_pilot=8, strategy=strategy)
    fn = oracle.greedy_variance_selection if strategy == "entropy" else oracle.greedy_mi_selection
    np.testing.assert_array_equal(got, fn(K, nv, 30, pilot)[0])
    np.testing.assert_array_equal(got, np.asarray(want.selected))


def test_greedy_lowrank_under_the_matmul_seed(gate):
    """Gate forced to 1 (the seeds' (M, N) solves are explicit-inverse
    products): 18 low-rank rounds equal the f64 low-rank oracle and the
    reference under the same gate."""
    rng = np.random.default_rng(7)
    params, tparams, x, K, nv = setup_field(rng, n=240)
    pilot = rng.choice(240, size=6, replace=False)
    gate(1)
    zidx = tlr.kcenter_indices(_t(x), 60).numpy()
    got = tlr.greedy_select_lowrank(
        TSPEC, tparams, _t(x), torch.full((240,), nv), torch.tensor(pilot),
        _t(x[zidx]), rounds=18, num_pilot=6).selected.numpy()
    want = jlr.greedy_select_lowrank(
        SPEC, params, jnp.asarray(x, jnp.float32), jnp.full((240,), nv, jnp.float32),
        jnp.asarray(pilot, jnp.int32), jnp.asarray(x[zidx], jnp.float32),
        rounds=18, num_pilot=6)
    np.testing.assert_array_equal(got, oracle.greedy_mi_selection_lowrank(
        K, zidx, nv, 18, pilot)[0])
    np.testing.assert_array_equal(got, np.asarray(want.selected))


# ------------------------------------------------------------ streamed passes


@pytest.mark.parametrize("gate_n", [1, 1 << 20], ids=["matmul", "trisolve"])
def test_streamed_factors_seed_matches_monolithic_and_reference(rng, gate, monkeypatch,
                                                                gate_n):
    """_SEED_CHUNK_BYTES = 0 streams the seed; _SEED_CHUNK = 64 ∤ 150 pads
    the tail.  The chunks' solve family follows the global gate."""
    n = 150
    x = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    tp = TSPEC.init_params(ls_spatial=2.0, outputscale=1.3, noise=0.12)
    jp = SPEC.init_params(ls_spatial=2.0, outputscale=1.3, noise=0.12)
    z = _t(x).index_select(0, tlr.kcenter_indices(_t(x), 40))
    gate(gate_n)
    mono = tlr.lowrank_factors_seed(TSPEC, tp, _t(x), z, nv_mult=1.5)
    for mod in (tlr, jlr):
        monkeypatch.setattr(mod, "_SEED_CHUNK_BYTES", 0)
        monkeypatch.setattr(mod, "_SEED_CHUNK", 64)
    jlr.lowrank_factors_seed.clear_cache()
    trisolves = _counting(monkeypatch, tla, "solve_triangular")
    chunk = tlr.lowrank_factors_seed(TSPEC, tp, _t(x), z, nv_mult=1.5)
    assert len(trisolves) == (0 if gate_n == 1 else 3)  # one per chunk
    try:
        want = jlr.lowrank_factors_seed(SPEC, jp, jnp.asarray(x), jnp.asarray(z.numpy()),
                                        nv_mult=1.5)
    finally:
        jlr.lowrank_factors_seed.clear_cache()
    assert torch.equal(chunk.Lzz, mono.Lzz)
    lb_max = float(mono.LB.abs().max())
    np.testing.assert_allclose(chunk.LB.numpy(), mono.LB.numpy(), rtol=1e-5,
                               atol=2e-7 * lb_max)
    assert np.abs(chunk.LB.numpy() - np.asarray(want.LB)).max() <= 1e-5 * lb_max


def test_streamed_fitc_truth_matches_monolithic_and_reference(monkeypatch):
    """_SYNTH_CHUNK_BYTES = 0 streams the truth in chunks of 704 ∤ 1600,
    on the reference's draws.  Streamed against one chunk at the reference
    test's 220 inducing points; against the reference at 100, since at 220
    (cond K_zz ≈ 2.5e7) the f32 rounding through L_zz puts each package's
    truth near 1e-3·max|f| from the f64 draw on the same design and draws
    (held within 2e-3), and so about as far from the other."""
    def cfg(m):
        return dict(num_rows=40, num_cols=40, true_ls_spatial=6.0, synth_inducing=m,
                    seed=3)

    def draws(m):
        k1, k2 = jax.random.split(jax.random.PRNGKey(3))
        return (np.asarray(jax.random.normal(k1, (m, 1)))[:, 0],
                np.asarray(jax.random.normal(k2, (1600, 1)))[:, 0])

    def port_field(m):
        return FieldEnv(tc.FieldConfig(**cfg(m)), TSPEC, device="cpu", draws=draws(m))

    mono = port_field(220)
    X = mono.X.numpy().astype(np.float64)
    Z = X[tlr.kcenter_indices(mono.X, 220).numpy()]
    L = np.linalg.cholesky(oracle.gram(Z, Z, ls_spatial=6.0) + 1e-6 * np.eye(220))
    U = np.linalg.solve(L, oracle.gram(Z, X, ls_spatial=6.0))
    zm, zn = draws(220)
    f64 = U.T @ zm + np.sqrt(np.clip(1.0 - (U * U).sum(0), 0.0, None)) * zn
    for f in (mono.f, JFieldEnv(jc.FieldConfig(**cfg(220)), SPEC).f):
        assert np.abs(f - f64).max() <= 2e-3 * np.abs(f64).max()
    for mod in (tfield, jfield):
        monkeypatch.setattr(mod, "_SYNTH_CHUNK_BYTES", 0)
        monkeypatch.setattr(mod, "_SYNTH_CHUNK", 704)
    np.testing.assert_allclose(port_field(220).f, mono.f, rtol=1e-5, atol=1e-5)
    got, ref = port_field(100), JFieldEnv(jc.FieldConfig(**cfg(100)), SPEC)
    assert np.abs(got.f - ref.f).max() <= 1e-3 * np.abs(ref.f).max()
    np.testing.assert_array_equal(got.test_mask, ref.test_mask)


# ------------------------------------------------------- the k-center sub-grid


@pytest.mark.parametrize("nr,nc,target", [
    (2048, 2048, 1 << 20), (1500, 3000, 1 << 20), (1024, 1024, 1 << 20),
    (20, 20, 256), (7, 9, 20),
])
def test_kcenter_subgrid_indices_match_reference(nr, nc, target):
    got = tep._kcenter_subgrid_indices(nr, nc, target)
    np.testing.assert_array_equal(got, jep._kcenter_subgrid_indices(nr, nc, target))
    assert len(got) <= target and got.dtype == np.int64
    if (nr, nc) == (2048, 2048):  # a true 1024 × 1024 grid of stride 2
        rows, cols = np.unique(got // nc), np.unique(got % nc)
        assert len(rows) == len(cols) == 1024 and len(got) == 1 << 20
        assert (np.diff(rows) == 2).all() and (np.diff(cols) == 2).all()
    assert tep._KCENTER_SUBSAMPLE == jep._KCENTER_SUBSAMPLE
    assert tep._KCENTER_TARGET == jep._KCENTER_TARGET


def _episode_pair(mi_ensemble=1, rows=12, cols=16, path_utility="per_cost"):
    """A small c5_4m-shaped episode: FITC truth, low-rank planner, device
    metrics."""
    def build(mod, KS):
        return mod.ExperimentConfig(
            kernel=KS("matern32", ds=2),
            field=mod.FieldConfig(num_rows=rows, num_cols=cols, true_ls_spatial=3.0,
                                  synth_inducing=48, seed=5),
            fit=mod.FitConfig(iters=10, restarts=2, refit_iters=5, refit_restarts=2),
            acquisition=mod.AcquisitionConfig(strategy="mi", num_inducing=40,
                                              mi_ensemble=mi_ensemble,
                                              path_utility=path_utility),
            episode=mod.EpisodeConfig(num_pilot=12, budget=40.0, refit_every=2,
                                      samples_per_step=6, seed=5, device_metrics=True),
        )
    return build(jc, KernelSpec), build(tc, tk.KernelSpec)


def _run_pair(monkeypatch, jcfg, tcfg, steps):
    monkeypatch.setattr(tgp, "step_inits", _reference_step_inits)
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")
    jagent, agent = JAgent(jenv, jcfg), Agent(tenv, tcfg)
    want, got = jagent.run(max_steps=steps), agent.run(max_steps=steps)
    hj, ht = _plan_records(want.history), _plan_records(got.history)
    assert len(ht) == len(hj) >= 3
    for a, b in zip(hj, ht):  # the same sites at every step
        assert (b["step"], b["n_sampled"]) == (a["step"], a["n_sampled"])
        assert b["rmse_test"] == pytest.approx(a["rmse_test"], rel=1e-3)
    np.testing.assert_array_equal(got.state.sampled_idx, want.state.sampled_idx)
    _same_posterior(want, got, tenv)
    return jagent, agent


def test_subgrid_episode_matches_reference(monkeypatch):
    """Sub-grid gate at 256 points: the 20 × 20 field's design runs over
    its 20 × 10 sub-grid in both packages, and the episodes agree."""
    for mod in (tep, jep):
        monkeypatch.setattr(mod, "_KCENTER_SUBSAMPLE", 256)
        monkeypatch.setattr(mod, "_KCENTER_TARGET", 256)
    jcfg, tcfg = _episode_pair(rows=20, cols=20)
    jagent, agent = _run_pair(monkeypatch, jcfg, tcfg, steps=4)
    z = agent._z_cache.numpy()
    np.testing.assert_array_equal(z, np.asarray(jagent._z_cache[1]))
    Xs = agent.env.X.numpy()[tep._kcenter_subgrid_indices(20, 20, 256)]
    assert all((np.abs(Xs - row).sum(1) == 0).any() for row in z)
    assert len(np.unique(z, axis=0)) == len(z) == 40


# ------------------------------------------------------------- the z-ensemble


def test_greedy_ensemble_matches_reference_and_oracle(rng):
    """K = 3 distinct designs (starts 0, n/3, 2n/3): index for index with
    the reference and the f64 ensemble oracle; K copies of one design
    select what the single design does."""
    params, tparams, x, K, nv = setup_field(rng, n=220)
    pilot = rng.choice(220, size=5, replace=False)
    xt = _t(x)
    zidx = [tlr.kcenter_indices(xt, 55, start=s).numpy() for s in (0, 73, 146)]
    args = (TSPEC, tparams, xt, torch.full((220,), nv), torch.tensor(pilot))
    got = tlr.greedy_select_lowrank(
        *args, torch.stack([_t(x[zi]) for zi in zidx]), rounds=16,
        num_pilot=5).selected.numpy()
    want = jlr.greedy_select_lowrank(
        SPEC, params, jnp.asarray(x, jnp.float32), jnp.full((220,), nv, jnp.float32),
        jnp.asarray(pilot, jnp.int32), jnp.stack([jnp.asarray(x[zi], jnp.float32)
                                                  for zi in zidx]),
        rounds=16, num_pilot=5)
    np.testing.assert_array_equal(got, oracle.greedy_mi_selection_lowrank_ensemble(
        K, zidx, nv, 16, pilot))
    np.testing.assert_array_equal(got, np.asarray(want.selected))
    z0 = _t(x[zidx[0]])
    single = tlr.greedy_select_lowrank(*args, z0, rounds=16, num_pilot=5)
    copies = tlr.greedy_select_lowrank(*args, torch.stack([z0, z0, z0]), rounds=16,
                                       num_pilot=5)
    assert torch.equal(copies.selected, single.selected)


@pytest.mark.parametrize("path_utility", ["per_cost", "per_sample"])
def test_ensemble_step_matches_reference(rng, path_utility):
    x, idx, ns, y, sets, sizes, costs = _step_inputs(rng, n=220, S=12)
    tp = TSPEC.init_params(ls_spatial=2.0, outputscale=1.3, noise=0.12)
    jp = SPEC.init_params(ls_spatial=2.0, outputscale=1.3, noise=0.12)
    xt = _t(x)
    zs = [xt.index_select(0, tlr.kcenter_indices(xt, 32, start=s)) for s in (0, 110)]
    facs = [tlr.lowrank_factors_seed(TSPEC, tp, xt, z, nv_mult=1.5) for z in zs]
    targs = (TSPEC, tp, xt, torch.tensor(idx), 11, _t(ns), _t(y), torch.tensor(sets),
             torch.tensor(sizes), _t(costs))
    kw = dict(nv_mult=1.5, path_utility=path_utility)
    b, mean, d, s = tlr.plan_episode_step_lowrank_factors(
        *targs, facs, **kw)
    jfacs = [jlr.lowrank_factors_seed(SPEC, jp, jnp.asarray(x), jnp.asarray(z.numpy()),
                                      nv_mult=1.5) for z in zs]
    jfac = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *jfacs)
    bj, meanj, dj, sj = jlr.plan_episode_step_lowrank_factors(
        SPEC, jp, jnp.asarray(x), jnp.asarray(idx, jnp.int32), jnp.asarray(11),
        jnp.asarray(ns), jnp.asarray(y), jnp.asarray(sets, jnp.int32),
        jnp.asarray(sizes, jnp.int32), jnp.asarray(costs), jfac, ensemble=2, **kw)
    assert int(b) == int(bj)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(meanj), atol=1e-4)
    # the ensemble's scores are the mean of its designs'; two copies of
    # one design are that design
    singles = [tlr.plan_episode_step_lowrank_factors(*targs, f, **kw)[3] for f in facs]
    np.testing.assert_allclose(s.numpy(), ((singles[0] + singles[1]) / 2).numpy(),
                               rtol=1e-6, atol=1e-7)
    b2, _, _, s2 = tlr.plan_episode_step_lowrank_factors(
        *targs, [facs[0], facs[0]], **kw)
    np.testing.assert_allclose(s2.numpy(), singles[0].numpy(), rtol=1e-6, atol=1e-6)


def test_ensemble_episode_matches_reference(monkeypatch):
    """mi_ensemble = 3 through both Agents: three designs from starts 0,
    n/3 and 2n/3, the same sites at every step."""
    jcfg, tcfg = _episode_pair(mi_ensemble=3, path_utility="per_sample")
    jagent, agent = _run_pair(monkeypatch, jcfg, tcfg, steps=5)
    assert agent._z_cache.shape == (3, 40, 2)
    np.testing.assert_array_equal(agent._z_cache.numpy(), np.asarray(jagent._z_cache[1]))
    exact = dataclasses.replace(tcfg, acquisition=dataclasses.replace(
        tcfg.acquisition, num_inducing=0))
    with pytest.raises(ValueError, match="mi_ensemble"):
        Agent(agent.env, exact)


def test_cli_greedy_mi_ensemble(monkeypatch, capsys):
    """--mode greedy --mi-ensemble 3: the reference's three design starts,
    the ensemble loop, and a clean refusal without the low-rank planner."""
    seen = []
    orig = tlr.greedy_select_lowrank
    monkeypatch.setattr(tlr, "greedy_select_lowrank",
                        lambda *a, **k: (seen.append(a[5]), orig(*a, **k))[1])
    small = ["--mode", "greedy", "--strategy", "mi", "--rows", "6", "--cols", "10",
             "--acq-rounds", "8", "--num-pilot", "6", "--iters", "10", "--restarts", "1",
             "--device", "cpu"]
    assert cli.main([*small, "--num-inducing", "12", "--mi-ensemble", "3"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_sampled"] == 6 + 8 and np.isfinite(rec["final_rmse"])
    r, c = np.divmod(np.arange(60), 10)
    X = jnp.asarray(np.stack([c, r], 1), jnp.float32)
    want = np.stack([np.asarray(X[jlr.kcenter_indices(X, 12, start=(j * 60) // 3)])
                     for j in range(3)])
    np.testing.assert_array_equal(seen[0].numpy(), want)
    with pytest.raises(ValueError, match="low-rank planner"):
        cli.main([*small, "--num-inducing", "0", "--mi-ensemble", "3"])


# ------------------------------------------------------------------ presets


@pytest.mark.parametrize("name", ["c5_1m", "c5_4m", "c5_1m_long"])
def test_million_point_presets_equal_the_reference(name):
    mine, ref = tc.PRESETS[name], jc.PRESETS[name]
    for part in ("kernel", "fit", "acquisition", "field", "episode"):
        ours = dataclasses.asdict(getattr(mine, part))
        theirs = dataclasses.asdict(getattr(ref, part))
        assert ours == {k: theirs[k] for k in ours}, (name, part)
    n = mine.field.num_rows * mine.field.num_cols
    assert n >= tacq.COND_MATMUL_N  # the explicit-inverse branch
    if name == "c5_4m":  # streamed truth and seed, sub-grid design
        assert 4 * 512 * n > tfield._SYNTH_CHUNK_BYTES and n > tep._KCENTER_SUBSAMPLE
        assert 4 * 512 * n > tlr._SEED_CHUNK_BYTES
    else:
        assert 4 * mine.field.synth_inducing * n <= tfield._SYNTH_CHUNK_BYTES
        assert 4 * 512 * n <= tlr._SEED_CHUNK_BYTES and n <= tep._KCENTER_SUBSAMPLE
