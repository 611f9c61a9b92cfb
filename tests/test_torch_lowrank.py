"""algp_tpu_torch.acquisition_lowrank (the low-rank FITC MI planner) and the
FITC truth against algp_tpu's and the f64 oracle, on the CPU, where the
Gram wrapper runs its plain version (the reference's use_pallas=False).

Tolerances: k-center designs, greedy selections, plan choices and episode
sites are equal index for index; the FITC truth on the reference's draws
within 1e-3 of max|f|.  The seed's dinv and pdiag agree with the
reference within rtol 5e-3 (two f32 implementations of the same O(N·M²)
algebra whose solves reduce in different orders; 1/d amplifies the f32
cancellation in d = k − q at rows near an inducing point) and VᵀV within
5e-3 of its largest entry; with the f64 Woodbury within rtol 3e-3 / atol
1e-3 (the reference's own bound, tests/test_lowrank.py); its precision
columns, run in f64, within 1e-6 of the f64 oracle's largest entry, and in
f32 within 3e-4 of the reference's f32 column.  Set scores agree
within rtol 2e-3 / atol 2e-4, MI scores with the f64 oracle within 2e-3.
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
from algp_tpu.episode import Agent as JAgent
from algp_tpu.field import FieldEnv as JFieldEnv
from algp_tpu.models import gp as jgp
from algp_tpu.ops import linalg as jla
from algp_tpu.ops.kernels import KernelParams, KernelSpec
from algp_tpu_torch import acquisition as tacq
from algp_tpu_torch import acquisition_lowrank as tlr
from algp_tpu_torch import cli
from algp_tpu_torch import config as tc
from algp_tpu_torch.convert import field_env_like, kernel_params_from_numpy
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.field import FieldEnv
from algp_tpu_torch.models import gp as tgp
from algp_tpu_torch.ops import gram as tgram
from algp_tpu_torch.ops import kernels as tk
from algp_tpu_torch.ops import linalg as tla

import oracle
from test_torch_episode import _plan_records, _reference_step_inits, _same_posterior

SPEC, TSPEC = KernelSpec("rbf", ds=2), tk.KernelSpec("rbf", ds=2)


def _np_params(p):
    return {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}


def setup_field(rng, n, ls=2.0, os_=1.5, noise=0.15):
    """tests/test_acquisition.py:setup_field for both packages."""
    x = rng.uniform(0, 12, (n, 2))
    params = KernelParams(
        log_ls_spatial=jnp.full((2,), np.log(ls), jnp.float32),
        log_ls_feature=jnp.zeros((0,), jnp.float32),
        log_outputscale=jnp.asarray(np.log(os_), jnp.float32),
        log_noise=jnp.asarray(np.log(noise), jnp.float32),
    )
    K = oracle.gram(x, x, ls_spatial=ls, outputscale=os_)
    return params, kernel_params_from_numpy(_np_params(params)), x, K, noise**2


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _grid(rows, cols):
    r, c = np.divmod(np.arange(rows * cols), cols)
    return np.stack([c, r], 1).astype(np.float32)


@pytest.mark.parametrize("case", ["uniform", "padded", "start", "int_grid_ties"])
def test_kcenter_matches_reference(rng, case):
    if case == "int_grid_ties":  # distances tie massively: first max wins
        x, m, kw = _grid(24, 24), 64, {}
    else:
        x, m, kw = rng.uniform(0, 10, (300, 2)).astype(np.float32), 32, {}
    n_valid = None
    if case == "padded":
        xp, _ = tacq.pad_candidates(_t(x), torch.ones(300), align=512)
        x, n_valid = xp.numpy(), 300
    if case == "start":
        kw = dict(start=100)
    want = np.asarray(jlr.kcenter_indices(
        jnp.asarray(x), m, None if n_valid is None else jnp.asarray(n_valid), **kw))
    got = tlr.kcenter_indices(_t(x), m, n_valid, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == m and (got < len(x) if n_valid is None
                                         else got < n_valid).all()


def test_kcenter_live_count_contract():
    tlr.check_kcenter_m(30, 24, "probe")
    with pytest.raises(ValueError, match="k-center"):
        tlr.check_kcenter_m(10, 24, "probe")


def test_jitter_ladder_is_the_plain_factor_or_the_first_finite_try(rng):
    x = rng.uniform(0, 10, (40, 2))
    K = _t(oracle.gram(x, x, ls_spatial=2.0, outputscale=1.3) + 1e-2 * np.eye(40))
    L, jit = tla.jitter_ladder_cholesky(K, initial_jitter=1e-5)
    assert torch.equal(L, tla.cholesky(K)) and float(jit) == 0.0
    # a duplicated dense design: not PD in f32, rescued by the ladder
    xd = np.concatenate([x, x[:10]])
    Kd = _t(oracle.gram(xd, xd, ls_spatial=6.0, outputscale=1.0))
    assert not torch.isfinite(tla.cholesky(Kd)).all()
    L, jit = tla.jitter_ladder_cholesky(Kd, initial_jitter=1e-5)
    Lh, jith = tla.safe_cholesky(Kd, initial_jitter=1e-5)
    Lj, jitj = jla.safe_cholesky(jnp.asarray(Kd.numpy()), initial_jitter=1e-5)
    assert torch.isfinite(L).all() and float(jit) > 0
    assert torch.equal(L, Lh) and float(jit) == float(jith)
    assert float(jit) == pytest.approx(float(jitj), rel=1e-6)


def test_seed_matches_reference_and_dense_woodbury(rng):
    params, tparams, x, K, nv = setup_field(rng, n=200)
    zidx = np.arange(0, 200, 4)
    want = jlr.lowrank_precision_seed(
        SPEC, params, jnp.asarray(x, jnp.float32), jnp.full((200,), nv, jnp.float32),
        jnp.asarray(x[zidx], jnp.float32))
    got = tlr.lowrank_precision_seed(TSPEC, tparams, _t(x), torch.full((200,), nv),
                                     _t(x[zidx]))
    assert got.VT.is_contiguous()
    for name in ("dinv", "pdiag"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=5e-3)
    # V's entries are not well determined, its Gram VᵀV (what P̃ uses) is
    VVt, jV = got.VT.numpy(), np.asarray(want.VT)
    VVt, jVVt = VVt @ VVt.T, jV @ jV.T
    assert np.abs(VVt - jVVt).max() <= 5e-3 * np.abs(jVVt).max()
    P_ref = oracle.lowrank_precision(K, zidx, nv)
    np.testing.assert_allclose(got.pdiag.numpy(), np.diag(P_ref), rtol=3e-3, atol=1e-3)
    # the algebra: the port's seed run in f64 meets the f64 oracle's columns
    # within 1e-6 of their largest entry (2e-8 measured)
    p64 = tk.KernelParams(**{k: torch.tensor(v, dtype=torch.float64)
                          for k, v in _np_params(params).items()})
    got64 = tlr.lowrank_precision_seed(TSPEC, p64, _t(x, torch.float64),
                                       torch.full((200,), nv, dtype=torch.float64),
                                       _t(x[zidx], torch.float64))
    assert got64.VT.dtype == torch.float64
    # the f32 rounding: at j = 131 both packages' f32 columns lie ≈ 3e-4 of
    # the largest entry from the oracle's (the reference's 2.93e-4, the
    # port's 3.24e-4), so the f32 column is held to the reference's f32
    # column (5.2e-5 apart), within 3e-4 of its largest entry
    for j in (0, 57, 131):
        col64 = tlr._precision_col(got64, torch.tensor([j])).numpy()
        assert np.abs(col64 - P_ref[:, j]).max() <= 1e-6 * np.abs(P_ref[:, j]).max()
        col = tlr._precision_col(got, torch.tensor([j])).numpy()
        jcol = np.asarray(jlr._precision_col(want, jnp.asarray(j)))
        assert np.abs(col - jcol).max() <= 3e-4 * np.abs(jcol).max()


def test_v_rows_at_matches_full_seed(rng):
    n = 150
    x = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    tp = TSPEC.init_params(ls_spatial=2.0, outputscale=1.3, noise=0.12)
    xt = _t(x)
    z = xt.index_select(0, tlr.kcenter_indices(xt, 40))
    full = tlr.lowrank_seed_with_z(TSPEC, tp, xt, z, nv_mult=1.5)
    fac = tlr.lowrank_factors_seed(TSPEC, tp, xt, z, nv_mult=1.5)
    rows = torch.tensor(rng.choice(n, 30, replace=False))
    nv = torch.clamp_min(tp.noise_var, 1e-6) * 1.5
    VT_r, dinv_r = tlr.v_rows_at(TSPEC, tp, fac, xt[rows], torch.ones(30) * nv)
    # f32 tolerance, not bitwise: a solve's bits depend on its RHS width
    np.testing.assert_allclose(VT_r.numpy(), full.VT[rows].numpy(), rtol=5e-3, atol=2e-4)
    np.testing.assert_allclose(dinv_r.numpy(), full.dinv[rows].numpy(), rtol=5e-3)


def test_corrections_at_matches_full_and_reference(rng):
    params, tparams, x, K, nv = setup_field(rng, n=160)
    seed = tlr.lowrank_precision_seed(TSPEC, tparams, _t(x), torch.full((160,), nv),
                                      _t(x[::3]))
    idx = torch.tensor([5, 40, 5, 99, 0, 0])  # slots 4-5 padded, slot 2 a dup
    rows = torch.tensor([0, 5, 17, 40, 99, 150, 17])
    F, ZT = tlr.lowrank_corrections(seed, idx, 4)
    F_r, ZT_r = tlr.lowrank_corrections_at(seed, idx, 4, rows)
    np.testing.assert_allclose(F_r.numpy(), F[rows].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ZT_r.numpy(), ZT[rows].numpy(), rtol=1e-5, atol=1e-5)
    jseed = jlr.LowRankPrecision(*(jnp.asarray(getattr(seed, k).numpy())
                                   for k in ("VT", "dinv", "pdiag")))
    jF, jZT = jlr.lowrank_corrections_at(jseed, jnp.asarray(idx.numpy(), jnp.int32),
                                         jnp.asarray(4), jnp.asarray(rows.numpy(), jnp.int32))
    np.testing.assert_allclose(F_r.numpy(), np.asarray(jF), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ZT_r.numpy(), np.asarray(jZT), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("num_pilot", [0, 6])
def test_greedy_selection_matches_reference_and_oracle(rng, num_pilot):
    params, tparams, x, K, nv = setup_field(rng, n=240)
    rounds = 18
    pilot = rng.choice(len(x), size=num_pilot, replace=False)
    zidx = tlr.kcenter_indices(_t(x), 60).numpy()
    want = jlr.greedy_select_lowrank(
        SPEC, params, jnp.asarray(x, jnp.float32), jnp.full((240,), nv, jnp.float32),
        jnp.asarray(pilot, jnp.int32), jnp.asarray(x[zidx], jnp.float32),
        rounds=rounds, num_pilot=num_pilot)
    got = tlr.greedy_select_lowrank(
        TSPEC, tparams, _t(x), torch.full((240,), nv), torch.tensor(pilot),
        _t(x[zidx]), rounds=rounds, num_pilot=num_pilot, return_scores=True)
    sel_ref, traces = oracle.greedy_mi_selection_lowrank(K, zidx, nv, rounds, pilot)
    scores = got.scores.numpy()
    for r in range(rounds):
        live = np.isfinite(traces[r])
        np.testing.assert_allclose(scores[r][live], traces[r][live], rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(got.selected.numpy(), sel_ref)
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(want.selected))
    np.testing.assert_allclose(got.post_var.numpy(), np.asarray(want.post_var), atol=1e-4)


def test_full_inducing_equals_the_exact_path(rng):
    """z = x: the factorization is exact up to the K_zz jitter, so the
    selections equal the exact path's and the exact f64 oracle's."""
    params, tparams, x, K, nv = setup_field(rng, n=220)
    pilot = rng.choice(len(x), size=5, replace=False)
    args = (TSPEC, tparams, _t(x), torch.full((220,), nv), torch.tensor(pilot))
    lr = tlr.greedy_select_lowrank(*args, _t(x), rounds=15, num_pilot=5)
    ex = tacq.greedy_select(*args, rounds=15, num_pilot=5, strategy="mi")
    sel_ref, _ = oracle.greedy_mi_selection(K, nv, 15, pilot)
    np.testing.assert_array_equal(lr.selected.numpy(), ex.selected.numpy())
    np.testing.assert_array_equal(lr.selected.numpy(), sel_ref)


def test_duplicate_pilots_stay_finite(rng):
    params, tparams, x, K, nv = setup_field(rng, n=150)
    pilot = np.array([3, 17, 3, 99])  # node 3 measured twice
    got = tlr.greedy_select_lowrank(
        TSPEC, tparams, _t(x), torch.full((150,), nv), torch.tensor(pilot),
        _t(x[::3]), rounds=10, num_pilot=4)
    want = jlr.greedy_select_lowrank(
        SPEC, params, jnp.asarray(x, jnp.float32), jnp.full((150,), nv, jnp.float32),
        jnp.asarray(pilot, jnp.int32), jnp.asarray(x[::3], jnp.float32),
        rounds=10, num_pilot=4)
    assert torch.isfinite(got.post_var).all()
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(want.selected))
    assert not np.isin(got.selected.numpy(), pilot).any()


def test_score_sets_lowrank_matches_reference(rng):
    params, tparams, x, K, nv = setup_field(rng, n=80)
    zidx = np.arange(0, 80, 2)
    deleted = np.array([6, 41, 70, 0])
    seed = tlr.lowrank_precision_seed(TSPEC, tparams, _t(x), torch.full((80,), nv),
                                      _t(x[zidx]))
    F, ZT = tlr.lowrank_corrections(seed, torch.tensor(deleted), 3)
    taken = torch.zeros(80, dtype=torch.bool)
    taken[deleted[:3]] = True
    sets = np.array([[5, 6, 7], [40, 41, 60], [10, 20, 30], [9, 9, 11]])
    sizes = np.array([3, 3, 2, 3])  # sets 0/1 hold deleted nodes, 3 a repeat
    got = tacq.score_candidate_sets(
        TSPEC, tparams, _t(x), torch.full((80,), nv), torch.zeros((4, 80)),
        torch.tensor(sets), torch.tensor(sizes),
        P_lowrank=(seed.VT, seed.dinv, F, ZT, taken), strategy="mi")
    jseed = [jnp.asarray(t.numpy()) for t in (seed.VT, seed.dinv, F, ZT, taken)]
    want = jacq.score_candidate_sets(
        SPEC, params, jnp.asarray(x, jnp.float32), jnp.full((80,), nv, jnp.float32),
        jnp.zeros((4, 80), jnp.float32), jnp.asarray(sets, jnp.int32),
        jnp.asarray(sizes, jnp.int32), P_lowrank=tuple(jseed), strategy="mi")
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-4)
    # the pregathered form is the same scores
    rows = torch.tensor(sets.reshape(-1))
    got2 = tacq.score_candidate_sets(
        TSPEC, tparams, _t(x), torch.full((80,), nv), torch.zeros((4, 80)),
        torch.tensor(sets), torch.tensor(sizes),
        P_lowrank=(seed.VT, seed.dinv, F[rows], ZT[rows], taken), strategy="mi",
        corrections_pregathered=True)
    assert torch.equal(got, got2)


def _step_inputs(rng, n=180, cap=16, S=10, k=5):
    x = rng.uniform(0, 11, (n, 2)).astype(np.float32)
    idx = np.pad(rng.choice(n, 11, replace=False), (0, cap - 11))
    ns = np.pad(rng.uniform(1.0, 4.0, 11).astype(np.float32), (0, cap - 11),
                constant_values=1.0)
    y = np.pad(rng.standard_normal(11).astype(np.float32), (0, cap - 11))
    sets = rng.integers(0, n, (S, k))
    sizes = rng.integers(1, k + 1, S)
    costs = rng.uniform(2.0, 6.0, S).astype(np.float32)
    return x, idx, ns, y, sets, sizes, costs


def test_factors_step_picks_the_reference_path(rng):
    x, idx, ns, y, sets, sizes, costs = _step_inputs(rng)
    tp = TSPEC.init_params(ls_spatial=2.0, outputscale=1.3, noise=0.12)
    jp = SPEC.init_params(ls_spatial=2.0, outputscale=1.3, noise=0.12)
    xt = _t(x)
    z = xt.index_select(0, tlr.kcenter_indices(xt, 36))
    targs = (TSPEC, tp, xt, torch.tensor(idx), 11, _t(ns), _t(y), torch.tensor(sets),
             torch.tensor(sizes), _t(costs))
    fac = tlr.lowrank_factors_seed(TSPEC, tp, xt, z, nv_mult=1.5)
    b2, mean2, d2, s2 = tlr.plan_episode_step_lowrank_factors(*targs, fac, nv_mult=1.5)
    full = tlr.lowrank_seed_with_z(TSPEC, tp, xt, z, nv_mult=1.5)
    b1, mean1, d1, s1 = tlr.plan_episode_step_lowrank(*targs, full, nv_mult=1.5)
    assert int(b1) == int(b2)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=2e-4, atol=2e-5)
    assert torch.equal(mean1, mean2) and torch.equal(d1, d2)

    jargs = (SPEC, jp, jnp.asarray(x), jnp.asarray(idx, jnp.int32), jnp.asarray(11),
             jnp.asarray(ns), jnp.asarray(y), jnp.asarray(sets, jnp.int32),
             jnp.asarray(sizes, jnp.int32), jnp.asarray(costs))
    jfac = jlr.lowrank_factors_seed(SPEC, jp, jnp.asarray(x), jnp.asarray(z.numpy()),
                                    nv_mult=1.5)
    bj, meanj, dj, sj = jlr.plan_episode_step_lowrank_factors(*jargs, jfac, nv_mult=1.5)
    assert int(bj) == int(b2)
    np.testing.assert_allclose(s2.numpy(), np.asarray(sj), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(mean2.numpy(), np.asarray(meanj), atol=1e-4)
    np.testing.assert_allclose(d2.numpy(), np.asarray(dj), atol=1e-4)
    # an ensemble of two copies of the design is the design
    b3, mean3, _, s3 = tlr.plan_episode_step_lowrank_factors(
        *targs, [fac, fac], nv_mult=1.5)
    assert int(b3) == int(b2) and torch.equal(mean3, mean2)
    np.testing.assert_allclose(s3.numpy(), s2.numpy(), rtol=1e-6, atol=1e-6)


def test_fitc_truth_on_given_draws_matches_reference():
    cfg = dict(num_rows=24, num_cols=24, true_ls_spatial=6.0, synth_inducing=64, seed=3)
    ref = JFieldEnv(jc.FieldConfig(**cfg), SPEC)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    draws = (np.asarray(jax.random.normal(k1, (64, 1))),
             np.asarray(jax.random.normal(k2, (576, 1))))
    before = tgram.LAUNCHES
    got = FieldEnv(tc.FieldConfig(**cfg), TSPEC, device="cpu", draws=draws)
    assert tgram.LAUNCHES == before  # CPU: the plain Gram
    # within 1e-3 of max|f|: the solve by an ill-conditioned L_zz (64
    # centers 3 apart at lengthscale 6) amplifies the f32 rounding
    assert np.abs(got.f - ref.f).max() <= 1e-3 * np.abs(ref.f).max()
    np.testing.assert_array_equal(got.test_mask, ref.test_mask)
    own = FieldEnv(tc.FieldConfig(**cfg), TSPEC, device="cpu")  # own draws
    assert np.isfinite(own.f).all() and 0.2 < own.f.var() < 5.0
    F = own.f.reshape(24, 24)
    assert np.corrcoef(F[:, :-1].ravel(), F[:, 1:].ravel())[0, 1] > 0.9


def test_fit_and_select_lowrank_matches_reference(rng):
    n = 260
    x = rng.uniform(0, 12, (n, 2)).astype(np.float32)
    tr = rng.choice(n, size=40, replace=False)
    y = rng.standard_normal(n)[tr].astype(np.float32)
    fitcfg = jc.FitConfig(iters=30, restarts=2)
    key = jax.random.PRNGKey(5)
    jfit, jsel = jlr.fit_and_select_lowrank(
        SPEC, fitcfg, jnp.asarray(x[tr]), jnp.asarray(y), jnp.asarray(x),
        jnp.asarray(tr, jnp.int32), rounds=12, num_pilot=40, num_inducing=64, key=key)
    inits = kernel_params_from_numpy(_np_params(jgp.make_restart_inits(SPEC, fitcfg, key)))
    tfit, tsel = tlr.fit_and_select_lowrank(
        TSPEC, tc.FitConfig(iters=30, restarts=2), _t(x[tr]), _t(y), _t(x),
        torch.tensor(tr), rounds=12, num_pilot=40, num_inducing=64, inits=inits)
    np.testing.assert_allclose(float(tfit.nll), float(jfit.nll), rtol=1e-4)
    np.testing.assert_array_equal(tsel.selected.numpy(), np.asarray(jsel.selected))
    assert tsel.post_var.shape == (n,)


def test_cli_greedy_lowrank_on_the_cpu(capsys):
    assert cli.main(["--mode", "greedy", "--rows", "10", "--cols", "12",
                     "--acq-rounds", "8", "--num-pilot", "10", "--iters", "20",
                     "--restarts", "2", "--strategy", "mi", "--num-inducing", "24",
                     "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_sampled"] == 18 and np.isfinite(rec["final_rmse"])


def _episode_configs():
    """A small c5_100k-shaped episode: FITC truth, low-rank planner, warm
    refits, device metrics forced on (auto from 16 384 points)."""
    def build(mod, KS):
        return mod.ExperimentConfig(
            kernel=KS("matern32", ds=2),
            field=mod.FieldConfig(num_rows=12, num_cols=16, true_ls_spatial=3.0,
                                  synth_inducing=48, seed=5),
            fit=mod.FitConfig(iters=10, restarts=2, refit_iters=5, refit_restarts=2),
            acquisition=mod.AcquisitionConfig(strategy="mi", num_inducing=40),
            episode=mod.EpisodeConfig(num_pilot=12, budget=40.0, refit_every=2,
                                      samples_per_step=6, seed=5, device_metrics=True),
        )
    return build(jc, KernelSpec), build(tc, tk.KernelSpec)


def test_lowrank_episode_matches_reference(monkeypatch):
    monkeypatch.setattr(tgp, "step_inits", _reference_step_inits)
    jcfg, tcfg = _episode_configs()
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")
    want = JAgent(jenv, jcfg).run(max_steps=6)
    agent = Agent(tenv, tcfg)
    got = agent.run(max_steps=6)
    hj, ht = _plan_records(want.history), _plan_records(got.history)
    assert len(ht) == len(hj) >= 4
    for a, b in zip(hj, ht):  # the same sites at every step
        assert (b["step"], b["n_sampled"]) == (a["step"], a["n_sampled"])
        assert b["rmse_test"] == pytest.approx(a["rmse_test"], rel=1e-3)
    np.testing.assert_array_equal(got.state.sampled_idx, want.state.sampled_idx)
    assert got.rmse == pytest.approx(want.rmse, rel=1e-3)
    _same_posterior(want, got, tenv)
    # the design was computed once, over the whole grid
    assert agent._z_cache.shape == (40, 2)
