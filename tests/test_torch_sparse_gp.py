"""algp_tpu_torch.models.sparse_gp (SGPR, the collapsed bound) against
algp_tpu.models.sparse_gp and the f64 oracle `sgpr_reference`, on the CPU,
and the long-campaign episode that switches its refits to it.

Tolerances: −ELBO within rtol 2e-4 of the f64 oracle (the reference's own
bound) and 5e-5 of the reference (an f32 sum of O(10³) with
cancellation), padded slots adding nothing within 1e-5; its gradient
within rtol 1e-4 / atol 1e-5 of jax.grad's; at Z = X the bound equals the exact −MLL within rtol
2e-3.  Fits from the reference's inits: best −ELBO within rtol 1e-4,
parameters within 1e-3.  The posterior within 2e-3 (mean) / 3e-3 (var) of
the oracle.  Episode sites are equal index for index.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from algp_tpu import config as jc
from algp_tpu.episode import Agent as JAgent
from algp_tpu.field import FieldEnv as JFieldEnv
from algp_tpu.models import gp as jgp
from algp_tpu.models import sparse_gp as jsgp
from algp_tpu.ops.kernels import KernelSpec
from algp_tpu_torch import config as tc
from algp_tpu_torch.convert import (
    field_env_like, kernel_params_from_numpy, kernel_params_to_numpy,
)
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.field import FieldEnv
from algp_tpu_torch.models import gp as tgp
from algp_tpu_torch.models import sparse_gp as tsgp
from algp_tpu_torch.ops import kernels as tk

import oracle
from test_torch_episode import _plan_records, _reference_step_inits, _same_posterior
from test_torch_lowrank import _np_params, _t, setup_field

SPEC, TSPEC = KernelSpec("rbf", ds=2), tk.KernelSpec("rbf", ds=2)


@pytest.mark.parametrize("case", ["plain", "noise_scale", "num_valid"])
def test_neg_elbo_matches_oracle_and_reference(rng, case):
    params, tparams, x, K, nv = setup_field(rng, n=120)
    y = rng.standard_normal(120)
    zidx = np.arange(0, 120, 3)
    scale = np.where(np.arange(120) < 60, 1.0, 25.0)
    kw, tkw, n = {}, {}, 120
    if case == "noise_scale":
        kw, tkw = dict(noise_scale=jnp.asarray(scale, jnp.float32)), dict(noise_scale=_t(scale))
    if case == "num_valid":  # padded beyond 90: equals the 90-point bound
        n = 90
        kw, tkw = dict(num_valid=jnp.asarray(90, jnp.int32)), dict(num_valid=90)
    got = float(tsgp.neg_elbo(TSPEC, tparams, _t(x), _t(y * (np.arange(120) < n)),
                              _t(x[zidx]), **tkw))
    want = float(jsgp.neg_elbo(SPEC, params, jnp.asarray(x, jnp.float32),
                               jnp.asarray(y * (np.arange(120) < n), jnp.float32),
                               jnp.asarray(x[zidx], jnp.float32), **kw))
    ref, _, _ = oracle.sgpr_reference(
        K, zidx, y, nv * (scale if case == "noise_scale" else 1.0))
    if case == "num_valid":  # the padding adds exactly nothing
        ref = float(tsgp.neg_elbo(TSPEC, tparams, _t(x[:90]), _t(y[:90]), _t(x[zidx])))
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-4)
    np.testing.assert_allclose(got, want, rtol=5e-5)


def test_neg_elbo_gradient_and_restart_batch_match_reference(rng):
    params, tparams, x, K, nv = setup_field(rng, n=80)
    y = rng.standard_normal(80)
    z = x[::4]
    tp = tparams.map(lambda a: a.clone().requires_grad_(True))
    val = tsgp.neg_elbo(TSPEC, tp, _t(x), _t(y), _t(z))
    grads = torch.autograd.grad(val, [tp.log_ls_spatial, tp.log_outputscale, tp.log_noise])
    jval, jgrad = jax.value_and_grad(
        lambda p: jsgp.neg_elbo(SPEC, p, jnp.asarray(x, jnp.float32),
                                jnp.asarray(y, jnp.float32), jnp.asarray(z, jnp.float32))
    )(params)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    for g, name in zip(grads, ("log_ls_spatial", "log_outputscale", "log_noise")):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(jgrad, name)),
                                   rtol=1e-4, atol=1e-5)
    # a restart batch gives each restart its own value
    batched = tparams.map(lambda a: torch.stack([a, a + 0.3]))
    vals = tsgp.neg_elbo(TSPEC, batched, _t(x), _t(y), _t(z))
    one = tsgp.neg_elbo(TSPEC, tparams.map(lambda a: a + 0.3), _t(x), _t(y), _t(z))
    np.testing.assert_allclose(vals.numpy(), [float(val.detach()), float(one)], rtol=1e-5)


def test_elbo_equals_mll_at_full_z_and_bounds_it(rng):
    params, tparams, x, K, nv = setup_field(rng, n=100)
    y = _t(rng.standard_normal(100))
    xt = _t(x)
    exact = float(tgp.neg_mll(TSPEC, tparams, xt, y))
    for step in (5, 2):
        assert float(tsgp.neg_elbo(TSPEC, tparams, xt, y, xt[::step])) >= exact - 5e-3
    np.testing.assert_allclose(float(tsgp.neg_elbo(TSPEC, tparams, xt, y, xt)), exact,
                               rtol=2e-3)


def test_posterior_matches_oracle(rng):
    params, tparams, x, K, nv = setup_field(rng, n=120)
    y = rng.standard_normal(120)
    zidx = np.arange(0, 120, 2)
    _, mean_ref, var_ref = oracle.sgpr_reference(K, zidx, y, nv)
    post = tsgp.posterior_sparse(TSPEC, tparams, _t(x), _t(y), _t(x[zidx]))
    mean, var = tsgp.predict_sparse(TSPEC, tparams, post, _t(x))
    np.testing.assert_allclose(mean.numpy(), mean_ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(var.numpy(), var_ref, rtol=3e-3, atol=3e-3)


def _observed(rng, n=90):
    params, tparams, x, K, nv = setup_field(rng, n=n)
    L = np.linalg.cholesky(K + 1e-8 * np.eye(n))
    y = L @ rng.standard_normal(n) + np.sqrt(nv) * rng.standard_normal(n)
    return x, y.astype(np.float32)


def _assert_fit_equal(got, want):
    np.testing.assert_allclose(float(got.nll), float(want.nll), rtol=1e-4)
    np.testing.assert_allclose(got.all_nlls.numpy(), np.asarray(want.all_nlls), rtol=1e-4)
    for name, v in kernel_params_to_numpy(got.params).items():
        np.testing.assert_allclose(v, np.asarray(getattr(want.params, name)),
                                   rtol=1e-3, atol=1e-3)


def test_fit_sparse_from_reference_inits_matches_reference(rng):
    x, y = _observed(rng)
    cfg = jc.FitConfig(iters=25, restarts=2)
    key = jax.random.PRNGKey(1)
    want = jsgp.fit_sparse(SPEC, cfg, jnp.asarray(x, jnp.float32), jnp.asarray(y),
                           jnp.asarray(x[::3], jnp.float32), key=key)
    inits = kernel_params_from_numpy(_np_params(jgp.make_restart_inits(SPEC, cfg, key)))
    got = tsgp.fit_sparse(TSPEC, tc.FitConfig(iters=25, restarts=2), _t(x), _t(y),
                          _t(x[::3]), inits=inits)
    _assert_fit_equal(got, want)
    assert got.nll_trace.shape == (2, 25)


def _padded(x, y, cap, m):
    xp = np.zeros((cap, 2), np.float32)
    xp[:m] = x[:m]
    yp = np.zeros(cap, np.float32)
    yp[:m] = y[:m]
    return xp, yp


@pytest.mark.parametrize("warm", [False, True])
def test_fit_step_sparse_matches_reference(rng, monkeypatch, warm):
    """The episode's sparse refits: a k-center design over the valid rows
    and the reference's fold_in(PRNGKey(seed), step) inits (the port's own
    come from `gp.step_inits`, replaced here)."""
    monkeypatch.setattr(tgp, "step_inits", _reference_step_inits)
    x, y = _observed(rng, 80)
    xp, yp = _padded(x, y, 96, 70)
    fields = dict(iters=20, restarts=2, sparse_inducing=24, refit_iters=8,
                  refit_restarts=2)
    jcfg, tcfg = jc.FitConfig(**fields), tc.FitConfig(**fields)
    if warm:
        tinc = TSPEC.init_params(ls_spatial=1.7, outputscale=1.2, noise=0.2)
        inc = SPEC.init_params(ls_spatial=1.7, outputscale=1.2, noise=0.2)
        want = jsgp.fit_step_sparse_warm(
            SPEC, jcfg, jnp.asarray(xp), jnp.asarray(yp), None, jax.random.PRNGKey(7), 3,
            num_valid=jnp.asarray(70, jnp.int32), incumbent=inc, num_inducing=24)
        got = tsgp.fit_step_sparse_warm(TSPEC, tcfg, _t(xp), _t(yp), None, 7, 3, 70,
                                        tinc, num_inducing=24)
        assert got.nll_trace.shape == (2, 8)
    else:
        want = jsgp.fit_step_sparse(
            SPEC, jcfg, jnp.asarray(xp), jnp.asarray(yp), None, jax.random.PRNGKey(7), 3,
            num_valid=jnp.asarray(70, jnp.int32), num_inducing=24)
        got = tsgp.fit_step_sparse(TSPEC, tcfg, _t(xp), _t(yp), None, 7, 3, 70,
                                   num_inducing=24)
    _assert_fit_equal(got, want)


def test_warm_sparse_refit_never_worse_than_incumbent(rng):
    x, y = _observed(rng, 80)
    xp, yp = _padded(x, y, 96, 80)
    cfg = tc.FitConfig(iters=30, restarts=2, sparse_inducing=24, refit_iters=8,
                       refit_restarts=2)
    inc = tsgp.fit_step_sparse(TSPEC, cfg, _t(xp), _t(yp * (np.arange(96) < 60)),
                               None, 11, 0, 60, num_inducing=24)
    warm = tsgp.fit_step_sparse_warm(TSPEC, cfg, _t(xp), _t(yp), None, 11, 4, 80,
                                     inc.params, num_inducing=24)
    xt = _t(xp)
    z = xt.index_select(0, tsgp.kcenter_indices(xt, 24, 80))
    inc_elbo = float(tsgp.neg_elbo(TSPEC, inc.params, xt, _t(yp), z, num_valid=80))
    assert np.isfinite(float(warm.nll)) and float(warm.nll) <= inc_elbo + 1e-3


def test_kcenter_contract_and_duplicate_heavy_set(rng):
    cfg = tc.FitConfig(iters=30, restarts=2)
    x = _t(rng.uniform(0, 8, (32, 2)))
    y = _t(rng.standard_normal(32))
    with pytest.raises(ValueError, match="k-center"):
        tsgp.fit_step_sparse(TSPEC, cfg, x, y, None, 0, 0, 10, num_inducing=24)
    # fewer distinct points than inducing ones: the chain repeats live rows
    x10 = rng.uniform(0, 8, (10, 2)).astype(np.float32)
    rep = rng.integers(0, 10, 40)
    f = np.sin(x10[:, 0]) + 0.3 * x10[:, 1]
    model = tsgp.SparseGP(TSPEC, num_inducing=24, fit_config=cfg, device="cpu")
    model.fit(x10[rep], f[rep] + 0.05 * rng.standard_normal(40),
              generator=torch.Generator().manual_seed(3))
    mean, var = model.predict(x10)
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()
    assert np.sqrt(((mean.numpy() - f) ** 2).mean()) < 0.5 * np.std(f)


def test_sparse_gp_facade_tracks_the_field(rng):
    n = 300
    x = rng.uniform(0, 12, (n, 2))
    K = oracle.gram(x, x, ls_spatial=2.0, outputscale=1.5)
    f = np.linalg.cholesky(K + 1e-8 * np.eye(n)) @ rng.standard_normal(n)
    model = tsgp.SparseGP(TSPEC, num_inducing=64,
                          fit_config=tc.FitConfig(iters=40, restarts=2), device="cpu")
    model.fit(x, f + 0.1 * rng.standard_normal(n),
              generator=torch.Generator().manual_seed(0))
    mean, var = model.predict(x)
    assert np.sqrt(np.mean((mean.numpy() - f) ** 2)) < 0.35 * np.sqrt(np.mean(f**2))
    assert torch.isfinite(var).all()


def _long_configs():
    """A small c5_long-shaped campaign: the exact planner, warm refits, and
    a lowered sparse_threshold the sampled set crosses mid-episode."""
    def build(mod, KS):
        return mod.ExperimentConfig(
            kernel=KS("matern32", ds=2),
            field=mod.FieldConfig(num_rows=10, num_cols=14, seed=5),
            fit=mod.FitConfig(iters=10, restarts=2, sparse_threshold=30,
                              sparse_inducing=24, refit_iters=5, refit_restarts=2),
            acquisition=mod.AcquisitionConfig(strategy="mi"),
            episode=mod.EpisodeConfig(num_pilot=12, budget=60.0, num_waypoints=6,
                                      samples_per_step=6, refit_every=2, seed=2),
        )
    return build(jc, KernelSpec), build(tc, tk.KernelSpec)


def test_long_episode_with_sparse_refits_matches_reference(monkeypatch):
    monkeypatch.setattr(tgp, "step_inits", _reference_step_inits)
    calls = []
    for name in ("fit_step_sparse", "fit_step_sparse_warm"):
        orig = getattr(tsgp, name)
        monkeypatch.setattr(tsgp, name, lambda *a, _o=orig, **k: (calls.append(1), _o(*a, **k))[1])
    jcfg, tcfg = _long_configs()
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")  # before the reference's run draws noise
    want = JAgent(jenv, jcfg).run(max_steps=7)
    got = Agent(tenv, tcfg).run(max_steps=7)
    assert calls and len(got.state.sampled_idx) > 30  # crossed the threshold
    hj, ht = _plan_records(want.history), _plan_records(got.history)
    assert len(ht) == len(hj) >= 5
    for a, b in zip(hj, ht):  # the same sites at every step
        assert (b["step"], b["n_sampled"]) == (a["step"], a["n_sampled"])
        assert b["rmse_test"] == pytest.approx(a["rmse_test"], rel=1e-3)
    np.testing.assert_array_equal(got.state.sampled_idx, want.state.sampled_idx)
    assert got.rmse == pytest.approx(want.rmse, rel=1e-3)
    assert got.rmse_test < ht[0]["rmse_test"]
    _same_posterior(want, got, tenv)


def test_sparse_threshold_below_the_inducing_count_is_refused():
    _, cfg = _long_configs()
    bad = dataclasses.replace(cfg, fit=tc.FitConfig(sparse_threshold=16,
                                                    sparse_inducing=32))
    with pytest.raises(ValueError, match="sparse_threshold"):
        Agent(FieldEnv(cfg.field, cfg.kernel, device="cpu"), bad)
