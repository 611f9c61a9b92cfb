"""algp_tpu_torch.models.gp (the multi-restart MLL fit) against
algp_tpu.models.gp, fed the reference's own restart inits."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from algp_tpu.config import FitConfig
from algp_tpu.models import gp as jgp
from algp_tpu.ops import kernels as jk
from algp_tpu_torch.config import FitConfig as TFitConfig
from algp_tpu_torch.convert import kernel_params_from_numpy, kernel_params_to_numpy
from algp_tpu_torch.models import gp as tgp
from algp_tpu_torch.ops import kernels as tk


def _np_params(p):
    return {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}


@pytest.mark.parametrize("spec_args,noise_scale,num_valid", [
    (("rbf", "rbf", 2, 0), False, None),
    (("matern52", "rbf", 2, 3), True, None),
    (("matern32", "rbf", 2, 0), False, 17),
])
def test_neg_mll_value_and_gradient_match_reference(rng, spec_args, noise_scale,
                                                    num_valid):
    jspec, tspec = jk.KernelSpec(*spec_args), tk.KernelSpec(*spec_args)
    n = 24
    x = rng.uniform(0, 8, (n, jspec.dim)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    if num_valid is not None:
        y[num_valid:] = 0.0
    ns = rng.uniform(0.5, 4.0, n).astype(np.float32) if noise_scale else None
    p = jspec.init_params(ls_spatial=1.7, ls_feature=0.9, outputscale=1.3, noise=0.2)
    kw = dict(min_noise=1e-3, jitter=1e-6)

    def jloss(q):
        return jgp.neg_mll(jspec, q, jnp.asarray(x), jnp.asarray(y),
                           None if ns is None else jnp.asarray(ns),
                           num_valid=None if num_valid is None else jnp.asarray(num_valid),
                           **kw)

    jval, jgrad = jax.value_and_grad(jloss)(p)
    tp = kernel_params_from_numpy(_np_params(p))
    tp = tp.map(lambda t: t.requires_grad_(True))
    tval = tgp.neg_mll(tspec, tp, torch.tensor(x), torch.tensor(y),
                       None if ns is None else torch.tensor(ns),
                       num_valid=num_valid, **kw)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    for name, g in _np_params(jgrad).items():
        leaf = getattr(tp, name)
        got = np.zeros(g.shape, np.float32) if leaf.grad is None else leaf.grad.numpy()
        np.testing.assert_allclose(got, g, rtol=1e-4, atol=1e-5)


def test_neg_mll_batched_equals_per_restart(rng):
    tspec = tk.KernelSpec("rbf", ds=2)
    x = torch.tensor(rng.uniform(0, 8, (20, 2)), dtype=torch.float32)
    y = torch.tensor(rng.standard_normal(20), dtype=torch.float32)
    inits = tgp.make_restart_inits(tspec, TFitConfig(restarts=3),
                                   torch.Generator().manual_seed(1))
    batched = tgp.neg_mll(tspec, inits, x, y)
    assert batched.shape == (3,)
    for r in range(3):
        one = tgp.neg_mll(tspec, inits.map(lambda a: a[r]), x, y)
        torch.testing.assert_close(batched[r], one, rtol=1e-6, atol=1e-6)


def test_adam_step_follows_optax(rng):
    """The written-out Adam reproduces optax.adam's update sequence."""
    p0 = rng.standard_normal(5).astype(np.float32)
    grads = rng.standard_normal((60, 5)).astype(np.float32)
    opt = optax.adam(0.05)
    pj, state = jnp.asarray(p0), None
    state = opt.init(pj)
    pt, mu, nu = torch.tensor(p0), [torch.zeros(5)], [torch.zeros(5)]
    for t, g in enumerate(grads, start=1):
        upd, state = opt.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        u, mu, nu = tgp._adam_step([torch.tensor(g)], mu, nu, t)
        pt = pt + (-0.05) * u[0]
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)


def test_fit_with_reference_inits_matches_reference(rng):
    spec, tspec = jk.KernelSpec("rbf", ds=2), tk.KernelSpec("rbf", ds=2)
    cfg, tcfg = FitConfig(iters=40, restarts=3), TFitConfig(iters=40, restarts=3)
    x = rng.uniform(0, 10, (30, 2)).astype(np.float32)
    y = np.sin(x[:, 0] / 2) + 0.1 * rng.standard_normal(30).astype(np.float32)
    y = y.astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jgp.fit(spec, cfg, jnp.asarray(x), jnp.asarray(y), key=key)
    inits = kernel_params_from_numpy(_np_params(jgp.make_restart_inits(spec, cfg, key)))
    got = tgp.fit(tspec, tcfg, torch.tensor(x), torch.tensor(y), inits=inits)
    np.testing.assert_allclose(float(got.nll), float(want.nll), rtol=1e-4)
    np.testing.assert_allclose(got.all_nlls.numpy(), np.asarray(want.all_nlls),
                               rtol=1e-4)
    assert int(got.best_restart) == int(want.best_restart)
    assert got.nll_trace.shape == (3, 40)
    np.testing.assert_allclose(got.nll_trace.numpy(), np.asarray(want.nll_trace),
                               rtol=1e-4, atol=1e-4)
    for name, v in kernel_params_to_numpy(got.params).items():
        np.testing.assert_allclose(v, np.asarray(getattr(want.params, name)),
                                   atol=1e-3)


def test_fixed_noise_fit_keeps_noise(rng):
    tspec = tk.KernelSpec("rbf", ds=2)
    cfg = TFitConfig(iters=10, restarts=2, learn_noise=False)
    x = torch.tensor(rng.uniform(0, 10, (15, 2)), dtype=torch.float32)
    y = torch.tensor(rng.standard_normal(15), dtype=torch.float32)
    inits = tgp.make_restart_inits(tspec, cfg, torch.Generator().manual_seed(0))
    res = tgp.fit(tspec, cfg, x, y, inits=inits)
    k = int(res.best_restart)
    assert float(res.params.log_noise) == float(inits.log_noise[k])


def test_diverged_restart_stays_in_its_own_restart(rng):
    """A restart whose factor fails (NaN loss and NaN gradient) never wins
    and leaves the other restarts' trajectories untouched (the batched
    Cholesky and its gradient are per restart; the non-finite guard)."""
    tspec = tk.KernelSpec("rbf", ds=2)
    cfg = TFitConfig(iters=15, restarts=2)
    x = torch.tensor(rng.uniform(0, 10, (15, 2)), dtype=torch.float32)
    y = torch.tensor(rng.standard_normal(15), dtype=torch.float32)
    inits = tgp.make_restart_inits(tspec, cfg, torch.Generator().manual_seed(0))
    inits.log_outputscale[0] = torch.nan
    loss = lambda p: tgp.neg_mll(tspec, p, x, y)

    best_p, best_nll, trace = tgp._opt_loop(cfg, loss, inits)
    assert torch.isnan(trace[0]).all()
    assert torch.isinf(best_nll[0]) and torch.isfinite(best_nll[1])
    alone_p, alone_nll, alone_trace = tgp._opt_loop(
        cfg, loss, inits.map(lambda a: a[1:])
    )
    torch.testing.assert_close(trace[1], alone_trace[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(best_nll[1], alone_nll[0], rtol=1e-6, atol=1e-6)


def test_restart_inits_layout():
    tspec = tk.KernelSpec("matern52", "rbf", ds=2, df=3)
    cfg = TFitConfig(restarts=4, init_ls_spatial=2.0, init_noise=0.3)
    inits = tgp.make_restart_inits(tspec, cfg, torch.Generator().manual_seed(0))
    assert inits.log_ls_spatial.shape == (4, 2)
    assert inits.log_ls_feature.shape == (4, 3)
    assert inits.log_noise.shape == (4,)
    base = tspec.init_params(ls_spatial=2.0, noise=0.3)
    assert torch.equal(inits.log_ls_spatial[0], base.log_ls_spatial)
    assert torch.equal(inits.log_noise[0], base.log_noise)
    assert not torch.equal(inits.log_noise[1], base.log_noise)


# ------------------------------------------------- the episode surfaces


def _posterior_case(rng, n_max=24, m=17, noise_scale=True):
    spec = jk.KernelSpec("matern32", ds=2)
    p = spec.init_params(ls_spatial=2.2, outputscale=1.4, noise=0.15)
    x = rng.uniform(0, 8, (n_max, 2)).astype(np.float32)
    y = rng.standard_normal(n_max).astype(np.float32)
    y[m:] = 0.0
    ns = rng.uniform(1.0, 9.0, n_max).astype(np.float32) if noise_scale else None
    xt = rng.uniform(0, 8, (40, 2)).astype(np.float32)
    return spec, tk.KernelSpec("matern32", ds=2), p, x, y, ns, xt


@pytest.mark.parametrize("noise_scale", [False, True])
def test_posterior_and_predict_match_reference(rng, noise_scale):
    spec, tspec, p, x, y, ns, xt = _posterior_case(rng, noise_scale=noise_scale)
    tp = kernel_params_from_numpy(_np_params(p))
    kw = dict(min_noise=1e-3, jitter=1e-6)
    jpost, jmean, jvar = jgp.posterior_and_predict(
        spec, p, jnp.asarray(x), jnp.asarray(y),
        None if ns is None else jnp.asarray(ns), jnp.asarray(xt), **kw,
        has_noise_scale=ns is not None, num_valid=jnp.asarray(17),
        has_num_valid=True,
    )
    tpost, tmean, tvar = tgp.posterior_and_predict(
        tspec, tp, torch.tensor(x), torch.tensor(y),
        None if ns is None else torch.tensor(ns), torch.tensor(xt), num_valid=17,
        **kw,
    )
    np.testing.assert_allclose(tpost.L.numpy(), np.asarray(jpost.L), atol=1e-5)
    np.testing.assert_allclose(tpost.alpha.numpy(), np.asarray(jpost.alpha),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tpost.mask.numpy(), np.asarray(jpost.mask))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), atol=1e-4)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), atol=1e-4)
    assert (tvar >= 0).all()


def test_extend_and_predict_matches_reference_and_refactorization(rng):
    """Growing the factor by k rows equals the reference's growth and the
    posterior refactorized from scratch on the same samples."""
    spec, tspec, p, x, y, _, xt = _posterior_case(rng, m=20, noise_scale=False)
    tp = kernel_params_from_numpy(_np_params(p))
    m0, k_max, k = 14, 5, 4
    nv = float(np.exp(2 * np.log(np.float32(0.15))))
    new_nv = np.full(k_max, 1.0, np.float32)
    new_nv[:k] = nv
    y_old = y.copy()
    y_old[m0:] = 0.0
    jpost = jgp.posterior(spec, p, jnp.asarray(x), jnp.asarray(y_old),
                          num_valid=jnp.asarray(m0))
    tpost = tgp.posterior(tspec, tp, torch.tensor(x), torch.tensor(y_old),
                          num_valid=m0)
    y_new = y.copy()
    y_new[m0 + k:] = 0.0
    _, jmean, jvar = jgp.extend_and_predict(
        spec, p, jpost, jnp.asarray(x), jnp.asarray(y_new), jnp.asarray(new_nv),
        jnp.asarray(m0), jnp.asarray(k), jnp.asarray(xt),
    )
    L0 = tpost.L.clone()
    post2, tmean, tvar = tgp.extend_and_predict(
        tspec, tp, tpost, torch.tensor(x), torch.tensor(y_new),
        torch.tensor(new_nv), m0, k, torch.tensor(xt),
    )
    assert torch.equal(tpost.L, L0)  # the cached factor is left as it was
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), atol=1e-4)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), atol=1e-4)
    _, fmean, fvar = tgp.posterior_and_predict(
        tspec, tp, torch.tensor(x), torch.tensor(y_new), None, torch.tensor(xt),
        num_valid=m0 + k)
    np.testing.assert_allclose(tmean.numpy(), fmean.numpy(), atol=1e-4)
    np.testing.assert_allclose(tvar.numpy(), fvar.numpy(), atol=1e-4)
    assert post2.mask.sum() == m0 + k


def test_warm_refit_matches_reference(rng):
    """fit_step_warm: restart 0 from the incumbent, refit_cfg's schedule;
    fed the reference's step inits, the port lands on the reference's fit."""
    spec, tspec = jk.KernelSpec("rbf", ds=2), tk.KernelSpec("rbf", ds=2)
    kw = dict(iters=40, restarts=3, refit_iters=15, refit_restarts=2)
    cfg, tcfg = FitConfig(**kw), TFitConfig(**kw)
    assert tgp.refit_cfg(tcfg).iters == 15 and tgp.refit_cfg(tcfg).restarts == 2
    assert tgp.refit_cfg(TFitConfig()) == TFitConfig()
    x = rng.uniform(0, 10, (24, 2)).astype(np.float32)
    y = (np.sin(x[:, 0] / 2) + 0.1 * rng.standard_normal(24)).astype(np.float32)
    inc = spec.init_params(ls_spatial=2.0, outputscale=0.8, noise=0.2)
    key, step = jax.random.PRNGKey(4), 6
    want = jgp.fit_step_warm(spec, cfg, jnp.asarray(x), jnp.asarray(y), None, key,
                             step, incumbent=inc)
    ref_inits = jgp.make_restart_inits(
        spec, jgp.refit_cfg(cfg), jax.random.fold_in(key, jnp.uint32(step)))
    seen = {}

    def step_inits(s, c, seed, st, device):
        seen["args"] = (c.iters, c.restarts, seed, st)
        return kernel_params_from_numpy(_np_params(ref_inits), device)

    orig = tgp.step_inits
    tgp.step_inits = step_inits
    try:
        got = tgp.fit_step_warm(tspec, tcfg, torch.tensor(x), torch.tensor(y), None,
                                4, step, incumbent=kernel_params_from_numpy(
                                    _np_params(inc)))
    finally:
        tgp.step_inits = orig
    assert seen["args"] == (15, 2, 4, step)
    assert got.nll_trace.shape == (2, 15)
    np.testing.assert_allclose(float(got.nll), float(want.nll), rtol=1e-4)
    np.testing.assert_allclose(got.all_nlls.numpy(), np.asarray(want.all_nlls),
                               rtol=1e-4)


def test_step_inits_depend_on_seed_and_step_only():
    tspec, cfg = tk.KernelSpec("rbf", ds=2), TFitConfig(restarts=3)
    a = tgp.step_inits(tspec, cfg, 3, 8, "cpu")
    b = tgp.step_inits(tspec, cfg, 3, 8, "cpu")
    c = tgp.step_inits(tspec, cfg, 3, 9, "cpu")
    assert torch.equal(a.log_noise, b.log_noise)
    assert not torch.equal(a.log_noise[1:], c.log_noise[1:])
    assert torch.equal(a.log_noise[0], c.log_noise[0])  # the unperturbed init


def test_exact_gp_facade_matches_functional_core(rng):
    spec, tspec, p, x, y, _, xt = _posterior_case(rng, noise_scale=False)
    cfg = TFitConfig(iters=20, restarts=2)
    inits = tgp.make_restart_inits(tspec, cfg, torch.Generator().manual_seed(0))
    m = tgp.ExactGP(tspec, cfg, device="cpu")
    res = m.fit(x, y, inits=inits)
    mean, var = m.predict(xt)
    want = tgp.fit(tspec, cfg, torch.tensor(x), torch.tensor(y), inits=inits)
    _, wmean, wvar = tgp.posterior_and_predict(
        tspec, want.params, torch.tensor(x), torch.tensor(y), None, torch.tensor(xt))
    assert float(res.nll) == float(want.nll)
    torch.testing.assert_close(mean, wmean)
    torch.testing.assert_close(var, wvar)


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tspec = tk.KernelSpec("rbf", ds=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgp.make_restart_inits(tspec, TFitConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgp.ExactGP(tspec)
    assert tgp.make_restart_inits(tspec, TFitConfig(), device="cpu").log_noise.shape == (4,)
