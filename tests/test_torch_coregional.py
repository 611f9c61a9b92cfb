"""The ICM (algp_tpu_torch.models.coregional) against algp_tpu's and the
f64 oracle on the CPU: the joint likelihood (with heteroscedastic scales
and identity-padded buffers), the fit from the reference's inits (the
frozen kernel leaves bit for bit at their inits), the posterior, the
chunked prediction, multifit's "icm" branch and a 3-trait episode whose
end-of-episode fit is the ICM."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracle
from algp_tpu import config as jc
from algp_tpu.episode import Agent as JAgent
from algp_tpu.field import FieldEnv as JFieldEnv
from algp_tpu.models import coregional as jicm
from algp_tpu.models import multifit as jmf
from algp_tpu.ops.kernels import KernelSpec as JKernelSpec
from algp_tpu_torch import config as tc
from algp_tpu_torch.convert import field_env_like, icm_params_from_numpy
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.models import coregional as ticm
from algp_tpu_torch.models import gp as tgp
from algp_tpu_torch.models import multifit
from algp_tpu_torch.ops.kernels import KernelSpec
from test_torch_episode import _configs, _reference_step_inits, _same_posterior
from test_torch_episode_fields import _same_sites

SPEC = ("matern32", "rbf", 2, 0)


def _port(p) -> ticm.ICMParams:
    """A reference ICMParams as the port's."""
    return icm_params_from_numpy({
        "kernel": {f.name: np.asarray(getattr(p.kernel, f.name))
                   for f in dataclasses.fields(p.kernel)},
        **{k: np.asarray(getattr(p, k)) for k in ("coreg_a", "log_coreg_kappa",
                                                  "log_noise_t")}})


def _case(rng, n=20, T=3):
    x = rng.uniform(0, 6, (n, 2)).astype(np.float32)
    Y = rng.standard_normal((n, T)).astype(np.float32)
    mask = rng.uniform(size=(n, T)) > 0.3
    mask[:, 0] = True
    ns = rng.uniform(1.0, 3.0, n).astype(np.float32)
    return x, Y, mask, ns


def _oracle_params(rng, T=3):
    """ICMParams whose trait covariance is a random B (κ folded out) and
    whose noise is nv_t: (reference params, B, nv_t)."""
    A = rng.standard_normal((T, 2)) * 0.6
    B = A @ A.T + np.diag(rng.uniform(0.3, 0.8, T))
    nv_t = rng.uniform(0.01, 0.05, T)
    kappa = np.full(T, -12.0)
    kp = JKernelSpec("rbf", ds=2).init_params(ls_spatial=1.5, outputscale=1.0, noise=0.1)
    p = jicm.ICMParams(kernel=kp,
                       coreg_a=jnp.asarray(np.linalg.cholesky(B - np.diag(np.exp(kappa))),
                                           jnp.float32),
                       log_coreg_kappa=jnp.asarray(kappa, jnp.float32),
                       log_noise_t=jnp.asarray(0.5 * np.log(nv_t), jnp.float32))
    return p, B, nv_t


@pytest.mark.parametrize("scaled,num_valid", [(False, None), (True, None), (True, 15)])
def test_neg_mll_icm_matches_reference(rng, scaled, num_valid):
    """Every restart of the reference's inits (a batch in the port), with
    and without noise scales and padding: 1e-5 relative."""
    x, Y, mask, ns = _case(rng)
    spec = JKernelSpec(*SPEC)
    inits = jicm.make_icm_inits(spec, jc.FitConfig(restarts=3), 3, 2, jax.random.PRNGKey(1))
    got = ticm.neg_mll_icm(KernelSpec(*SPEC), _port(inits), torch.tensor(x), torch.tensor(Y),
                           torch.tensor(mask), torch.tensor(ns) if scaled else None,
                           num_valid=num_valid)
    assert got.shape == (3,)
    for r in range(3):
        p = jax.tree_util.tree_map(lambda a: a[r], inits)
        want = jicm.neg_mll_icm(spec, p, jnp.asarray(x), jnp.asarray(Y), jnp.asarray(mask),
                                jnp.asarray(ns) if scaled else None, num_valid=num_valid)
        assert float(got[r]) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("scaled", [False, True])
def test_neg_mll_icm_and_posterior_match_f64_oracle(rng, scaled):
    """The identity-padded joint NLL and the per-trait posterior equal the
    oracle's dense sub-problem over the observed cells (the JAX tests'
    5e-4)."""
    n, T = 24, 3
    x, Y, mask, ns = _case(rng, n, T)
    xs = rng.uniform(0, 6, (15, 2)).astype(np.float32)
    p, _, nv_t = _oracle_params(rng, T)
    tp = _port(p)
    B = ticm.trait_cov(tp).double().numpy()
    ns_t = torch.tensor(ns) if scaled else None
    kw = dict(min_noise=1e-4, jitter=0.0)
    spec = KernelSpec("rbf", ds=2)
    Kx = oracle.gram(x.astype(np.float64), x.astype(np.float64), ls_spatial=1.5)
    got = ticm.neg_mll_icm(spec, tp, torch.tensor(x), torch.tensor(Y), torch.tensor(mask),
                           ns_t, **kw)
    want = oracle.icm_nll(Kx, B, Y, nv_t, mask, ns if scaled else None)
    assert float(got) == pytest.approx(want, rel=5e-4, abs=5e-4)
    post = ticm.posterior_icm(spec, tp, torch.tensor(x), torch.tensor(Y),
                              torch.tensor(mask), ns_t, **kw)
    mean, var = ticm.predict_icm(spec, tp, post, torch.tensor(xs))
    Kc = oracle.gram(x.astype(np.float64), xs.astype(np.float64), ls_spatial=1.5)
    want_m, want_v = oracle.icm_posterior(Kx, Kc, np.ones(len(xs)), B, Y, nv_t, mask,
                                          ns if scaled else None)
    np.testing.assert_allclose(mean.numpy(), want_m, atol=5e-4)
    np.testing.assert_allclose(var.numpy(), want_v, atol=5e-4)
    np.testing.assert_allclose(ticm.predict_icm_mean(spec, tp, post, torch.tensor(xs)).numpy(),
                               mean.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("optimizer,iters,learn_noise", [
    ("adam", 30, True), ("adam", 20, False), ("lbfgs", 8, True)])
def test_fit_icm_matches_reference(rng, optimizer, iters, learn_noise):
    """From the reference's inits (rank 2, 3 restarts): the winner's NLL and
    every restart's within 1e-4 relative, the params within 1e-3; the
    frozen leaves (the kernel's outputscale and noise, and the per-trait
    noise without learn_noise) bit for bit at their inits."""
    x, Y, mask, ns = _case(rng)
    fit = dict(iters=iters, restarts=3, optimizer=optimizer, learn_noise=learn_noise)
    key = jax.random.PRNGKey(3)
    spec = JKernelSpec(*SPEC)
    inits = jicm.make_icm_inits(spec, jc.FitConfig(**fit), 3, 2, key)
    want = jicm.fit_icm(spec, jc.FitConfig(**fit), jnp.asarray(x), jnp.asarray(Y),
                        jnp.asarray(mask), jnp.asarray(ns), key, rank=2)
    tinits = _port(inits)
    got = ticm.fit_icm(KernelSpec(*SPEC), tc.FitConfig(**fit), torch.tensor(x),
                       torch.tensor(Y), torch.tensor(mask), torch.tensor(ns), rank=2,
                       inits=tinits)
    np.testing.assert_allclose(float(got.nll), float(want.nll), rtol=1e-4)
    np.testing.assert_allclose(got.all_nlls.numpy(), np.asarray(want.all_nlls), rtol=1e-4)
    assert int(got.best_restart) == int(want.best_restart)
    for name in ("coreg_a", "log_coreg_kappa", "log_noise_t"):
        np.testing.assert_allclose(getattr(got.params, name).numpy(),
                                   np.asarray(getattr(want.params, name)), atol=1e-3)
    np.testing.assert_allclose(got.params.kernel.log_ls_spatial.numpy(),
                               np.asarray(want.params.kernel.log_ls_spatial), atol=1e-3)
    k = int(got.best_restart)
    frozen = [("log_outputscale", got.params.kernel.log_outputscale,
               tinits.kernel.log_outputscale[k]),
              ("log_noise", got.params.kernel.log_noise, tinits.kernel.log_noise[k])]
    if not learn_noise:
        frozen.append(("log_noise_t", got.params.log_noise_t, tinits.log_noise_t[k]))
    for name, a, b in frozen:
        assert torch.equal(a, b), name


def test_icm_inits_pin_the_kernel_scale_and_noise_on_every_restart():
    """Restart 0 is the unperturbed init; every restart's kernel
    outputscale is 1 and its noise the config's (the fit freezes both), as
    the reference pins them; the draws depend on the generator only."""
    cfg = tc.FitConfig(restarts=4, init_noise=0.2)
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    p = ticm.make_icm_inits(KernelSpec(*SPEC), cfg, 3, 2, gen())
    want = jicm.make_icm_inits(JKernelSpec(*SPEC), jc.FitConfig(restarts=4, init_noise=0.2),
                               3, 2, jax.random.PRNGKey(0))
    assert torch.equal(p.kernel.log_outputscale, torch.zeros(4))
    np.testing.assert_array_equal(p.kernel.log_noise.numpy(),
                                  np.asarray(want.kernel.log_noise))
    for name in ("coreg_a", "log_coreg_kappa", "log_noise_t"):
        np.testing.assert_array_equal(getattr(p, name)[0].numpy(),
                                      np.asarray(getattr(want, name))[0])
        assert getattr(p, name).shape == np.asarray(getattr(want, name)).shape
    again = ticm.make_icm_inits(KernelSpec(*SPEC), cfg, 3, 2, gen())
    assert torch.equal(p.coreg_a, again.coreg_a)


def test_predict_icm_matches_reference_and_chunks_equal_the_whole(rng):
    """predict_icm at the reference's fitted params: means and variances
    within 5e-4 of the reference's; the chunked fit_predict_icm (a ragged
    last chunk) equals the monolithic one bit for bit (its columns are
    independent), with and without variances."""
    x, Y, mask, ns = _case(rng)
    xs = rng.uniform(0, 6, (37, 2)).astype(np.float32)
    spec = JKernelSpec(*SPEC)
    fit = dict(iters=15, restarts=2)
    key = jax.random.PRNGKey(2)
    res = jicm.fit_icm(spec, jc.FitConfig(**fit), jnp.asarray(x), jnp.asarray(Y),
                       jnp.asarray(mask), jnp.asarray(ns), key, rank=1)
    post = jicm.posterior_icm(spec, res.params, jnp.asarray(x), jnp.asarray(Y),
                              jnp.asarray(mask), jnp.asarray(ns))
    want_m, want_v = jicm.predict_icm(spec, res.params, post, jnp.asarray(xs))
    tspec, tp = KernelSpec(*SPEC), _port(res.params)
    tpost = ticm.posterior_icm(tspec, tp, torch.tensor(x), torch.tensor(Y),
                               torch.tensor(mask), torch.tensor(ns))
    m, v = ticm.predict_icm(tspec, tp, tpost, torch.tensor(xs))
    np.testing.assert_allclose(m.numpy(), np.asarray(want_m), atol=5e-4)
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), atol=5e-4)

    inits = _port(jicm.make_icm_inits(spec, jc.FitConfig(**fit), 3, 1, key))
    args = (tspec, tc.FitConfig(**fit), torch.tensor(x), torch.tensor(Y), torch.tensor(xs),
            torch.tensor(mask), torch.tensor(ns))
    whole_m, whole_v, _ = ticm.fit_predict_icm(*args, inits=inits)
    for compute_var in (True, False):
        cm, cv, _ = ticm.fit_predict_icm(*args, inits=inits, test_chunk=16,
                                         compute_var=compute_var)
        assert cm.shape == (37, 3)
        np.testing.assert_array_equal(cm.numpy(), whole_m.numpy())
        if compute_var:
            np.testing.assert_array_equal(cv.numpy(), whole_v.numpy())
        else:
            assert cv is None


def test_multifit_icm_branch_matches_reference():
    """multitrait_mean_fields under multi_fit='icm' on an under-observed
    3-trait field: the mask is the visit's NaN pattern and the env's
    observed cells, the mean fields within 2e-3 of the reference's."""
    cfg = jc.FieldConfig(num_rows=6, num_cols=8, num_traits=3, trait_corr=0.8,
                         trait_obs_frac=0.4, seed=2)
    ref = JFieldEnv(cfg, JKernelSpec(*SPEC))
    env = field_env_like(ref, "cpu")
    idx = np.arange(0, 48, 2)
    _, Y, ns, _ = ref.collect_traits(idx, "precise")
    assert np.isnan(Y).any()
    fit = dict(iters=30, restarts=2, multi_fit="icm", icm_rank=2)
    key = jax.random.PRNGKey(7)
    want = jmf.multitrait_mean_fields(JKernelSpec(*SPEC), jc.FitConfig(**fit), ref.X, idx,
                                      Y, ns, ref.observed_traits, key)
    inits = _port(jicm.make_icm_inits(JKernelSpec(*SPEC), jc.FitConfig(**fit), 3, 2, key))
    got = multifit.multitrait_mean_fields(KernelSpec(*SPEC), tc.FitConfig(**fit), env.X, idx,
                                          Y, ns, env.observed_traits, inits)
    assert got.shape == (48, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3)


def _reference_icm_trait_inits(spec, cfg, num_traits, seed, device):
    """The reference's end-of-episode ICM inits: make_icm_inits under
    PRNGKey(seed)."""
    p = jicm.make_icm_inits(JKernelSpec(**dataclasses.asdict(spec)),
                            jc.FitConfig(**dataclasses.asdict(cfg)), num_traits,
                            cfg.icm_rank, jax.random.PRNGKey(seed))
    return _port(p)


def test_icm_episode_matches_reference(monkeypatch):
    """A 3-trait c5 episode (correlation 0.8, secondary traits at a
    quarter of the visits) ending in the ICM: the reference's sites step
    for step (planning does not depend on the family), and the per-trait
    RMSE of the end-of-episode ICM within 5e-3 of the reference's."""
    monkeypatch.setattr(tgp, "step_inits", _reference_step_inits)
    monkeypatch.setattr(multifit, "icm_trait_inits", _reference_icm_trait_inits)
    jcfg, tcfg = [dataclasses.replace(
        c, field=dataclasses.replace(c.field, num_traits=3, trait_corr=0.8,
                                     trait_obs_frac=0.25),
        fit=dataclasses.replace(c.fit, multi_fit="icm"))
        for c in _configs("mi", "mixed")]
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")
    want = JAgent(jenv, jcfg).run()
    got = Agent(tenv, tcfg).run()
    _same_sites(want, got)
    _same_posterior(want, got, tenv)
    assert np.isnan(got.state.y_traits).any()
    np.testing.assert_allclose(got.trait_rmse, want.trait_rmse, atol=5e-3)
    np.testing.assert_allclose(got.trait_rmse_test, want.trait_rmse_test, atol=5e-3)
