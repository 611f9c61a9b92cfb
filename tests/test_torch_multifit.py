"""algp_tpu_torch's multi-trait fits against algp_tpu's, fed the
reference's restart inits: `gp.fit_multi` / `trait_result`, and
`models.multifit.multitrait_mean_fields` on the batched path (fully
observed traits) and the per-trait fallback (visits that skipped traits),
within 2e-3 of the reference's mean fields (f32 fits of 40 steps from the
same inits)."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from algp_tpu.config import FieldConfig, FitConfig
from algp_tpu.field import FieldEnv
from algp_tpu.models import gp as jgp
from algp_tpu.models import multifit as jmf
from algp_tpu.ops.kernels import KernelSpec
from algp_tpu_torch.config import FitConfig as TFitConfig
from algp_tpu_torch.convert import field_env_like, kernel_params_from_numpy
from algp_tpu_torch.models import gp as tgp
from algp_tpu_torch.models import multifit as tmf
from algp_tpu_torch.ops.kernels import KernelSpec as TKernelSpec

SPEC = ("matern32", "rbf", 2, 0)
FIT = dict(iters=40, restarts=2)


def _case(frac, modality="precise"):
    cfg = FieldConfig(num_rows=6, num_cols=8, num_traits=3, trait_corr=0.6,
                      trait_obs_frac=frac, seed=2)
    ref = FieldEnv(cfg, KernelSpec(*SPEC))
    env = field_env_like(ref, "cpu")
    idx = np.arange(0, 48, 2)
    _, Y, ns, _ = ref.collect_traits(idx, modality)
    return ref, env, idx, Y, ns


def _ref_inits(spec, cfg, key):
    """The reference's make_restart_inits under `key`, as port params."""
    p = jgp.make_restart_inits(spec, cfg, key)
    return kernel_params_from_numpy(
        {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)})


def _inits(key):
    return _ref_inits(KernelSpec(*SPEC), FitConfig(**FIT), key)


@pytest.mark.parametrize("frac,modality", [(1.0, "precise"), (1.0, "cheap"),
                                           (0.5, "precise")])
def test_mean_fields_match_reference(frac, modality):
    ref, env, idx, Y, ns = _case(frac, modality)
    assert np.isnan(Y).any() == (frac < 1.0)  # 0.5: the per-trait path
    key = jax.random.PRNGKey(7)
    want = jmf.multitrait_mean_fields(KernelSpec(*SPEC), FitConfig(**FIT), ref.X, idx, Y,
                                      ns, ref.observed_traits, key)
    got = tmf.multitrait_mean_fields(TKernelSpec(*SPEC), TFitConfig(**FIT), env.X, idx, Y,
                                     ns, env.observed_traits, _inits(key))
    assert got.shape == (48, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3)
    np.testing.assert_allclose(env.rmse_traits(got), ref.rmse_traits(np.asarray(want)),
                               rtol=2e-3)


def test_trait_with_too_few_observations_warns():
    """The per-trait fallback warns for a trait with < 2 observed cells,
    as the reference does, and still returns every field."""
    _, env, idx, Y, ns = _case(1.0)
    Y[:, 1] = np.nan
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        M = tmf.multitrait_mean_fields(TKernelSpec(*SPEC), TFitConfig(**FIT), env.X, idx,
                                       Y, ns, env.observed_traits,
                                       _inits(jax.random.PRNGKey(0)))
    assert any(issubclass(w.category, RuntimeWarning) and "observed cell" in str(w.message)
               for w in caught)
    assert M.shape == (48, 3) and np.isfinite(M).all()


@pytest.mark.parametrize("name,error", [("icm", TypeError), ("bogus", ValueError)])
def test_unported_or_unknown_family_raises(name, error):
    """An unknown family raises ValueError; the (ported) ICM family started
    from the independent family's KernelParams raises TypeError."""
    _, env, idx, Y, ns = _case(1.0)
    with pytest.raises(error, match="multi_fit"):
        tmf.multitrait_mean_fields(TKernelSpec(*SPEC), TFitConfig(multi_fit=name, **FIT),
                                   env.X, idx, Y, ns, env.observed_traits,
                                   _inits(jax.random.PRNGKey(0)))


def test_trait_inits_depend_on_the_seed_only():
    a = tmf.trait_inits(TKernelSpec(*SPEC), TFitConfig(restarts=3), 4, "cpu")
    b = tmf.trait_inits(TKernelSpec(*SPEC), TFitConfig(restarts=3), 4, "cpu")
    c = tmf.trait_inits(TKernelSpec(*SPEC), TFitConfig(restarts=3), 5, "cpu")
    assert torch.equal(a.log_noise, b.log_noise)
    assert not torch.equal(a.log_noise[1:], c.log_noise[1:])


def test_fit_multi_matches_reference_and_individual_fits(rng):
    """fit_multi (T·R restarts in one batch) from the reference's inits:
    per trait, the reference fit_multi's best restart and NLL (1e-4
    relative), and the port's own single-trait fit from the same inits
    (1e-5: the batch changes nothing but the batch)."""
    spec, tspec = KernelSpec("rbf", ds=2), TKernelSpec("rbf", ds=2)
    n, T = 40, 3
    x = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    Y = rng.standard_normal((n, T)).astype(np.float32)
    ns = rng.uniform(1.0, 3.0, n).astype(np.float32)
    cfg, tcfg = FitConfig(iters=30, restarts=2), TFitConfig(iters=30, restarts=2)
    key = jax.random.PRNGKey(5)
    want = jgp.fit_multi(spec, cfg, jnp.asarray(x), jnp.asarray(Y), jnp.asarray(ns), key=key)
    inits = _ref_inits(spec, cfg, key)
    got = tgp.fit_multi(tspec, tcfg, torch.tensor(x), torch.tensor(Y), torch.tensor(ns),
                        inits=inits)
    assert got.nll.shape == (T,) and got.all_nlls.shape == (T, 2)
    assert got.nll_trace.shape == (T, 2, 30) and got.params.log_ls_spatial.shape == (T, 2)
    np.testing.assert_array_equal(got.best_restart.numpy(), np.asarray(want.best_restart))
    np.testing.assert_allclose(got.nll.numpy(), np.asarray(want.nll), rtol=1e-4)
    for t in range(T):
        rt = tgp.trait_result(got, t)
        single = tgp.fit(tspec, tcfg, torch.tensor(x), torch.tensor(Y[:, t]),
                         torch.tensor(ns), inits=inits)
        np.testing.assert_allclose(float(rt.nll), float(single.nll), rtol=1e-5)
        np.testing.assert_allclose(rt.params.log_ls_spatial.numpy(),
                                   single.params.log_ls_spatial.numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert int(rt.best_restart) == int(single.best_restart)
