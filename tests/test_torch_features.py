"""algp_tpu_torch.field's features, feature warp and traits against
algp_tpu.field: the same features, X and held-out split (bitwise: both
sides are numpy, drawn in the same order), the same truth on the
reference's draws (within 2e-5: f32 Gram, Cholesky and products), and
the same multi-trait sensing given the carried rng state."""

import numpy as np
import pytest

import jax

from algp_tpu.config import FieldConfig
from algp_tpu.field import FieldEnv
from algp_tpu.ops.kernels import KernelSpec
from algp_tpu_torch.config import FieldConfig as TFieldConfig
from algp_tpu_torch.convert import field_env_like
from algp_tpu_torch.field import FieldEnv as TFieldEnv
from algp_tpu_torch.ops.kernels import KernelSpec as TKernelSpec

SPEC_C2 = ("matern52", "rbf", 2, 3)
CFG_FEAT = dict(num_rows=6, num_cols=9, num_features=3, true_ls_spatial=2.5, seed=5)


def _ref_draws(cfg, T=1):
    """The reference's dense-truth normals: jax.random.normal(PRNGKey(seed),
    (n, T))."""
    n = cfg["num_rows"] * cfg["num_cols"]
    return (np.asarray(jax.random.normal(jax.random.PRNGKey(cfg["seed"]), (n, T))),)


@pytest.mark.parametrize("warp", ["none", "tanh", "sin"])
def test_features_warp_and_split_match_reference(warp):
    """Features, X and the held-out split equal the reference's bit for bit
    (the same numpy draws in the same order); the warped truth, given the
    reference's normals, agrees within 2e-5 (f32 Gram, Cholesky and
    product on both sides)."""
    cfg = dict(CFG_FEAT, feature_warp=warp)
    ref = FieldEnv(FieldConfig(**cfg), KernelSpec(*SPEC_C2))
    got = TFieldEnv(TFieldConfig(**cfg), TKernelSpec(*SPEC_C2), device="cpu",
                    draws=_ref_draws(cfg))
    assert got.features.dtype == np.float32 and got.features.shape == (54, 3)
    np.testing.assert_array_equal(got.features, ref.features)
    np.testing.assert_array_equal(got.X.numpy(), np.asarray(ref.X))
    np.testing.assert_array_equal(got.test_mask, ref.test_mask)
    np.testing.assert_array_equal(got.observed_traits, ref.observed_traits)
    np.testing.assert_allclose(got.f, ref.f, rtol=0, atol=2e-5)
    assert got.num_traits == ref.num_traits == 1
    if warp != "none":  # the warp changes the truth, not the inputs
        plain = TFieldEnv(TFieldConfig(**CFG_FEAT), TKernelSpec(*SPEC_C2),
                          device="cpu", draws=_ref_draws(cfg))
        np.testing.assert_array_equal(plain.X.numpy(), got.X.numpy())
        assert np.abs(plain.f - got.f).max() > 1e-2


def test_unknown_feature_warp_raises():
    with pytest.raises(ValueError, match="feature_warp"):
        TFieldEnv(TFieldConfig(**dict(CFG_FEAT, feature_warp="cubic")), device="cpu")


@pytest.mark.parametrize("corr", [0.0, 0.5])
def test_multi_trait_truth_on_reference_draws(corr):
    """(n, 3) traits from the reference's (n, 3) normals, mixed by the
    equicorrelation factor: within 2e-5 of the reference's; trait 0 is the
    unmixed draw bit for bit."""
    cfg = dict(CFG_FEAT, num_traits=3, trait_corr=corr)
    ref = FieldEnv(FieldConfig(**cfg), KernelSpec(*SPEC_C2))
    got = TFieldEnv(TFieldConfig(**cfg), TKernelSpec(*SPEC_C2), device="cpu",
                    draws=_ref_draws(cfg, 3))
    assert got.traits.shape == (54, 3) and got.num_traits == 3
    np.testing.assert_allclose(got.traits, ref.traits, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got.f, got.traits[:, 0])
    unmixed = TFieldEnv(TFieldConfig(**dict(cfg, trait_corr=0.0)), TKernelSpec(*SPEC_C2),
                        device="cpu", draws=_ref_draws(cfg, 3))
    np.testing.assert_array_equal(unmixed.traits[:, 0], got.traits[:, 0])
    np.testing.assert_array_equal(got.f_dev.numpy().astype(np.float64), got.f)


@pytest.mark.parametrize("bad", [dict(trait_corr=1.5), dict(trait_obs_frac=25.0),
                                 dict(trait_obs_frac=0.0)])
def test_trait_options_validated_at_construction(bad):
    with pytest.raises(ValueError, match=next(iter(bad))):
        TFieldEnv(TFieldConfig(num_rows=3, num_cols=4, num_traits=2, **bad),
                  device="cpu")


@pytest.mark.parametrize("frac", [1.0, 0.5])
@pytest.mark.parametrize("corr", [0.0, 0.5])
def test_collect_traits_matches_reference(frac, corr):
    """Given the carried rng state, collect_traits draws the reference's
    noise and Bernoulli mask: Y (NaN pattern included) and obs equal; the
    1.0 default draws no mask; rmse_traits equal."""
    cfg = dict(CFG_FEAT, num_traits=3, trait_corr=corr, trait_obs_frac=frac)
    ref = FieldEnv(FieldConfig(**cfg), KernelSpec(*SPEC_C2))
    got = field_env_like(ref, "cpu")
    np.testing.assert_array_equal(got.traits, ref.traits)
    idx = np.arange(0, 54, 2)
    for modality in ("precise", "cheap", "precise"):
        a, b = ref.collect_traits(idx, modality), got.collect_traits(idx, modality)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    _, Y, _, obs = b
    assert obs[:, 0].all() and (obs.all() if frac == 1.0 else not obs.all())
    np.testing.assert_array_equal(np.isnan(Y), ~obs)
    means = np.random.default_rng(0).standard_normal((54, 3))
    for test_only in (False, True):
        assert got.rmse_traits(means, test_only) == ref.rmse_traits(means, test_only)
