"""algp_tpu_torch.field (the synthetic single-trait FieldEnv) against
algp_tpu.field: same geometry, held-out split and sensing noise.  The
truth draws come from torch.Generator and cannot equal jax.random's."""

import numpy as np
import pytest
import torch

from algp_tpu.config import FieldConfig
from algp_tpu.field import FieldEnv
from algp_tpu.ops.kernels import KernelSpec
from algp_tpu_torch.config import FieldConfig as TFieldConfig
from algp_tpu_torch.field import FieldEnv as TFieldEnv
from algp_tpu_torch.ops import gram as tgram
from algp_tpu_torch.ops.kernels import KernelSpec as TKernelSpec

CFG = dict(num_rows=8, num_cols=10, true_ls_spatial=3.0, row_spacing=1.5,
           col_spacing=0.5, noise_std=0.2, seed=4)


@pytest.fixture(scope="module")
def envs():
    ref = FieldEnv(FieldConfig(**CFG), KernelSpec("rbf", ds=2))
    before = tgram.LAUNCHES
    got = TFieldEnv(TFieldConfig(**CFG), TKernelSpec("rbf", ds=2), device="cpu")
    assert tgram.LAUNCHES == before  # CPU: the plain Gram
    return ref, got


def test_geometry_and_split_match_reference(envs):
    ref, got = envs
    assert got.n == ref.n == 80
    np.testing.assert_array_equal(got.X.numpy(), np.asarray(ref.X))
    np.testing.assert_array_equal(got.test_mask, ref.test_mask)
    for i in (0, 9, 10, 57, 79):
        assert got.index_to_rowcol(i) == ref.index_to_rowcol(i)
        assert got.pose_of(i) == ref.pose_of(i)
        assert got.rowcol_to_index(*got.index_to_rowcol(i)) == i


def test_truth_is_a_finite_gp_draw(envs):
    _, got = envs
    assert got.f.shape == (80,) and got.f.dtype == np.float64
    assert np.isfinite(got.f).all()
    np.testing.assert_array_equal(got.f_dev.numpy().astype(np.float64), got.f)
    assert 0.05 < got.f.std() < 5.0
    assert got.rmse(got.f) == 0.0
    assert got.rmse(torch.tensor(got.f + 1.0), test_only=True) == pytest.approx(1.0)


def test_collect_noise_matches_reference(envs):
    """Same numpy stream in the same order: identical sensing noise."""
    ref, got = envs
    idx = np.array([0, 5, 33, 79, 33])
    for modality in ("precise", "cheap", "precise"):
        s_ref, s_got = ref.collect(idx, modality), got.collect(idx, modality)
        np.testing.assert_allclose(s_got.y - got.f[idx], s_ref.y - ref.f[idx],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(s_got.noise_scale, s_ref.noise_scale)
        np.testing.assert_array_equal(s_got.indices, s_ref.indices)
    with pytest.raises(ValueError):
        got.collect(idx, "lidar")
