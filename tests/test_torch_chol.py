"""algp_tpu_torch.ops.chol against algp_tpu.ops.pallas_chol on the CPU.

`cholesky_pallas` computes XLA's factor off the TPU and at ragged sizes
(pallas_chol.py:326); the port's wrapper takes its plain version on a CPU
tensor and launches nothing.  The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from algp_tpu.ops.pallas_chol import cholesky_pallas
from algp_tpu_torch.ops import chol as C


def _spd(n, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 12, (n, 2))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    r = np.sqrt(3.0 * d2) / 2.5
    K = 1.3 * (1.0 + r) * np.exp(-r) + noise**2 * np.eye(n)  # Matérn 3/2
    return K.astype(np.float32)


@pytest.mark.parametrize("n", [1, 65, 300])
def test_plain_version_matches_reference(n):
    K = _spd(n, seed=n)
    before = C.LAUNCHES
    got = C.cholesky(torch.tensor(K))
    assert C.LAUNCHES == before  # the CPU takes the plain version
    want = np.asarray(cholesky_pallas(jnp.asarray(K)))
    # two f32 factors of a system with noise variance 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * np.abs(want).max())
    assert (torch.triu(got, 1) == 0).all()
    L64 = got.double()
    assert (L64 @ L64.T - torch.tensor(K, dtype=torch.float64)).abs().max() <= 1e-5 * K.max()


def test_non_spd_input_is_nan_like_the_reference():
    K = _spd(120, seed=3)
    K[70, 70] = -1.0
    got = C.cholesky(torch.tensor(K)).numpy()
    want = np.asarray(cholesky_pallas(jnp.asarray(K)))
    low = np.tril(np.ones_like(K, dtype=bool))
    assert np.isnan(want[low]).all()
    assert np.isnan(got[low]).all()
    assert (got[~low] == 0).all()


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        C.cholesky(torch.empty((4, 4), device="meta"))
