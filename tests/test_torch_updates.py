"""algp_tpu_torch.ops.updates (the MI loop's precision column) against the
reference's streamed Pallas kernel in interpret mode, on the CPU, where
the wrapper runs its plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from algp_tpu.ops.updates import wtw_column_streamed
from algp_tpu_torch.ops import updates as tu


@pytest.mark.parametrize("j", [0, 77, 255, 511])
def test_wtw_column_matches_reference_kernel(rng, j):
    N = 512
    W = np.tril(rng.standard_normal((N, N)).astype(np.float32))
    want = np.asarray(wtw_column_streamed(jnp.asarray(W), jnp.asarray(j), tile=256,
                                          interpret=True))
    Wt = torch.tensor(W)
    before = tu.LAUNCHES
    got = tu.wtw_column(Wt, torch.tensor(j))
    assert tu.LAUNCHES == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tu.wtw_column_reference(Wt, j).numpy(),
                               (W.T @ W)[:, j], rtol=1e-5, atol=1e-4)


def test_wtw_column_rejects_what_the_kernel_does_not_take():
    W = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tu.wtw_column(W, 3)
    with pytest.raises(ValueError):
        tu.wtw_column(torch.empty((8, 6), device="meta"), 3)


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("N", [301, 512])
def test_wtw_column_strips_sum_to_the_square_column(rng, N, S):
    """The strip form's plain version over row strips that tile W (ragged
    when S does not divide N) adds up to W[:, j] @ W."""
    W = np.tril(rng.standard_normal((N, N)).astype(np.float32))
    Wt = torch.tensor(W)
    bounds = np.linspace(0, N, S + 1).round().astype(int)
    for j in (0, N // 3, N - 1):
        want = tu.wtw_column_reference(Wt, j)
        before = tu.LAUNCHES
        got = sum(tu.wtw_column_strip(Wt[r0:r1], torch.tensor(j), int(r0))
                  for r0, r1 in zip(bounds[:-1], bounds[1:]))
        assert tu.LAUNCHES == before  # CPU tensors take the plain version
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), (W.T @ W)[:, j], rtol=1e-5, atol=1e-4)


def test_wtw_column_strip_rejects_rows_outside_w():
    with pytest.raises(ValueError, match="outside"):
        tu.wtw_column_strip(torch.empty((4, 8), device="meta"), 3, 6)
