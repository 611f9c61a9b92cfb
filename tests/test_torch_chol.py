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


@pytest.mark.parametrize("K", [torch.eye(4, dtype=torch.float64), torch.ones((3, 4)),
                               torch.ones((2, 3, 3))],
                         ids=["float64", "not-square", "batched"])
def test_wrapper_rejects_non_f32_and_non_square_input(K):
    with pytest.raises(ValueError, match="square 2-D float32"):
        C.cholesky(K)


def test_nan_if_failed_widens_a_partly_nan_factor():
    L = torch.tril(torch.ones((6, 6)))
    assert torch.equal(C.nan_if_failed(L), L)  # a finite factor passes unchanged
    L[3:, 3:] = torch.nan  # the kernel's failure: NaN from column 3 on
    assert torch.isnan(C.nan_if_failed(L)).all()


def test_seed_factor_is_the_library_factor():
    # the kernel is not wired into the seed: PERF.md §6
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch.ops import linalg as la

    assert acq._seed_factor is la.cholesky


@pytest.fixture
def counted_seed_factor(monkeypatch):
    """acquisition._seed_factor wrapped to count its calls; `use` swaps in
    another factor behind the count."""
    from algp_tpu_torch import acquisition as acq

    calls = []
    state = {"factor": acq._seed_factor}

    def counting(K):
        calls.append(tuple(K.shape))
        return state["factor"](K)

    monkeypatch.setattr(acq, "_seed_factor", counting)
    return calls, state


def _hand_seed(K):
    return C.nan_if_failed(C.cholesky(K))


def test_main_path_seed_goes_through_the_seed_factor(counted_seed_factor):
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch.ops.kernels import KernelSpec

    calls, state = counted_seed_factor
    rng = np.random.default_rng(4)
    spec = KernelSpec("rbf", ds=2)
    p = spec.init_params(ls_spatial=2.0, outputscale=1.0, noise=0.2)
    x = torch.tensor(rng.uniform(0, 10, (150, 2)), dtype=torch.float32)
    nv = torch.full((150,), 0.04)
    pilot = torch.tensor([0, 70, 140])
    run = lambda: acq.greedy_select(spec, p, x, nv, pilot, rounds=20, num_pilot=3,
                                    strategy="mi", return_scores=True)
    want = run()
    assert calls == [(512, 512)]  # one seed, at the padded N
    state["factor"] = _hand_seed  # the kernel's wrapper: its plain version here
    got = run()
    assert calls == [(512, 512)] * 2
    assert torch.equal(got.selected, want.selected)
    # the two factors (the kernel's blocked plain version and LAPACK's) sum
    # in different orders, so the scores agree to f32 rounding through 20
    # rounds, not bit for bit: 7.6e-6 apart at most, on scores up to 22.7
    torch.testing.assert_close(got.scores, want.scores, rtol=1e-5, atol=1e-6)


def test_episode_seed_goes_through_the_seed_factor(counted_seed_factor):
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch.ops import linalg as la
    from algp_tpu_torch.ops.kernels import KernelSpec

    calls, state = counted_seed_factor
    rng = np.random.default_rng(5)
    spec = KernelSpec("matern32", ds=2)
    p = spec.init_params(ls_spatial=2.5, outputscale=1.3, noise=0.1)
    x = torch.tensor(rng.uniform(0, 10, (200, 2)), dtype=torch.float32)
    W, WT = acq.implicit_precision_seed(spec, p, x)
    assert calls == [(200, 200)]
    W0 = la.tri_inv(la.cholesky(acq.seed_matrix(spec, p, x)))
    assert torch.equal(W, W0)
    assert torch.equal(WT, W0.mT.contiguous())
    state["factor"] = _hand_seed
    W1, WT1 = acq.implicit_precision_seed(spec, p, x)
    assert calls == [(200, 200)] * 2
    # the swapped seed is W = L⁻¹ of the factor it was given, bit for bit
    W_hand = la.tri_inv(_hand_seed(acq.seed_matrix(spec, p, x)))
    assert torch.equal(W1, W_hand)
    assert torch.equal(WT1, W_hand.mT.contiguous())
