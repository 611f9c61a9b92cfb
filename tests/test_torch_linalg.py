"""algp_tpu_torch.ops.linalg against algp_tpu.ops.linalg and SciPy."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

from algp_tpu.ops import linalg as jla

import oracle
from algp_tpu_torch.ops import linalg as tla


def _spd(rng, n=120, noise=0.05):
    x = rng.uniform(0, 10, (n, 2))
    return (oracle.gram(x, x, ls_spatial=1.5) + noise * np.eye(n)).astype(np.float32)


def test_tri_inv_matches_reference_and_is_row_major(rng):
    K = _spd(rng, n=300)
    L = np.linalg.cholesky(K.astype(np.float64)).astype(np.float32)
    W = tla.tri_inv(torch.tensor(L))
    assert W.is_contiguous()  # the precision-column kernel reads rows
    assert torch.equal(torch.triu(W, 1), torch.zeros_like(W))
    Wn = W.numpy()
    want = np.asarray(jla.tri_inv(jnp.asarray(L)))
    exact = sla.solve_triangular(L.astype(np.float64), np.eye(300), lower=True)
    scale = np.abs(exact).max()
    np.testing.assert_allclose(Wn, exact, atol=1e-5 * scale)
    np.testing.assert_allclose(Wn, want, atol=1e-5 * scale)


def _factor(rng, n):
    """The f32 lower factor of a GP-shaped K (f64 Cholesky, then cast)."""
    return np.linalg.cholesky(_spd(rng, n=n).astype(np.float64)).astype(np.float32)


def _check_inverse(L, W):
    """W = L⁻¹ within today's atol of the f64 inverse, L·W − I small,
    exact zeros above the diagonal, row-major."""
    assert W.is_contiguous()  # the precision-column kernel reads rows
    assert torch.equal(torch.triu(W, 1), torch.zeros_like(W))
    n = L.shape[0]
    Wn = W.numpy().astype(np.float64)
    exact = sla.solve_triangular(L.astype(np.float64), np.eye(n), lower=True)
    np.testing.assert_allclose(Wn, exact, rtol=0, atol=1e-5 * np.abs(exact).max())
    assert np.abs(L.astype(np.float64) @ Wn - np.eye(n)).max() < 1e-5


@pytest.mark.parametrize("n,leaf", [(1030, None), (2048, None), (300, 64)])
def test_tri_inv_blocked_matches_f64(rng, n, leaf):
    """Past 1 024 `tri_inv` inverts by blocks (ragged at 1 030, whole at
    2 048); the private routine drives the same path at a small leaf."""
    L = _factor(rng, n)
    Lt = torch.tensor(L)
    W = tla.tri_inv(Lt) if leaf is None else tla._tri_inv_blocked(Lt, leaf)
    _check_inverse(L, W)


@pytest.mark.parametrize("n", [224, 512, 1024])
def test_tri_inv_small_is_the_solve_bitwise(rng, n):
    """Up to 1 024 (the low-rank seeds' and the capped solves' factors)
    `tri_inv` is the solve against the identity, bit for bit."""
    L = torch.tensor(_factor(rng, n))
    want = torch.linalg.solve_triangular(L.mT, torch.eye(n), upper=True).mT
    assert torch.equal(tla.tri_inv(L), want)


def test_blocked_inverse_of_the_overflowing_factor():
    """The factor on which the reference's Neumann-doubling leaf overflows
    (c5_long's first 256 cells at its pilot fit's hyperparameters; see
    tests/test_torch_quality_parity.py): the blocked inverse is finite and
    equals the solve within today's atol."""
    r, c = np.divmod(np.arange(256), 100)
    x = np.stack([c, r], 1) / np.array([9.16, 6.84])
    d = np.sqrt(3.0 * ((x[:, None] - x[None]) ** 2).sum(-1))
    K = 0.80 * (1 + d) * np.exp(-d) + 5.4e-4 * np.eye(256)
    L = torch.tensor(np.linalg.cholesky(K).astype(np.float32))
    W = tla._tri_inv_blocked(L, 64)
    assert torch.isfinite(W).all()
    want = torch.linalg.solve_triangular(L.mT, torch.eye(256), upper=True).mT
    np.testing.assert_allclose(W.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("n,blocked", [(512, False), (2048, True)])
def test_tri_inv_counts_and_marks_the_blocked_path(rng, n, blocked):
    """`TRI_INV_BLOCKED` counts the blocked inversions, and each is the
    profiler region `linalg.tri_inv`."""
    L = torch.tensor(_factor(rng, n))
    before = tla.TRI_INV_BLOCKED
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tla.tri_inv(L)
    assert tla.TRI_INV_BLOCKED - before == int(blocked)
    regions = [e.name for e in prof.events() if e.name == "linalg.tri_inv"]
    assert len(regions) == int(blocked)


def test_cho_solve_and_logdet_match_reference(rng):
    K = _spd(rng, noise=0.3)
    b = rng.standard_normal(120).astype(np.float32)
    B = rng.standard_normal((120, 7)).astype(np.float32)
    Lt = tla.cholesky(torch.tensor(K))
    Lj = jla.cholesky(jnp.asarray(K))
    for rhs in (b, B):
        got = tla.cho_solve(Lt, torch.tensor(rhs)).numpy()
        want = np.asarray(jla.cho_solve(Lj, jnp.asarray(rhs)))
        exact = np.linalg.solve(K.astype(np.float64), rhs.astype(np.float64))
        # f32 solves of a cond ≈ 1e2 system: error relative to the solution
        atol = 1e-5 * np.abs(exact).max()
        np.testing.assert_allclose(got, want, atol=atol)
        np.testing.assert_allclose(got, exact, atol=atol)
    np.testing.assert_allclose(
        float(tla.logdet_from_chol(Lt)), float(jla.logdet_from_chol(Lj)), rtol=1e-5
    )
    for trans in (False, True):
        got = tla.solve_triangular(Lt, torch.tensor(B), trans=trans).numpy()
        want = np.asarray(jla.solve_triangular(Lj, jnp.asarray(B), trans=trans))
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_batched_cholesky_failure_is_nan_per_element(rng):
    """A failed factor is NaN (as jnp.linalg.cholesky returns it), not an
    exception, and it stays in its own batch element."""
    K = _spd(rng, n=30)
    bad = K.copy()
    bad[3, 3] = -1.0
    L = tla.cholesky(torch.tensor(np.stack([K, bad, K])))
    assert torch.isfinite(L[0]).all() and torch.isfinite(L[2]).all()
    assert torch.isnan(L[1]).all()
    np.testing.assert_allclose(L[0].numpy(), np.asarray(jla.cholesky(jnp.asarray(K))),
                               rtol=1e-5, atol=1e-6)


def test_safe_cholesky_rank_deficient_adds_jitter(rng):
    """Duplicated points make K singular in f32: the factor needs jitter,
    reports it, and matches the reference's ladder."""
    x = rng.uniform(0, 10, (40, 2))
    x = np.concatenate([x, x[:20]])  # exact duplicates ⇒ rank ≤ 40
    K = oracle.gram(x, x, ls_spatial=4.0).astype(np.float32)
    L, jit = tla.safe_cholesky(torch.tensor(K))
    Lj, jitj = jla.safe_cholesky(jnp.asarray(K))
    assert float(jit) > 0.0
    assert torch.isfinite(L).all()
    np.testing.assert_allclose(float(jit), float(jitj), rtol=1e-6)
    Kj = K + float(jit) * np.eye(60, dtype=np.float32)
    np.testing.assert_allclose((L @ L.T).numpy(), Kj, atol=1e-4)


def test_safe_cholesky_healthy_matrix_adds_nothing(rng):
    K = _spd(rng)
    L, jit = tla.safe_cholesky(torch.tensor(K))
    assert float(jit) == 0.0
    assert torch.equal(L, tla.cholesky(torch.tensor(K)))


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
def test_cholesky_jitter_matches_reference(rng, jitter):
    K = _spd(rng, n=50)
    np.testing.assert_allclose(
        tla.cholesky(torch.tensor(K), jitter=jitter).numpy(),
        np.asarray(jla.cholesky(jnp.asarray(K), jitter=jitter)), rtol=1e-5, atol=1e-6,
    )
