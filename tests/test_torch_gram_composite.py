"""The composite Gram, s²·k_sp(r²_sp)·k_ft(r²_ft), of algp_tpu_torch.

On the CPU, where `ops.gram.gram_kernel` runs its plain version, against
the JAX reference (`algp_tpu.ops.kernels.gram`, and once `gram_pallas` in
interpret mode) at every spatial × feature kind pair, spatial widths 1-3
and feature widths 1-9.  On the card (`cuda` marker) the kernel of
`csrc/gram.cu` against the plain version within 2e-6·s², one launch a
call, at its template's edges (feature widths 1, 3 and 4, the 8-wide
bucket's 5 and 8, spatial widths 1 and 3) and its runtime widths (df = 9
and 64, ds = 4), over ragged shapes and several 8-row tiles.  The card's
machine has no JAX: the JAX reference is imported inside a fixture, and
the card runs this file as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gram_composite.py -q
"""

import itertools

import numpy as np
import pytest
import torch

from algp_tpu_torch.ops import gram as G
from algp_tpu_torch.ops.kernels import KernelSpec

KINDS = ("rbf", "matern32", "matern52")
TOL = 2e-6  # of s², the kernel against plain (Matérn 5/2's ÷3, the summation order)


def _draw(rng, n, ds, df):
    """n points: ds coordinates on [0, 12), df N(0, 1) features, f32."""
    return np.concatenate([rng.uniform(0, 12, (n, ds)), rng.standard_normal((n, df))],
                          1).astype(np.float32)


def _params(rng, ds, df):
    """ARD log-lengthscales, outputscale 1.7, noise 0.2, as numpy."""
    return {"log_ls_spatial": np.log(rng.uniform(1.5, 3.0, ds)).astype(np.float32),
            "log_ls_feature": np.log(rng.uniform(0.8, 1.6, df)).astype(np.float32),
            "log_outputscale": np.float32(np.log(1.7)),
            "log_noise": np.float32(np.log(0.2))}


@pytest.fixture
def jax_ref():
    """The JAX package's kernels and Pallas Gram, and jax.numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from algp_tpu.ops import gram as jgram
    from algp_tpu.ops import kernels as jk

    return jk, jgram, jnp


def _both(jax_ref, sk, fk, ds, df, seed, n1=9, n2=13):
    """(JAX spec, params, x1, x2) and (torch spec, params, x1, x2)."""
    from algp_tpu_torch.convert import kernel_params_from_numpy

    jk, _, jnp = jax_ref
    rng = np.random.default_rng(seed)
    p = _params(rng, ds, df)
    x1, x2 = _draw(rng, n1, ds, df), _draw(rng, n2, ds, df)
    jp = jk.KernelParams(**{k: jnp.asarray(v) for k, v in p.items()})
    return ((jk.KernelSpec(sk, fk, ds, df), jp, jnp.asarray(x1), jnp.asarray(x2)),
            (KernelSpec(sk, fk, ds, df), kernel_params_from_numpy(p), torch.tensor(x1),
             torch.tensor(x2)))


@pytest.mark.parametrize("df", (1, 2, 3, 4, 5, 8, 9))
@pytest.mark.parametrize("ds", (1, 2, 3))
@pytest.mark.parametrize("sk,fk", list(itertools.product(KINDS, KINDS)))
def test_plain_composite_matches_jax(jax_ref, sk, fk, ds, df):
    """The wrapper on CPU tensors (its plain version, no launch) against
    the JAX reference's `ops.kernels.gram`."""
    jk = jax_ref[0]
    (jspec, jp, jx1, jx2), (spec, p, x1, x2) = _both(jax_ref, sk, fk, ds, df,
                                                      seed=100 * ds + df)
    before = G.LAUNCHES
    got = G.gram_kernel(spec, p, x1, x2)
    assert G.LAUNCHES == before
    assert got.shape == (9, 13) and got.dtype == torch.float32
    want = np.asarray(jk.gram(jspec, jp, jx1, jx2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_plain_composite_matches_jax_pallas_interpret(jax_ref):
    """Matérn 5/2 × RBF at the deep kernel's d = 2 + 4 against the Pallas
    kernel `gram_pallas` in interpret mode, over ragged shapes."""
    jgram = jax_ref[1]
    (jspec, jp, jx1, jx2), (spec, p, x1, x2) = _both(jax_ref, "matern52", "rbf", 2, 4,
                                                      seed=7, n1=37, n2=61)
    got = G.gram_kernel(spec, p, x1, x2).numpy()
    want = np.asarray(jgram.gram_pallas(jspec, jp, jx1, jx2, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---- on the card --------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _on_card(dev, spec, seed, n1, n2):
    rng = np.random.default_rng(seed)
    p = spec.init_params(ls_spatial=2.5, ls_feature=1.3, outputscale=1.7, device=dev)
    return (p, torch.tensor(_draw(rng, n1, spec.ds, spec.df), device=dev),
            torch.tensor(_draw(rng, n2, spec.ds, spec.df), device=dev))


def _kernel_vs_plain(spec, p, x1, x2):
    before = G.LAUNCHES
    got = G.gram_kernel(spec, p, x1, x2)
    assert G.LAUNCHES == before + 1
    torch.cuda.synchronize()
    want = G.gram_reference(spec, p, x1, x2)
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= TOL * 1.7, err


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(37, 1024), (37, 1025), (37, 1026), (9, 2051), (1, 1)])
@pytest.mark.parametrize("ds,df", [(2, 1), (2, 3), (2, 4), (2, 5), (2, 8), (1, 2), (3, 8),
                                   (2, 9), (2, 64), (4, 3)])
def test_composite_kernel_matches_plain(dev, ds, df, n1, n2):
    """Matérn 5/2 × RBF at the template's edges and the runtime widths: n2
    % 4 = 0, 1, 2, 3 (16- and 4-byte rows), one and three column strips,
    five row tiles."""
    spec = KernelSpec("matern52", "rbf", ds=ds, df=df)
    _kernel_vs_plain(spec, *_on_card(dev, spec, 10 * ds + df, n1, n2))


@pytest.mark.cuda
@pytest.mark.parametrize("sk,fk", list(itertools.product(KINDS, KINDS)))
def test_composite_kernel_every_kind_pair(dev, sk, fk):
    spec = KernelSpec(sk, fk, ds=2, df=3)
    _kernel_vs_plain(spec, *_on_card(dev, spec, 3, 21, 999))


@pytest.mark.cuda
def test_composite_kernel_strided_and_offset_rows(dev):
    """A column slice of a wider tensor (rows not contiguous) gives what its
    contiguous copy gives; rows that start 20 bytes into an allocation (n2
    % 4 = 0, but 4-byte loads and stores) give what an aligned copy gives
    on the 16-byte path, bit for bit."""
    spec = KernelSpec("matern52", "rbf", ds=2, df=3)
    p, x1, x2 = _on_card(dev, spec, 5, 40, 1029)
    wide = torch.cat([x2, torch.zeros(1029, 3, device=dev)], 1)
    _kernel_vs_plain(spec, p, x1, wide[:, :5])
    assert torch.equal(G.gram_kernel(spec, p, x1, wide[:, :5]),
                       G.gram_kernel(spec, p, x1, x2))
    off = x2[1:]
    _kernel_vs_plain(spec, p, x1, off)
    assert torch.equal(G.gram_kernel(spec, p, x1, off), G.gram_kernel(spec, p, x1, off.clone()))
