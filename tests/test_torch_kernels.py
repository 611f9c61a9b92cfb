"""algp_tpu_torch.ops.kernels and ops.gram against the JAX reference
(plain `gram` and the Pallas `gram_pallas` in interpret mode) and the f64
oracle, on the CPU, where the gram wrapper runs its plain version."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from algp_tpu.ops import gram as jgram
from algp_tpu.ops import kernels as jk
from algp_tpu_torch.convert import kernel_params_from_numpy
from algp_tpu_torch.ops import gram as tgram
from algp_tpu_torch.ops import kernels as tk

import oracle

# (spatial_kind, feature_kind, ds, df): every kind, plus composites
SPECS = [
    ("rbf", "rbf", 2, 0),
    ("matern32", "rbf", 2, 0),
    ("matern52", "rbf", 2, 0),
    ("matern52", "rbf", 2, 3),
]


def _np_params(p):
    return {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}


def _setup(spec_args, rng, n1=37, n2=61):
    """ARD params and ragged inputs, as (jax spec, torch spec, jax params,
    torch params, x1, x2) with x as f32 numpy."""
    sk, fk, ds, df = spec_args
    jspec, tspec = jk.KernelSpec(sk, fk, ds, df), tk.KernelSpec(sk, fk, ds, df)
    p = jk.KernelParams(
        log_ls_spatial=jnp.asarray(np.log(rng.uniform(1.5, 3.0, ds)), jnp.float32),
        log_ls_feature=jnp.asarray(np.log(rng.uniform(0.8, 1.6, df)), jnp.float32),
        log_outputscale=jnp.asarray(np.log(1.7), jnp.float32),
        log_noise=jnp.asarray(np.log(0.2), jnp.float32),
    )

    def draw(n):
        return np.concatenate(
            [rng.uniform(0, 12, (n, ds)), rng.standard_normal((n, df))], 1
        ).astype(np.float32)

    return jspec, tspec, p, kernel_params_from_numpy(_np_params(p)), draw(n1), draw(n2)


@pytest.mark.parametrize("kind", ["rbf", "matern32", "matern52"])
def test_stationary_form_matches_reference(kind):
    r2 = np.concatenate([[0.0, 1e-30, 1e-20, 1e-6], np.linspace(0, 40, 97)])
    r2 = r2.astype(np.float32)
    got = tk.stationary_form(kind, torch.tensor(r2)).numpy()
    want = np.asarray(jk.stationary_form(kind, jnp.asarray(r2)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_stationary_form_rejects_unknown_kind():
    with pytest.raises(ValueError):
        tk.stationary_form("cubic", torch.zeros(3))
    with pytest.raises(ValueError):
        tk.KernelSpec("cubic")


@pytest.mark.parametrize("spec_args", SPECS)
def test_gram_matches_jax_pallas_and_oracle(spec_args, rng):
    jspec, tspec, p, tp, x1, x2 = _setup(spec_args, rng)
    before = tgram.LAUNCHES
    got = tgram.gram_kernel(tspec, tp, torch.tensor(x1), torch.tensor(x2))
    assert tgram.LAUNCHES == before  # CPU tensors take the plain version
    assert got.shape == (37, 61) and got.dtype == torch.float32
    got = got.numpy()
    want = np.asarray(jk.gram(jspec, p, jnp.asarray(x1), jnp.asarray(x2)))
    pallas = np.asarray(jgram.gram_pallas(
        jspec, p, jnp.asarray(x1), jnp.asarray(x2), interpret=True
    ))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)
    sk, fk, ds, df = spec_args
    ls = np.exp(np.asarray(p.log_ls_spatial, np.float64))
    lf = np.exp(np.asarray(p.log_ls_feature, np.float64))
    ref = oracle.gram(
        x1.astype(np.float64), x2.astype(np.float64), spatial_kind=sk,
        feature_kind=fk, ds=ds, ls_spatial=ls, ls_feature=lf if df else 1.0,
        outputscale=1.7,
    )
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("spec_args", SPECS[:1] + SPECS[3:])
def test_gram_with_noise_and_diag_match_jax(spec_args, rng):
    jspec, tspec, p, tp, x1, _ = _setup(spec_args, rng)
    scale = rng.uniform(0.5, 3.0, 37).astype(np.float32)
    for ns in (None, scale):
        want = np.asarray(jk.gram_with_noise(
            jspec, p, jnp.asarray(x1), None if ns is None else jnp.asarray(ns)
        ))
        tns = None if ns is None else torch.tensor(ns)
        got_plain = tk.gram_with_noise(tspec, tp, torch.tensor(x1), tns).numpy()
        got = tgram.gram_kernel_with_noise(tspec, tp, torch.tensor(x1), tns).numpy()
        np.testing.assert_allclose(got_plain, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tk.gram_diag(tspec, tp, torch.tensor(x1)).numpy(),
        np.asarray(jk.gram_diag(jspec, p, jnp.asarray(x1))), rtol=1e-6,
    )


def test_batched_params_give_per_restart_grams(rng):
    """A leading restart axis on the params gives one Gram per restart."""
    tspec = tk.KernelSpec("matern52", "rbf", 2, 3)
    x = torch.tensor(rng.standard_normal((20, 5)), dtype=torch.float32)
    ps = [tspec.init_params(ls_spatial=a, ls_feature=b, outputscale=c)
          for a, b, c in ((1.0, 2.0, 0.5), (2.5, 0.7, 1.3), (0.4, 1.1, 2.0))]
    stacked = tk.KernelParams(**{
        f.name: torch.stack([getattr(p, f.name) for p in ps])
        for f in dataclasses.fields(tk.KernelParams)
    })
    Kb = tk.gram_with_noise(tspec, stacked, x)
    assert Kb.shape == (3, 20, 20)
    for r, p in enumerate(ps):
        torch.testing.assert_close(Kb[r], tk.gram_with_noise(tspec, p, x),
                                   rtol=1e-6, atol=1e-7)


def test_init_params_match_reference():
    jspec, tspec = jk.KernelSpec("rbf", "matern32", 2, 3), tk.KernelSpec("rbf", "matern32", 2, 3)
    kw = dict(ls_spatial=2.5, ls_feature=0.7, outputscale=1.3, noise=0.15)
    want = _np_params(jspec.init_params(**kw))
    got = tspec.init_params(**kw)
    # the logs come from two libms (torch's and XLA's), which round some f32
    # inputs to neighbouring floats (log(1.3): 0.2623642 against 0.26236424),
    # so the values agree to one ulp, not bit for bit
    for name, v in want.items():
        np.testing.assert_array_max_ulp(getattr(got, name).numpy(), v, maxulp=1)
    torch.testing.assert_close(got.noise_var, torch.tensor(0.15**2), rtol=1e-6, atol=0)
    g1 = tspec.init_params(torch.Generator().manual_seed(3), perturb=0.5, **kw)
    g2 = tspec.init_params(torch.Generator().manual_seed(3), perturb=0.5, **kw)
    assert torch.equal(g1.log_ls_spatial, g2.log_ls_spatial)
    assert not torch.equal(g1.log_ls_spatial, got.log_ls_spatial)


def test_gram_kernel_rejects_what_the_kernel_does_not_take(rng):
    """Non-CPU tensors never fall back to the plain version: a device the
    kernel does not run on, or a dtype it does not take, raises."""
    tspec = tk.KernelSpec("rbf", ds=2)
    p = tspec.init_params(device="meta")
    x = torch.empty((10, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tgram.gram_kernel(tspec, p, x, x)
    with pytest.raises(ValueError, match="float32"):
        tgram.gram_kernel(tspec, p, x.double(), x.double())
    with pytest.raises(ValueError, match="columns"):
        tgram.gram_kernel(tspec, p, torch.empty((10, 3), device="meta"), x)
