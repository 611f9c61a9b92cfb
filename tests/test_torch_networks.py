"""The deep feature kernel (algp_tpu_torch.models.networks) against
algp_tpu's on the CPU: the embedding, and the joint MLP + kernel fit
(Adam and L-BFGS, with and without weight decay) from the reference's
initial weights and restart inits."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from algp_tpu import config as jc
from algp_tpu.models import gp as jgp
from algp_tpu.models import networks as jnets
from algp_tpu.ops.kernels import KernelSpec as JKernelSpec
from algp_tpu_torch import config as tc
from algp_tpu_torch.convert import kernel_params_from_numpy, mlp_from_numpy
from algp_tpu_torch.models import networks as tnets
from algp_tpu_torch.ops.kernels import KernelSpec

SPEC = ("matern52", "rbf", 2, 3)


def _mlp(layers) -> list:
    return mlp_from_numpy([(np.asarray(W), np.asarray(b)) for W, b in layers])


def _inputs(rng, n=30):
    x = np.concatenate([rng.uniform(0, 6, (n, 2)), rng.standard_normal((n, 3))], 1)
    y = np.sin(2 * x[:, 2]) + 0.1 * rng.standard_normal(n)
    return x.astype(np.float32), y.astype(np.float32)


def reference_deep_inits(kspec, mspec, cfg, key):
    """The reference's (mlp0, kernel inits) of fit_deep under `key`, as the
    port's."""
    kmlp, kinit = jax.random.split(key)
    jm = jc.MLPSpec(**dataclasses.asdict(mspec))
    mlp0 = jnets.init_mlp(jm, kspec.df, kmlp)
    jspec = JKernelSpec(**dataclasses.asdict(kspec))
    kinits = jgp.make_restart_inits(jnets.deep_spec(jspec, jm),
                                    jc.FitConfig(**dataclasses.asdict(cfg)), kinit)
    return _mlp(mlp0), kernel_params_from_numpy(
        {f.name: np.asarray(getattr(kinits, f.name)) for f in dataclasses.fields(kinits)})


@pytest.mark.parametrize("activation,hidden", [("tanh", (8,)), ("relu", (8, 5))])
def test_embed_inputs_matches_reference(rng, activation, hidden):
    """[spatial | φ(features)] within 1e-6 of the reference's; a stack of
    restart copies of the weights embeds each copy as the weights alone."""
    x, _ = _inputs(rng)
    jm = jc.MLPSpec(hidden=hidden, out=3, activation=activation)
    mlp = jnets.init_mlp(jm, 3, jax.random.PRNGKey(2))
    want = np.asarray(jnets.embed_inputs(jm, mlp, jnp.asarray(x), 2))
    tm = tc.MLPSpec(hidden=hidden, out=3, activation=activation)
    got = tnets.embed_inputs(tm, _mlp(mlp), torch.tensor(x), 2)
    assert got.shape == (30, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, :2].numpy(), x[:, :2])
    stacked = [(torch.stack([W, 2 * W]), torch.stack([b, b + 1])) for W, b in _mlp(mlp)]
    batched = tnets.embed_inputs(tm, stacked, torch.tensor(x), 2)
    assert batched.shape == (2, 30, 5)
    np.testing.assert_allclose(batched[0].numpy(), got.numpy(), rtol=1e-6, atol=1e-6)
    second = [(2 * W, b + 1) for W, b in _mlp(mlp)]
    np.testing.assert_allclose(batched[1].numpy(),
                               tnets.embed_inputs(tm, second, torch.tensor(x), 2).numpy(),
                               rtol=1e-6, atol=1e-6)


# L-BFGS over 8 steps: past about a dozen steps the two f32 trajectories
# of this non-convex objective part by more than rounding (as the
# exact fit's do, tests/test_torch_lbfgs.py)
@pytest.mark.parametrize("optimizer,iters,weight_decay", [
    ("adam", 25, 0.0), ("adam", 25, 0.01), ("lbfgs", 8, 0.01)])
def test_fit_deep_matches_reference(rng, optimizer, iters, weight_decay):
    """fit_deep from the reference's mlp0 and restart inits: the winner's
    NLL and every restart's NLL at every step within 1e-4 relative, the
    trained weight matrices and hidden biases within 1e-3; the params live
    at deep_spec."""
    x, y = _inputs(rng)
    fit = dict(iters=iters, restarts=3, optimizer=optimizer)
    mspec = dict(hidden=(8,), out=2, weight_decay=weight_decay)
    key = jax.random.PRNGKey(4)
    want = jnets.fit_deep(JKernelSpec(*SPEC), jc.MLPSpec(**mspec), jc.FitConfig(**fit),
                          jnp.asarray(x), jnp.asarray(y), key=key)
    tspec, tm, tcfg = KernelSpec(*SPEC), tc.MLPSpec(**mspec), tc.FitConfig(**fit)
    got = tnets.fit_deep(tspec, tm, tcfg, torch.tensor(x), torch.tensor(y),
                         inits=reference_deep_inits(tspec, tm, tcfg, key))
    np.testing.assert_allclose(float(got.nll), float(want.nll), rtol=1e-4)
    np.testing.assert_allclose(got.nll_trace.numpy(), np.asarray(want.nll_trace), rtol=1e-4)
    assert got.params.log_ls_feature.shape == (2,)
    for (W, _), (jW, _) in zip(got.mlp, want.mlp):
        np.testing.assert_allclose(W.numpy(), np.asarray(jW), atol=1e-3)
    # the hidden biases; the output layer's bias shifts every embedded
    # point alike, so the stationary kernel does not see it: its gradient
    # is rounding alone and Adam walks it apart in the two packages
    for (_, b), (_, jb) in zip(got.mlp[:-1], want.mlp[:-1]):
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-3)


def test_deep_fit_trains_each_restarts_own_mlp(rng):
    """Each restart trains its own copy of mlp0: a restart fitted alone
    (its kernel inits, the same mlp0) ends where it ends in the batch."""
    x, y = _inputs(rng)
    tspec, tm, tcfg = KernelSpec(*SPEC), tc.MLPSpec(hidden=(6,), out=2), \
        tc.FitConfig(iters=15, restarts=3)
    mlp0, kinits = tnets.make_deep_inits(tspec, tm, tcfg, torch.Generator().manual_seed(1))
    both = tnets.fit_deep(tspec, tm, tcfg, torch.tensor(x), torch.tensor(y),
                          inits=(mlp0, kinits))
    for r in range(3):
        alone = tnets.fit_deep(tspec, tm, dataclasses.replace(tcfg, restarts=1),
                               torch.tensor(x), torch.tensor(y),
                               inits=(mlp0, kinits.map(lambda a: a[r:r + 1])))
        np.testing.assert_allclose(float(alone.nll), float(both.all_nlls[r]), rtol=1e-5)


def test_init_mlp_is_glorot_from_the_generator():
    """Weights N(0, 2 / (a + b)) per layer at the spec's dims, zero biases,
    the same draws from the same generator state."""
    spec = tc.MLPSpec(hidden=(300, 200), out=4)
    a = tnets.init_mlp(spec, 100, torch.Generator().manual_seed(3))
    b = tnets.init_mlp(spec, 100, torch.Generator().manual_seed(3))
    assert [tuple(W.shape) for W, _ in a] == [(100, 300), (300, 200), (200, 4)]
    for (W, bias), (W2, _) in zip(a, b):
        assert torch.equal(W, W2) and not bias.any()
        fan = sum(W.shape)
        if W.numel() > 10_000:
            assert float(W.std()) == pytest.approx(np.sqrt(2.0 / fan), rel=0.05)


def test_deep_spec_and_activation_checks(rng):
    kspec = KernelSpec("matern32", "matern52", ds=2, df=7)
    assert tnets.deep_spec(kspec, tc.MLPSpec(out=3)) == KernelSpec(
        "matern32", "matern52", ds=2, df=3)
    x, _ = _inputs(rng)
    bad = tc.MLPSpec(activation="gelu")
    with pytest.raises(ValueError, match="activation"):
        tnets.embed_inputs(bad, tnets.init_mlp(bad, 3, torch.Generator()), torch.tensor(x), 2)
