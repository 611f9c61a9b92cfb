"""The precision column's `out=` form (algp_tpu_torch.ops.updates) on the
CPU, where the wrapper runs its plain version: the values of a fresh
call, for square W and ragged row strips, an int64 or int32 index, and
one buffer reused over rounds; and the two selection loops that hold one
buffer for the whole loop (`acquisition._greedy_select`, the world-of-1
`parallel.sharded_mi` loop) selecting what the JAX package selects."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from algp_tpu import acquisition as jacq
from algp_tpu.ops.kernels import KernelSpec as JKernelSpec
from algp_tpu_torch import acquisition as tacq
from algp_tpu_torch.ops import kernels as tk
from algp_tpu_torch.ops import updates as tu
from algp_tpu_torch.parallel import sharded_mi as tsmi
from algp_tpu_torch.parallel.sharded import make_mesh

from test_torch_acquisition import _both, setup_field


def _strips(N, S):
    bounds = np.linspace(0, N, S + 1).round().astype(int)
    return list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))


@pytest.mark.parametrize("jtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("S", [1, 3, 4])
@pytest.mark.parametrize("N", [301, 512])
def test_out_form_returns_the_plain_values(rng, N, S, jtype):
    W = np.tril(rng.standard_normal((N, N)).astype(np.float32))
    Wt = torch.tensor(W)
    for j in (0, N // 3, N - 1):
        jt = torch.tensor([j], dtype=jtype)
        if S == 1:
            out = torch.full((N,), np.nan)
            assert tu.wtw_column(Wt, jt, out=out) is out
            assert torch.equal(out, tu.wtw_column_reference(Wt, j))
        total = np.zeros(N)
        for r0, r1 in _strips(N, S):
            out = torch.full((N,), np.nan)
            before = tu.LAUNCHES
            assert tu.wtw_column_strip(Wt[r0:r1], jt, r0, out=out) is out
            assert tu.LAUNCHES == before  # CPU tensors take the plain version
            assert torch.equal(out, tu.wtw_column_reference(Wt[r0:r1], j))
            assert (out[r1:] == 0).all()
            total += out.numpy()
        np.testing.assert_allclose(total, (W.T.astype(np.float64) @ W)[:, j],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("N,S", [(301, 3), (512, 4)])
def test_one_buffer_over_rounds_equals_fresh_calls(rng, N, S):
    """One `out` a strip (and one for the square call), reused over rounds
    of different j, some repeated: every round the fresh call's values."""
    Wt = torch.tensor(np.tril(rng.standard_normal((N, N)).astype(np.float32)))
    strips = _strips(N, S)
    outs = [torch.empty(N) for _ in strips]
    square = torch.empty(N)
    for j in (5, N - 1, 5, N // 2, 0, N // 2):
        jt = torch.tensor([j])
        tu.wtw_column(Wt, jt, out=square)
        assert torch.equal(square, tu.wtw_column(Wt, jt))
        for (r0, r1), out in zip(strips, outs):
            tu.wtw_column_strip(Wt[r0:r1], jt, r0, out=out)
            assert torch.equal(out, tu.wtw_column_strip(Wt[r0:r1], jt, r0))
        np.testing.assert_allclose(sum(o.numpy() for o in outs), square.numpy(),
                                   rtol=1e-5, atol=1e-4)


def test_out_must_fit_the_column():
    W = torch.tril(torch.ones((8, 8)))
    for bad in (torch.empty(7), torch.empty(8, dtype=torch.float64),
                torch.empty(16)[::2], torch.empty((8, 1))):
        with pytest.raises(ValueError, match="out must be"):
            tu.wtw_column(W, 3, out=bad)
    with pytest.raises(ValueError, match="out must be"):
        tu.wtw_column_strip(W[2:5], 3, 2, out=torch.empty(3))


def _spy(monkeypatch, module, name):
    """Wrap module.name, recording the `out` buffer of every call."""
    fn, seen = getattr(module, name), []

    def spy(*args, out=None):
        seen.append(out)
        return fn(*args, out=out)

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("num_pilot", [0, 5])
def test_greedy_mi_loop_reuses_one_buffer_and_matches_reference(rng, monkeypatch, num_pilot):
    params, tparams, x, _, nv = setup_field(rng, n=200)
    pilot = rng.choice(len(x), size=num_pilot, replace=False)
    seen = _spy(monkeypatch, tacq, "wtw_column")
    ref, got = _both(params, tparams, x, nv, pilot, rounds=15, num_pilot=num_pilot,
                     strategy="mi")
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(ref.selected))
    assert len(seen) == 15 and seen[0] is not None
    assert all(o is seen[0] for o in seen)


@pytest.mark.parametrize("distributed_seed", [False, True])
def test_world_of_one_mesh_mi_loop_reuses_one_buffer_and_matches_reference(
        rng, monkeypatch, distributed_seed):
    params, tparams, x, _, nv = setup_field(rng, n=200)
    pilot = rng.choice(len(x), size=5, replace=False)
    seen = _spy(monkeypatch, tsmi, "wtw_column_strip")
    ref = jacq.greedy_select(
        JKernelSpec("rbf", ds=2), params, jnp.asarray(x, jnp.float32),
        jnp.full((len(x),), nv, jnp.float32), jnp.asarray(pilot, jnp.int32),
        rounds=15, num_pilot=5, strategy="mi")
    got = tsmi.sharded_greedy_select_mi(
        make_mesh(), tk.KernelSpec("rbf", ds=2), tparams,
        torch.tensor(x, dtype=torch.float32), torch.full((len(x),), nv),
        torch.tensor(pilot, dtype=torch.int64), rounds=15, num_pilot=5,
        distributed_seed=distributed_seed)
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(ref.selected))
    assert len(seen) == 15 and seen[0] is not None
    assert all(o is seen[0] for o in seen)
