"""algp_tpu_torch.planning against algp_tpu.planning: the port's native
enumerator (its own copy of pathenum.c) gives the reference's path
batches, and equals the port's plain Python enumerator."""

import types

import numpy as np
import pytest

from algp_tpu import planning as jplan
from algp_tpu.config import FieldConfig
from algp_tpu.field import FieldEnv
from algp_tpu_torch import planning as tplan

CFG = dict(num_rows=7, num_cols=9, row_spacing=1.5, col_spacing=1.0)


@pytest.fixture(scope="module")
def envs():
    ref = FieldEnv(FieldConfig(**CFG))
    # the port's planning reads the geometry only
    port = types.SimpleNamespace(num_rows=CFG["num_rows"], num_cols=CFG["num_cols"],
                                 cfg=types.SimpleNamespace(**CFG))
    return ref, port


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a.node_seqs, b.node_seqs):
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
    np.testing.assert_array_equal(a.sets, b.sets)
    np.testing.assert_array_equal(a.sizes, b.sizes)
    np.testing.assert_array_equal(a.costs, b.costs)
    np.testing.assert_array_equal(a.ends, b.ends)


CASES = [  # (start, budget, goal, k_max, min_cost_frac)
    (0, 6.0, None, 10, 0.5),
    (31, 9.5, None, 4, 0.5),
    (8, 14.0, None, 6, 0.8),
    (40, 2.0, None, 10, 0.5),
    (0, 12.0, 17, 5, 0.5),
    (30, 7.0, 62, 10, 0.5),  # unreachable goal: an empty batch
]


@pytest.mark.parametrize("start,budget,goal,k_max,frac", CASES)
def test_enumerate_batch_matches_reference(envs, start, budget, goal, k_max, frac):
    ref, port = envs
    kw = dict(goal=goal, max_paths=64, k_max=k_max, min_cost_frac=frac)
    want = jplan.enumerate_batch(ref, start, budget, **kw)
    got = tplan.enumerate_batch(port, start, budget, **kw)
    _assert_batches_equal(got, want)
    assert (got.costs <= budget + 1e-6).all()
    if goal is not None:
        assert (got.ends == goal).all()


@pytest.mark.parametrize("start,budget,goal,k_max,frac", CASES)
def test_native_enumerator_equals_plain_python(envs, start, budget, goal, k_max, frac):
    _, port = envs
    kw = dict(goal=goal, max_paths=64, min_cost_frac=frac)
    paths = tplan.enumerate_paths(port, start, budget, **kw)
    plain = tplan._enumerate_paths_python(port, start, budget, **kw)
    assert [(list(s), c) for s, c in paths] == [(list(s), c) for s, c in plain]
    _assert_batches_equal(
        tplan.enumerate_batch(port, start, budget, k_max=k_max, **kw),
        tplan.paths_to_batch(port, plain, k_max=k_max),
    )


def test_boustrophedon_order_matches_reference(envs):
    ref, port = envs
    got = tplan.boustrophedon_order(port)
    np.testing.assert_array_equal(got, jplan.boustrophedon_order(ref))
    assert sorted(got.tolist()) == list(range(CFG["num_rows"] * CFG["num_cols"]))
