"""algp_tpu_torch.utils.debug against algp_tpu.utils.debug on the CPU: the
twins of tests/test_utils.py's debug cases.  The finite-tree messages are
equal string for string, and `fit_health_report` gives the reference's
report exactly on the same numbers (both compute in f32 numpy)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from algp_tpu.config import FitConfig
from algp_tpu.models import gp as jgp
from algp_tpu.ops.kernels import KernelSpec
from algp_tpu.utils import debug as jdebug
from algp_tpu_torch.config import FitConfig as TFitConfig
from algp_tpu_torch.convert import kernel_params_from_numpy
from algp_tpu_torch.models import gp as tgp
from algp_tpu_torch.ops import kernels as tk
from algp_tpu_torch.utils import debug


def _message(mod, tree, name):
    with pytest.raises(FloatingPointError) as e:
        mod.assert_finite_tree(tree, name)
    return str(e.value)


def test_assert_finite_tree_raises():
    good = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    debug.assert_finite_tree(good)
    bad = {"a": torch.tensor([1.0, np.nan])}
    with pytest.raises(FloatingPointError, match="non-finite"):
        debug.assert_finite_tree(bad, "state")


@pytest.mark.parametrize("case", ["dict", "nested", "dataclass", "host_leaves"])
def test_assert_finite_tree_names_the_leaf_as_the_reference(case):
    """The same tree in both packages fails with the same message: the
    first non-finite leaf in the reference's leaf order, its path and its
    count."""
    tp = tk.KernelSpec("rbf", "rbf", ds=2, df=1).init_params()
    jp = KernelSpec("rbf", "rbf", ds=2, df=1).init_params()
    inf_ls = np.asarray([0.1, np.inf], np.float32)
    if case == "dict":
        t = {"b": torch.tensor([1.0, np.nan, np.inf]), "a": torch.ones(2)}
        j = {"b": jnp.asarray([1.0, np.nan, np.inf]), "a": jnp.ones(2)}
    elif case == "nested":
        t = {"z": [torch.ones(1), (torch.zeros(2), torch.full((2, 2), np.nan))]}
        j = {"z": [jnp.ones(1), (jnp.zeros(2), jnp.full((2, 2), np.nan))]}
    elif case == "dataclass":
        t = [dataclasses.replace(tp, log_ls_spatial=torch.tensor(inf_ls))]
        j = [dataclasses.replace(jp, log_ls_spatial=jnp.asarray(inf_ls))]
    else:
        t = j = {"x": np.ones(3), "y": [1.0, float("nan")]}
    assert _message(debug, t, "state") == _message(jdebug, j, "state")


def test_checked_catches_nan():
    def f(x):
        return torch.log(x)  # NaN for negative input

    err, out = debug.checked(f)(torch.tensor(-1.0))
    with pytest.raises(FloatingPointError):
        err.throw()
    err2, out2 = debug.checked(f)(torch.tensor(2.0))
    err2.throw()  # no error
    assert err2.get() is None
    assert np.isfinite(float(out2))


def test_checked_names_the_first_op_that_went_non_finite():
    """A NaN made mid-way is reported at its op, not at the ops it flows
    into; Inf from finite inputs counts; non-finite inputs do not."""
    def f(x):
        y = x * 2.0
        z = torch.sqrt(y - 5.0)  # NaN at x = 1
        w = z + 1.0  # NaN in, NaN out: not this op's doing
        return w.sum() + torch.exp(x * 100.0).sum()  # Inf from finite inputs

    err, out = debug.checked(f)(torch.tensor([1.0, 4.0]))
    assert not torch.isfinite(out)
    assert err.op == "aten.sqrt.default"
    with pytest.raises(FloatingPointError, match=r"aten\.sqrt\.default"):
        err.throw()
    err, _ = debug.checked(lambda x: torch.exp(x * 100.0))(torch.tensor([4.0]))
    assert err.op == "aten.exp.default"
    err, _ = debug.checked(lambda x: x + 1.0)(torch.tensor([np.nan]))
    assert err.get() is None
    err, _ = debug.checked(lambda x: x.add_(np.inf))(torch.tensor([1.0]))
    assert err.op == "aten.add_.Tensor"  # in place: the inputs read before the op


def _reference_fit():
    rng = np.random.default_rng(0)
    spec = KernelSpec("rbf", ds=2)
    x = jnp.asarray(rng.uniform(0, 10, (50, 2)), jnp.float32)
    y = jnp.asarray(rng.standard_normal(50), jnp.float32)
    return jgp.fit(spec, FitConfig(iters=30, restarts=2), x, y)


def _port_result(res, **override):
    """The reference's FitResult as the port's, its numbers unchanged."""
    params = kernel_params_from_numpy(
        {f.name: np.asarray(getattr(res.params, f.name))
         for f in dataclasses.fields(res.params)})
    fields = {k: torch.tensor(np.asarray(getattr(res, k)))
              for k in ("nll", "all_nlls", "nll_trace", "best_restart")}
    fields.update(override)
    return tgp.FitResult(params=params, **fields)


def _same_report(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert type(got[k]) is type(v), k


def test_fit_health_report_equals_the_reference_on_the_same_numbers():
    res = _reference_fit()
    _same_report(debug.fit_health_report(_port_result(res)),
                 jdebug.fit_health_report(res))
    # a diverged restart, and then every restart diverged
    for bad in ([np.nan, 3.5], [np.nan, np.inf]):
        nlls = np.asarray(bad, np.float32)
        jres = dataclasses.replace(res, all_nlls=jnp.asarray(nlls))
        _same_report(debug.fit_health_report(_port_result(res, all_nlls=torch.tensor(nlls))),
                     jdebug.fit_health_report(jres))


def test_fit_health_report():
    rng = np.random.default_rng(0)
    spec = tk.KernelSpec("rbf", ds=2)
    x = torch.tensor(rng.uniform(0, 10, (50, 2)), dtype=torch.float32)
    y = torch.tensor(rng.standard_normal(50), dtype=torch.float32)
    res = tgp.fit(spec, TFitConfig(iters=30, restarts=2), x, y)
    rep = debug.fit_health_report(res)
    assert rep["restarts"] == 2
    assert rep["diverged_restarts"] == 0
    assert rep["nll_improvement"] > 0
    assert 0 < rep["noise_std"] < 10
