"""algp_tpu_torch.acquisition against algp_tpu.acquisition and the f64
oracle: greedy selections equal both index for index (the fidelity
contract), on the CPU, where both kernels run their plain versions."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from algp_tpu import acquisition as jacq
from algp_tpu.config import FitConfig
from algp_tpu.models import gp as jgp
from algp_tpu.ops.kernels import KernelParams, KernelSpec
from algp_tpu_torch import acquisition as tacq
from algp_tpu_torch.config import FitConfig as TFitConfig
from algp_tpu_torch.convert import kernel_params_from_numpy
from algp_tpu_torch.ops import gram as tgram
from algp_tpu_torch.ops import kernels as tk
from algp_tpu_torch.ops import updates as tupd

import oracle


def _np_params(p):
    return {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}


def setup_field(rng, n=300, ls=2.0, os_=1.5, noise=0.15):
    """As tests/test_acquisition.py:setup_field, for both packages."""
    x = rng.uniform(0, 12, (n, 2))
    params = KernelParams(
        log_ls_spatial=jnp.full((2,), np.log(ls), jnp.float32),
        log_ls_feature=jnp.zeros((0,), jnp.float32),
        log_outputscale=jnp.asarray(np.log(os_), jnp.float32),
        log_noise=jnp.asarray(np.log(noise), jnp.float32),
    )
    K = oracle.gram(x, x, ls_spatial=ls, outputscale=os_)
    return params, kernel_params_from_numpy(_np_params(params)), x, K, noise**2


def _both(params, tparams, x, nv, pilot, **kw):
    """(reference result, port result) of greedy_select on the same input."""
    n = len(x)
    ref = jacq.greedy_select(
        KernelSpec("rbf", ds=2), params, jnp.asarray(x, jnp.float32),
        jnp.full((n,), nv, jnp.float32), jnp.asarray(pilot, jnp.int32), **kw,
    )
    got = tacq.greedy_select(
        tk.KernelSpec("rbf", ds=2), tparams, torch.tensor(x, dtype=torch.float32),
        torch.full((n,), nv), torch.tensor(pilot, dtype=torch.int64), **kw,
    )
    return ref, got


@pytest.mark.parametrize("num_pilot", [0, 5])
def test_entropy_selection_matches_reference_and_oracle(rng, num_pilot):
    params, tparams, x, K, nv = setup_field(rng)
    pilot = rng.choice(len(x), size=num_pilot, replace=False)
    ref, got = _both(params, tparams, x, nv, pilot, rounds=25,
                     num_pilot=num_pilot, strategy="entropy")
    sel_ref, d_ref = oracle.greedy_variance_selection(K, nv, 25, pilot)
    np.testing.assert_array_equal(got.selected.numpy(), sel_ref)
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(ref.selected))
    np.testing.assert_allclose(got.post_var.numpy(), d_ref, atol=2e-3)
    assert got.post_var.shape == (300,) and got.basis.shape == (25 + num_pilot, 300)


@pytest.mark.parametrize("num_pilot", [0, 5])
def test_mi_selection_matches_reference_and_oracle(rng, num_pilot):
    params, tparams, x, K, nv = setup_field(rng, n=250)
    pilot = rng.choice(len(x), size=num_pilot, replace=False)
    ref, got = _both(params, tparams, x, nv, pilot, rounds=20,
                     num_pilot=num_pilot, strategy="mi", return_scores=True)
    sel_ref, traces = oracle.greedy_mi_selection(K, nv, 20, pilot)
    scores = got.scores.numpy()
    for r in range(20):
        finite = np.isfinite(traces[r])
        np.testing.assert_array_equal(np.isfinite(scores[r]), finite)
        np.testing.assert_allclose(scores[r][finite], traces[r][finite],
                                   rtol=5e-3, atol=5e-3)
    np.testing.assert_array_equal(got.selected.numpy(), sel_ref)
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(ref.selected))


def test_duplicate_pilots_stay_finite(rng):
    """A node measured twice is deleted from the MI complement once: the
    scores stay finite and the selection equals the reference's."""
    params, tparams, x, K, nv = setup_field(rng, n=150)
    pilot = np.array([3, 50, 3, 90, 50])
    ref, got = _both(params, tparams, x, nv, pilot, rounds=12, num_pilot=5,
                     strategy="mi", return_scores=True)
    s = got.scores.numpy()
    assert not np.isnan(s).any() and np.isfinite(s.max(axis=1)).all()
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(ref.selected))
    assert not set(got.selected.tolist()) & {3, 50, 90}


def test_batch_pilot_condition_with_padded_slots_matches_reference(rng):
    params, tparams, x, K, nv = setup_field(rng, n=60)
    spec, tspec = KernelSpec("rbf", ds=2), tk.KernelSpec("rbf", ds=2)
    pilot = np.array([3, 30, 0, 0])  # 2 real slots, 2 padded
    d0 = np.ones(60, np.float32) * 1.5
    C, d, taken, LA = jacq._batch_pilot_condition(
        spec, params, jnp.asarray(x, jnp.float32), jnp.full((4,), nv, jnp.float32),
        jnp.asarray(pilot, jnp.int32), jnp.asarray(2), jnp.asarray(d0),
    )
    tC, td, ttaken, tLA = tacq._batch_pilot_condition(
        tspec, tparams, torch.tensor(x, dtype=torch.float32),
        torch.full((4,), nv), torch.tensor(pilot), 2, torch.tensor(d0),
    )
    np.testing.assert_allclose(tC.numpy(), np.asarray(C), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(d), atol=1e-5)
    np.testing.assert_allclose(tLA.numpy(), np.asarray(LA), atol=1e-5)
    np.testing.assert_array_equal(ttaken.numpy(), np.asarray(taken))
    assert (tC[2:] == 0).all()


def test_batch_pilot_condition_cross_gram_goes_through_the_gram_kernel(rng, monkeypatch):
    """The (cap, N) cross-Gram of the conditioning pass is the Gram kernel's
    wrapper (its plain version on the CPU, counted here), the cap × cap
    block the plain `gram`; the pass still equals the reference's."""
    params, tparams, x, K, nv = setup_field(rng, n=60)
    pilot = np.array([3, 30, 7, 0])  # 3 real slots, 1 padded
    d0 = np.ones(60, np.float32) * 1.5
    shapes = []

    def counted(spec, p, x1, x2):
        shapes.append((tuple(x1.shape), tuple(x2.shape)))
        return tk.gram(spec, p, x1, x2)

    monkeypatch.setattr(tgram, "gram_reference", counted)
    tC, td, _, _ = tacq._batch_pilot_condition(
        tk.KernelSpec("rbf", ds=2), tparams, torch.tensor(x, dtype=torch.float32),
        torch.full((4,), nv), torch.tensor(pilot), 3, torch.tensor(d0),
    )
    assert shapes == [((4, 2), (60, 2))]
    C, d, _, _ = jacq._batch_pilot_condition(
        KernelSpec("rbf", ds=2), params, jnp.asarray(x, jnp.float32),
        jnp.full((4,), nv, jnp.float32), jnp.asarray(pilot, jnp.int32), jnp.asarray(3),
        jnp.asarray(d0),
    )
    np.testing.assert_allclose(tC.numpy(), np.asarray(C), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(d), atol=1e-5)


def test_pad_candidates_matches_reference(rng):
    x = rng.uniform(0, 5, (300, 2)).astype(np.float32)
    nv = np.full(300, 0.3, np.float32)
    jx, jnv = jacq.pad_candidates(jnp.asarray(x), jnp.asarray(nv))
    tx, tnv = tacq.pad_candidates(torch.tensor(x), torch.tensor(nv))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tnv.numpy(), np.asarray(jnv))
    same_x, _ = tacq.pad_candidates(torch.tensor(x[:256]), torch.tensor(nv[:256]),
                                    align=256)
    assert same_x.shape == (256, 2)


def test_fit_and_select_matches_reference(rng):
    """The fused entry (bench.py's workload at N = 200) with the
    reference's restart inits: same NLL, same selections, and it went
    through the kernel wrappers' plain versions (no launch on the CPU)."""
    spec, tspec = KernelSpec("rbf", ds=2), tk.KernelSpec("rbf", ds=2)
    cfg, tcfg = FitConfig(iters=40, restarts=2), TFitConfig(iters=40, restarts=2)
    x_all = rng.uniform(0, 12, (200, 2)).astype(np.float32)
    pilot = np.linspace(0, 199, 12).round().astype(np.int32)
    y_tr = rng.standard_normal(12).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jfit, jsel = jacq.fit_and_select(
        spec, cfg, jnp.asarray(x_all[pilot]), jnp.asarray(y_tr),
        jnp.asarray(x_all), jnp.asarray(pilot), rounds=10, num_pilot=12,
        strategy="mi", key=key,
    )
    inits = kernel_params_from_numpy(_np_params(jgp.make_restart_inits(spec, cfg, key)))
    launches = (tgram.LAUNCHES, tupd.LAUNCHES)
    tfit, tsel = tacq.fit_and_select(
        tspec, tcfg, torch.tensor(x_all[pilot]), torch.tensor(y_tr),
        torch.tensor(x_all), torch.tensor(pilot), rounds=10, num_pilot=12,
        strategy="mi", inits=inits,
    )
    assert (tgram.LAUNCHES, tupd.LAUNCHES) == launches
    np.testing.assert_allclose(float(tfit.nll), float(jfit.nll), rtol=1e-4)
    np.testing.assert_array_equal(tsel.selected.numpy(), np.asarray(jsel.selected))
    assert tsel.post_var.shape == (200,)
    np.testing.assert_allclose(tsel.post_var.numpy(), np.asarray(jsel.post_var),
                               atol=2e-3)


def test_unknown_strategy_raises(rng):
    params, tparams, x, K, nv = setup_field(rng, n=20)
    with pytest.raises(ValueError):
        tacq.greedy_select(tk.KernelSpec("rbf", ds=2), tparams,
                           torch.tensor(x, dtype=torch.float32), torch.full((20,), nv),
                           torch.zeros(0, dtype=torch.int64), rounds=2, num_pilot=0,
                           strategy="ucb")


# ------------------------------------------- the episode's plan step


def _plan_case(rng, n=90, cap=16, count=9, S=12, k_max=5):
    """A jittered field with a padded sampled set holding a repeated node,
    and padded path sets: zero-size paths and a set repeating a node."""
    params, tparams, x, _, _ = setup_field(rng, n=n)
    idx = np.zeros(cap, np.int64)
    idx[:count] = rng.choice(n, count, replace=False)
    idx[count - 1] = idx[2]  # a node measured twice
    ns = np.ones(cap, np.float32)
    ns[:count] = rng.choice([1.0, 25.0], count)
    y = np.zeros(cap, np.float32)
    y[:count] = rng.standard_normal(count)
    sets = rng.integers(0, n, (S, k_max))
    sizes = rng.integers(1, k_max + 1, S)
    sizes[[4, 9]] = 0  # padding paths
    sets[3, 2] = sets[3, 0]  # a path re-entering a cell
    sizes[3] = k_max
    sets[np.arange(k_max)[None, :] >= sizes[:, None]] = 0
    costs = rng.uniform(2.0, 6.0, S).astype(np.float32)
    costs[[4, 9]] = 1.0
    f_true = rng.standard_normal(n).astype(np.float32)
    obs = (rng.uniform(size=n) < 0.8).astype(np.float32)
    return params, tparams, x.astype(np.float32), dict(
        idx=idx, count=count, ns=ns, y=y, sets=sets, sizes=sizes, costs=costs,
        f_true=f_true, obs=obs, test=1.0 - obs)


def _plan_args(c, jax_side):
    if jax_side:
        return (jnp.asarray(c["idx"], jnp.int32), jnp.asarray(c["count"]),
                jnp.asarray(c["ns"]), jnp.asarray(c["y"]),
                jnp.asarray(c["sets"], jnp.int32), jnp.asarray(c["sizes"], jnp.int32),
                jnp.asarray(c["costs"]))
    return (torch.tensor(c["idx"]), c["count"], torch.tensor(c["ns"]),
            torch.tensor(c["y"]), torch.tensor(c["sets"]), torch.tensor(c["sizes"]),
            torch.tensor(c["costs"]))


@pytest.mark.parametrize("strategy,utility", [("mi", "per_cost"), ("entropy", "per_cost"),
                                              ("mi", "per_sample")])
def test_plan_episode_step_matches_reference(rng, strategy, utility):
    params, tparams, x, c = _plan_case(rng)
    spec, tspec = KernelSpec("rbf", ds=2), tk.KernelSpec("rbf", ds=2)
    kw = dict(strategy=strategy, min_noise=1e-3, nv_mult=4.0, path_utility=utility)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    JW = TW = (None, None)
    if strategy == "mi":
        JW = jacq.implicit_precision_seed(spec, params, xj, min_noise=1e-3, nv_mult=4.0)
        TW = tacq.implicit_precision_seed(tspec, tparams, xt, min_noise=1e-3,
                                          nv_mult=4.0)
        np.testing.assert_allclose(TW[0].numpy(), np.asarray(JW[0]), atol=1e-3)
        assert TW[1].is_contiguous() and torch.equal(TW[1], TW[0].T)
    jbest, jmean, jvar, jscores = jacq.plan_episode_step(
        spec, params, xj, *_plan_args(c, True), *JW, **kw)
    tbest, tmean, tvar, tscores = tacq.plan_episode_step(
        tspec, tparams, xt, *_plan_args(c, False), *TW, **kw)
    assert int(tbest) == int(jbest)
    assert c["sizes"][int(tbest)] > 0
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), atol=5e-3)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), atol=5e-3)
    js, ts = np.asarray(jscores), tscores.numpy()
    assert np.isfinite(ts).all() and np.isfinite(js).all()
    np.testing.assert_allclose(ts, js, rtol=5e-3, atol=5e-3)

    # the on-device metrics variant reduces the same step against a truth
    truth = [c["f_true"], c["obs"], c["test"]]
    jm = jacq.plan_episode_step_metrics(
        spec, params, xj, *_plan_args(c, True), *map(jnp.asarray, truth), *JW, **kw)
    tm = tacq.plan_episode_step_metrics(
        tspec, tparams, xt, *_plan_args(c, False), *map(torch.tensor, truth), *TW, **kw)
    assert int(tm[0]) == int(jm[0])
    for a, b in zip(tm[1:], jm[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3)


def test_implicit_corrections_match_reference(rng):
    params, tparams, x, c = _plan_case(rng, n=70)
    spec, tspec = KernelSpec("rbf", ds=2), tk.KernelSpec("rbf", ds=2)
    W, WT = jacq.implicit_precision_seed(spec, params, jnp.asarray(x))
    tW, tWT = tacq.implicit_precision_seed(tspec, tparams, torch.tensor(x))
    F, ZT = jacq.implicit_corrections(W, WT, jnp.asarray(c["idx"], jnp.int32),
                                      jnp.asarray(c["count"]))
    tF, tZT = tacq.implicit_corrections(tW, tWT, torch.tensor(c["idx"]), c["count"])
    scale = np.abs(np.asarray(F)).max()
    np.testing.assert_allclose(tF.numpy(), np.asarray(F), atol=2e-3 * scale)
    np.testing.assert_allclose(tZT.numpy(), np.asarray(ZT), atol=2e-3)


@pytest.mark.parametrize("utility", ["per_cost", "per_sample"])
def test_path_set_argmax_matches_reference_with_ties(utility):
    scores = np.array([1.0, 3.0, 3.0, -2.0, 9.0, 3.0], np.float32)
    sizes = np.array([2, 3, 3, 1, 0, 3], np.int64)  # index 4 is padding
    costs = np.array([1.5, 2.0, 2.0, 1.0, 1.0, 2.0], np.float32)
    want = jacq.path_set_argmax(jnp.asarray(scores), jnp.asarray(sizes, jnp.int32),
                                jnp.asarray(costs), path_utility=utility)
    got = tacq.path_set_argmax(torch.tensor(scores), torch.tensor(sizes),
                               torch.tensor(costs), path_utility=utility)
    assert int(got) == int(want) == 1  # the first of three tied paths
    with pytest.raises(ValueError):
        tacq.path_set_argmax(torch.tensor(scores), torch.tensor(sizes),
                             torch.tensor(costs), path_utility="per_hour")
