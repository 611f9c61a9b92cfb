"""`FieldEnv.evaluate` and the episode's evaluation of its final posterior.

`evaluate` reduces a posterior field's RMSEs, mean variance and
calibration where the field lies, in float64; it is held to the numpy
formulas of `FieldEnv.rmse` and `FieldEnv.calibration`, copied here as
the oracle, within rtol 1e-12.  An episode reads those numbers with its
final posterior in one device→host copy, so `EpisodeResult` and the
`calibration` record carry them, and the record says how long the read
took (`eval_s`) and where the numbers were reduced (`eval_device`).

The file imports no JAX.  Its `cuda` test needs an NVIDIA GPU and nvcc and
skips without one; on the card run it without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_episode_eval.py -q
"""

import csv
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from algp_tpu_torch.config import (AcquisitionConfig, EpisodeConfig, ExperimentConfig,
                                   FieldConfig, FitConfig)
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.field import EVALUATION, FieldEnv
from algp_tpu_torch.ops.kernels import KernelSpec

RTOL = 1e-12
CALIBRATION = ("nlpd", "cov90", "cov95", "nlpd_test", "cov90_test", "cov95_test")


# -------------------------------------------------- the numpy oracle (host)

def _rmse(env, mean, test_only=False):
    m = np.asarray(mean, np.float64)
    mask = env.test_mask if test_only else env.observed_mask
    return float(np.sqrt(np.mean((m[mask] - env.f[mask]) ** 2)))


def _calibration(env, mean, var, test_only=False):
    m = np.asarray(mean, np.float64)
    v = np.maximum(np.asarray(var, np.float64), 1e-12)
    mask = env.test_mask if test_only else env.observed_mask
    d = m[mask] - env.f[mask]
    vm = v[mask]
    nlpd = 0.5 * np.mean(np.log(2.0 * np.pi * vm) + d * d / vm)
    z = np.abs(d) / np.sqrt(vm)
    return {
        "nlpd": float(nlpd),
        "cov90": float(np.mean(z <= 1.6448536269514722)),
        "cov95": float(np.mean(z <= 1.959963984540054)),
    }


def _oracle(env, mean, var) -> dict:
    out = {"rmse": _rmse(env, mean), "rmse_test": _rmse(env, mean, test_only=True),
           "mean_var": float(np.mean(np.asarray(var, np.float64)))}
    out.update(_calibration(env, mean, var))
    out.update({k + "_test": v for k, v in
                _calibration(env, mean, var, test_only=True).items()})
    return out


def _assert_numbers(got: dict, want: dict, keys=EVALUATION):
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=RTOL, abs=0.0), k


# ------------------------------------------------------------------- envs

def _synthetic_env(device="cpu"):
    cfg = FieldConfig(num_rows=18, num_cols=23, true_ls_spatial=4.0, seed=5)
    return FieldEnv(cfg, KernelSpec("rbf", ds=2), device=device)


def _table_env(tmp_path):
    """A 9 × 11 table with gaps in its truth (cells that condition the GP
    but are no ground truth)."""
    rng = np.random.default_rng(2)
    rows, cols = 9, 11
    rec = [{"row": r, "range": c, "height": f"{100.0 + 3 * r + rng.normal():.4f}"}
           for r in range(rows) for c in range(cols)]
    for i in (0, 1, 2, 17, 40, 41, 77):
        rec[i]["height"] = ""
    path = tmp_path / "field.csv"
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["row", "range", "height"])
        w.writeheader()
        w.writerows(rec)
    env = FieldEnv(FieldConfig(num_rows=rows, num_cols=cols, data_path=str(path)),
                   device="cpu")
    assert 0 < (~env.observed_mask).sum() < env.n
    return env


def _posterior(env, seed, floor_cases=False):
    """A posterior (mean, var), f32, near the truth; with `floor_cases`
    some variances at zero, below 1e-12 or slightly negative."""
    rng = np.random.default_rng(seed)
    mean = (env.f + 0.4 * rng.standard_normal(env.n)).astype(np.float32)
    var = rng.uniform(0.02, 0.5, env.n).astype(np.float32)
    if floor_cases:
        var[::5] = 0.0
        var[1::7] = 3e-15
        var[2::11] = -2e-9
    return mean, var


def _evaluated(env, mean, var) -> dict:
    ev = env.evaluate(torch.as_tensor(mean), torch.as_tensor(var))
    assert ev.dtype == torch.float64 and ev.shape == (len(EVALUATION),)
    return dict(zip(EVALUATION, ev.tolist()))


# ---------------------------------------------------------------- evaluate

@pytest.mark.parametrize("floor_cases", [False, True])
@pytest.mark.parametrize("kind", ["synthetic", "table"])
def test_evaluate_equals_the_numpy_formulas(tmp_path, kind, floor_cases):
    """Every number of `evaluate`, all cells and held out (both `test_only`
    forms of the host methods), against the numpy formulas; the env's own
    `rmse` / `calibration` read the same."""
    env = _synthetic_env() if kind == "synthetic" else _table_env(tmp_path)
    mean, var = _posterior(env, 7, floor_cases)
    got, want = _evaluated(env, mean, var), _oracle(env, mean, var)
    _assert_numbers(got, want)
    for test_only in (False, True):
        sfx = "_test" if test_only else ""
        assert env.rmse(mean, test_only) == want["rmse" + sfx]
        for k, v in env.calibration(mean, var, test_only).items():
            assert v == want[k + sfx]
    if floor_cases:
        assert np.isfinite(list(got.values())).all()


def test_evaluate_closed_forms():
    """A posterior centred on the truth at constant variance c: RMSE 0,
    NLPD ½log(2πc) and full coverage; offset by 1.8σ: inside the 95 %
    interval, outside the 90 % one."""
    env = _synthetic_env()
    c = 0.25
    f = torch.as_tensor(env.f.astype(np.float32))
    v = torch.full((env.n,), c)
    got = dict(zip(EVALUATION, env.evaluate(f, v).tolist()))
    want_rmse = _rmse(env, f.numpy())  # the truth's f32 rounding
    assert got["rmse"] == pytest.approx(want_rmse, rel=RTOL) and want_rmse < 1e-7
    assert got["mean_var"] == c
    assert got["cov90"] == got["cov95"] == got["cov90_test"] == got["cov95_test"] == 1.0
    assert got["nlpd"] == pytest.approx(0.5 * np.log(2 * np.pi * c), rel=1e-9)
    off = torch.as_tensor(env.f + 1.8 * np.sqrt(c))
    got = dict(zip(EVALUATION, env.evaluate(off, v.double()).tolist()))
    assert got["cov90"] == got["cov90_test"] == 0.0
    assert got["cov95"] == got["cov95_test"] == 1.0


def test_device_truth_is_built_once_and_holds_the_masks(tmp_path):
    """The env's device copies: the exact f64 truth, the 0/1 masks as f32
    and their counts; the Agent's `_truth` hands the same tensors to the
    plan step (its f32 truth `f_dev`)."""
    env = _table_env(tmp_path)
    t = env.device_truth()
    assert env.device_truth() is t
    np.testing.assert_array_equal(t.f.numpy(), env.f)
    assert t.f.dtype == torch.float64
    np.testing.assert_array_equal(t.observed.numpy(), env.observed_mask.astype(np.float32))
    np.testing.assert_array_equal(t.test.numpy(), env.test_mask.astype(np.float32))
    assert (t.n_observed, t.n_test) == (env.observed_mask.sum(), env.test_mask.sum())
    cfg = dataclasses.replace(_experiment(0, True), field=env.cfg)
    f_true, obs, test = Agent(env, cfg)._truth()
    assert f_true is env.f_dev and obs is t.observed and test is t.test
    np.testing.assert_array_equal(f_true.numpy(), env.f.astype(np.float32))


# ----------------------------------------------------------------- episode

def _experiment(num_inducing: int, device_metrics: bool) -> ExperimentConfig:
    return ExperimentConfig(
        kernel=KernelSpec("matern32", ds=2),
        field=FieldConfig(num_rows=10, num_cols=14, true_ls_spatial=4.0, seed=4),
        fit=FitConfig(iters=8, restarts=2, refit_iters=4, refit_restarts=1),
        acquisition=AcquisitionConfig(strategy="mi", num_inducing=num_inducing),
        episode=EpisodeConfig(num_pilot=10, budget=24.0, num_waypoints=4,
                              samples_per_step=4, refit_every=2, seed=4,
                              device_metrics=device_metrics),
    )


@pytest.mark.parametrize("device_metrics", [True, False])
@pytest.mark.parametrize("num_inducing", [0, 24], ids=["exact", "lowrank"])
def test_episode_reads_its_evaluation_with_the_final_posterior(num_inducing,
                                                               device_metrics):
    """`EpisodeResult`'s RMSEs and calibration and the terminal plan
    record's RMSEs and mean variance equal the numpy formulas applied to
    the final posterior the result holds; the `calibration` record carries
    them with `eval_s` and `eval_device`."""
    cfg = _experiment(num_inducing, device_metrics)
    env = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    res = Agent(env, cfg).run()
    assert isinstance(res.mean, np.ndarray) and isinstance(res.var, np.ndarray)
    assert res.mean.shape == res.var.shape == (env.n,)
    want = _oracle(env, res.mean, res.var)
    got = {"rmse": res.rmse, "rmse_test": res.rmse_test, **res.calibration}
    assert set(res.calibration) == set(CALIBRATION)
    _assert_numbers(got, want, ("rmse", "rmse_test") + CALIBRATION)

    phases = [h["phase"] for h in res.history]
    assert "final" in phases  # the episode ended on its terminal plan call
    last = [h for h in res.history if h["phase"] == "plan"][-1]
    assert last["n_sampled"] == len(res.state.sampled_idx)
    _assert_numbers(last, want, ("rmse", "rmse_test", "mean_var"))

    rec = res.history[-1]
    assert rec["phase"] == "calibration"
    for k in CALIBRATION:
        assert rec[k] == round(want[k], 6), k
    assert rec["eval_device"] == "cpu"
    assert 0.0 <= rec["eval_s"] < 60.0


# ------------------------------------------------------------------- card

@pytest.mark.cuda
def test_evaluation_on_the_card_syncs_only_in_its_one_read():
    """On a 1024² field: `evaluate` runs with no device→host sync, the
    final fetch (`Agent._evaluated_field`) makes exactly one, and the 9
    numbers equal numpy's on the fetched field within rtol 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    side = 1024
    rng = np.random.default_rng(11)
    truth = rng.standard_normal(side * side).astype(np.float32)
    spec = KernelSpec("matern32", ds=2)
    cfg = ExperimentConfig(
        kernel=spec, field=FieldConfig(num_rows=side, num_cols=side, seed=11),
        acquisition=AcquisitionConfig(strategy="mi", num_inducing=64),
        episode=EpisodeConfig(num_pilot=64, max_samples=128))
    env = FieldEnv(cfg.field, spec, device=dev, truth=truth)
    mean, var = (torch.as_tensor(a, device=dev) for a in _posterior(env, 3, True))
    env.device_truth()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev = env.evaluate(mean, var)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_numbers(dict(zip(EVALUATION, ev.cpu().tolist())),
                    _oracle(env, mean.cpu().numpy(), var.cpu().numpy()))

    def fetch():
        agent = Agent(env, cfg)
        st = agent.pilot_survey()
        st.params = spec.init_params(ls_spatial=40.0, noise=0.1, device=dev)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = agent._evaluated_field(st)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, [w for w in caught if "synchroniz" in str(w.message)]

    fetch()  # builds the kernels
    (m, v, numbers, device), syncs = fetch()
    assert len(syncs) == 1, [f"{w.filename}:{w.lineno}" for w in syncs]
    assert device == "cuda"
    _assert_numbers(dict(zip(EVALUATION, numbers.tolist())), _oracle(env, m, v))
