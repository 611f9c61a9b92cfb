"""The final posterior and its calibration of one episode against
another's (the reference's on the CPU, or the port's CPU run beside its
card run), on the same field and sites.  Imports no JAX, so the card
tests use it too."""

import json

import numpy as np
import pytest


def held_out_diagnostics(res, env):
    """The held-out calibration, the held-out cells' smallest final
    variance, how many sit below 1e-6, and the largest per-cell NLPD term
    (σ² floored at 1e-12, as `FieldEnv.calibration` floors it)."""
    mask = env.test_mask
    v = np.asarray(res.var, np.float64)[mask]
    d = np.asarray(res.mean, np.float64)[mask] - env.f[mask]
    vf = np.maximum(v, 1e-12)
    term = 0.5 * (np.log(2.0 * np.pi * vf) + d * d / vf)
    return {**{k: res.calibration[k] for k in ("nlpd_test", "cov90_test", "cov95_test")},
            "min_var_test": float(v.min()), "n_var_below_1e-6": int((v < 1e-6).sum()),
            "max_nlpd_term": float(term.max())}


def same_posterior(want, got, env, label="", names=("reference", "port")):
    """The final posterior and its calibration of `got` against `want`'s:
    mean and variance within atol 5e-3; wherever either variance is below
    1e-3, the log variance within 0.05 up to the f32 resolution of
    k** − q (16 units in the last place of the prior variance s²: two f32
    evaluations of a variance a few dozen such units above zero part by a
    few units); each coverage within one cell's share of its mask, NLPD
    within 2e-2 relative.  Prints both runs' held-out diagnostics first
    (under `names`), so a failure shows where it comes from."""
    print(label, json.dumps({names[0]: held_out_diagnostics(want, env),
                             names[1]: held_out_diagnostics(got, env)}))
    jm, jv = (np.asarray(a, np.float64) for a in (want.mean, want.var))
    tm, tv = (np.asarray(a, np.float64) for a in (got.mean, got.var))
    np.testing.assert_allclose(tm, jm, rtol=0, atol=5e-3)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=5e-3)
    low = np.minimum(jv, tv)
    small = low < 1e-3
    s2 = float(np.exp(np.max(np.asarray(want.state.params.log_outputscale))))
    ulps = 16 * np.finfo(np.float32).eps * s2
    np.testing.assert_array_less(np.abs(tv - jv)[small],
                                 np.expm1(0.05) * np.maximum(low[small], 0.0) + ulps)
    for sfx, mask in (("", env.observed_mask), ("_test", env.test_mask)):
        share = 1.0 / int(mask.sum())
        for k in ("cov90", "cov95"):
            assert abs(got.calibration[k + sfx] - want.calibration[k + sfx]) <= share * (1 + 1e-9), k + sfx
        assert got.calibration["nlpd" + sfx] == pytest.approx(
            want.calibration["nlpd" + sfx], rel=2e-2), "nlpd" + sfx
