"""Each cell's traffic, run through the port on the CPU (its plain
versions of the kernels) at a small size, comes out correct against the
reference; and the reference itself agrees with a dense textbook
computation."""

import math
import time

import pytest
import torch

from portbench import harness
from portbench.reference import gp as ref
from portbench.tests.conftest import small, small_config

M = harness.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_correct_on_cpu(cell, traced, one_thread):
    r = harness.run_cell(M, cell, 2 ** 33 + 7, 0.5, traced, "cpu", time.perf_counter(),
                         small(M, cell))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    want = {m["name"] for m in harness.metrics_of(M, cell, "per_layer" if traced else "end_to_end")}
    got = set(r["metrics"])
    assert got <= want
    if not traced:
        assert got == want


def _setup(config_name, traffic_name, seed):
    cfg = {**harness.config(M, config_name), **small_config(config_name)}
    tr = harness.traffic(traffic_name)
    drv = harness.driver(tr["driver"]).make(cfg, tr, seed, "cpu")
    drv.setup()
    return drv


def test_same_seed_same_inputs():
    a, b = (_setup("main10k", "select", 2 ** 40 + 3) for _ in range(2))
    for k in ("f", "pilots", "y"):
        assert torch.equal(getattr(a, k), getattr(b, k))
    m = small_config("main10k")["num_pilot"]
    assert all(len(set(p.tolist())) == m for p in a.pilots[:50])
    c, d = (_setup("c5_4m", "fixed_hypers", 2 ** 40 + 3) for _ in range(2))
    assert torch.equal(c.env.f_dev, d.env.f_dev)
    assert torch.equal(c.init_table(3, 4, 2, torch.float64), d.init_table(3, 4, 2, torch.float64))


def _dense_mi_scores(K, nv, A, rest):
    """Krause's ratio for every y in `rest` by explicit inverses."""
    out = {}
    for y in rest:
        KA = K[A][:, A] + torch.diag(nv[A]) if A else None
        num = K[y, y] + nv[y]
        if A:
            kyA = K[y, A]
            num = num - kyA @ torch.linalg.solve(KA, kyA)
        R = [r for r in rest if r != y]
        KR = K[R][:, R] + torch.diag(nv[R])
        kyR = K[y, R]
        den = K[y, y] + nv[y] - kyR @ torch.linalg.solve(KR, kyR)
        out[y] = float(num / den)
    return out


def test_reference_mi_matches_dense_definition(one_thread):
    g = torch.Generator().manual_seed(5)
    x = torch.rand((24, 2), generator=g, dtype=torch.float64) * 6
    log_ls = torch.log(torch.tensor([1.3, 0.9], dtype=torch.float64))
    log_s2 = torch.tensor(0.2, dtype=torch.float64)
    nv = torch.full((24,), 0.05, dtype=torch.float64)
    pil = torch.tensor([3, 11])
    out = ref.greedy_mi("rbf", x, nv, pil, nv[pil], log_ls, log_s2, 4)
    K = ref.gram("rbf", x, x, log_ls, log_s2)
    A = [3, 11]
    for j in out["selected"].tolist():
        rest = [i for i in range(24) if i not in A]
        s = _dense_mi_scores(K, nv, A, rest)
        assert j == max(s, key=lambda k: (s[k], -k))
        A.append(j)
    # the posterior variance after all picks, by the textbook formula
    KA = K[A][:, A] + torch.diag(nv[A])
    post = torch.diagonal(K) - ((K[:, A] @ torch.linalg.inv(KA)) * K[:, A]).sum(1)
    assert torch.allclose(out["post_var"], post, atol=1e-10)
    # following its own picks reads gaps of zero
    again = ref.greedy_mi("rbf", x, nv, pil, nv[pil], log_ls, log_s2, 4, follow=out["selected"])
    assert again["gaps"] == [0.0] * 4


def test_reference_follow_flags_a_taken_site():
    x = torch.arange(10, dtype=torch.float64)[:, None].expand(10, 2).clone()
    nv = torch.full((10,), 0.1, dtype=torch.float64)
    z = torch.zeros(2, dtype=torch.float64)
    out = ref.greedy_mi("rbf", x, nv, torch.tensor([2]), nv[:1], z, z[0], 2,
                        follow=torch.tensor([2, 5]))
    assert out["gaps"] == [math.inf]


def test_reference_fit_descends_and_picks_the_best_restart(one_thread):
    g = torch.Generator().manual_seed(9)
    x = torch.rand((16, 2), generator=g, dtype=torch.float64) * 10
    y = torch.sin(x[:, 0] / 3) + 0.1 * torch.randn(16, generator=g, dtype=torch.float64)
    inits = {"log_ls": torch.zeros((3, 2), dtype=torch.float64) + torch.tensor([[0.0], [0.5], [-0.5]], dtype=torch.float64),
             "log_s2": torch.zeros(3, dtype=torch.float64),
             "log_noise": torch.full((3,), math.log(0.1), dtype=torch.float64)}
    f = ref.fit_adam("rbf", x, y, inits, iters=60, lr=0.05, min_noise=1e-3, jitter=1e-6)
    start = ref.neg_mll("rbf", x, y, inits["log_ls"], inits["log_s2"], inits["log_noise"],
                        min_noise=1e-3, jitter=1e-6)
    assert (f["all_nlls"] <= start).all()
    assert f["best_restart"] == int(torch.argmin(f["all_nlls"]))
    assert float(f["nll"]) == float(f["all_nlls"].min())


def test_refit_traffic_agrees_with_the_reference(one_thread):
    """The refitting episode traffic at a small size: each fit's first
    Adam steps and its reported NLL agree with the reference from the same
    inits (a warm refit's restart 0 from the program's incumbent), and the
    plans agree at the program's fitted hyperparameters."""
    drv = _setup("c5_4m", "refit4", 2 ** 36 + 9)
    drv.call(0)
    a = drv.answers[0]
    assert len(a["fits"]) >= 2 and drv.validity(a)
    assert a["fits"][0]["incumbent"] is None and a["fits"][1]["incumbent"] is not None
    got = drv.check(0, a)
    assert got["fit_trace_gap"] < 1e-5 and got["fit_nll_gap"] < 1e-5, got
    assert got["path_gap"] == 0.0, got
    assert got["rmse_gap"] < 1e-4 and got["var_gap"] < 1e-4, got
    steps = drv.describe(a)["fit_step_gaps"]
    assert len(steps) == len(a["fits"]) and all(len(s) == 20 for s in steps)


def test_reference_fit_trace_is_the_nll_before_each_step(one_thread):
    g = torch.Generator().manual_seed(4)
    x = torch.rand((12, 2), generator=g, dtype=torch.float64) * 8
    y = torch.cos(x[:, 1] / 2) + 0.1 * torch.randn(12, generator=g, dtype=torch.float64)
    inits = {"log_ls": torch.zeros((2, 2), dtype=torch.float64),
             "log_s2": torch.tensor([0.0, 0.3], dtype=torch.float64),
             "log_noise": torch.full((2,), math.log(0.1), dtype=torch.float64)}
    kw = dict(lr=0.05, min_noise=1e-3, jitter=1e-6)
    f = ref.fit_adam("matern32", x, y, inits, iters=3, **kw)
    start = ref.neg_mll("matern32", x, y, inits["log_ls"], inits["log_s2"], inits["log_noise"],
                        min_noise=1e-3, jitter=1e-6)
    assert f["trace"].shape == (2, 3)
    assert torch.equal(f["trace"][:, 0], start)
    longer = ref.fit_adam("matern32", x, y, inits, iters=5, **kw)
    assert torch.equal(longer["trace"][:, :3], f["trace"])
    # a noise scale of 2 is the noise variance doubled
    ns = torch.full((12,), 2.0, dtype=torch.float64)
    doubled = ref.neg_mll("matern32", x, y, inits["log_ls"], inits["log_s2"],
                          inits["log_noise"] + 0.5 * math.log(2.0), min_noise=1e-3, jitter=1e-6)
    scaled = ref.neg_mll("matern32", x, y, inits["log_ls"], inits["log_s2"], inits["log_noise"],
                         min_noise=1e-3, jitter=1e-6, noise_scale=ns)
    assert torch.allclose(doubled, scaled, rtol=1e-12)
