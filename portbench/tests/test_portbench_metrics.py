"""The metric arithmetic: a window over a count, a percentile over all
samples, the idle share from an interval list, a roofline share."""

import types

import pytest

from portbench import harness, trace, work


def ctx(**kw):
    base = dict(cell="main10k.select", config={"num_rows": 100, "num_cols": 100,
                                               "num_pilot": 32, "rounds": 50,
                                               "fit_restarts": 4, "fit_iters": 100},
                traffic={}, setup_s=12.5, window_s=10.0, calls=40, trace=None,
                work=work, names=harness.metric_names,
                metrics_dir=harness.PKG / "metrics", quantile=harness.quantile)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_window_over_completed_calls():
    assert harness.metric_reader("select_ms").read(ctx()) == pytest.approx(250.0)
    assert harness.metric_reader("step_ms").read(ctx(calls=0)) is None
    assert harness.metric_reader("setup_s").read(ctx()) == 12.5


def test_p95_over_all_samples():
    vals = list(range(1, 101))
    assert harness.quantile(vals, 0.95) == pytest.approx(95.05)
    assert harness.quantile([3.0] * 7 + [100.0], 0.95) == pytest.approx(66.05)


def test_idle_share_of_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]  # overlap counts once: busy 3
    assert trace.union_length(iv) == pytest.approx(3.0)
    assert trace.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    t = trace.Trace(window=(0.0, 5.0), device=[(s, e, "k") for s, e in iv], host=[], calls=1,
                    wall_s=5.0)
    assert harness.metric_reader("idle_share.step").read(ctx(trace=t)) == pytest.approx(40.0)
    t.window = (1.0, 3.0)
    assert harness.metric_reader("idle_share.select").read(ctx(trace=t)) == pytest.approx(50.0)


def test_trace_reduction():
    t = trace.Trace(window=(0.0, 10.0),
                    device=[(1.0, 2.0, "void gram_kernel<0>"), (1.5, 3.0, "gemm"),
                            (6.0, 6.5, "void gram_kernel<0>")],
                    host=[(0.0, 10.0, "call"), (3.0, 6.0, "aten::cholesky"),
                          (6.5, 10.0, "aten::copy_")],
                    calls=2, wall_s=10.0)
    assert t.busy_s == pytest.approx(2.5)
    assert t.device_time(lambda n: "gram_kernel" in n) == pytest.approx(1.5)
    assert t.top_ops()[0] == ["void gram_kernel<0>", pytest.approx(1.5)]
    gaps = t.idle_gaps()
    assert gaps[0] == ["aten::copy_", pytest.approx(3.5)]
    assert gaps[1] == ["aten::cholesky", pytest.approx(3.0)]
    assert gaps[2] == ["call", pytest.approx(1.0)]
    share = harness.metric_reader("idle_share.select").read(ctx(trace=t))
    assert share == pytest.approx(75.0)


def test_gram_roofline_share():
    bound = (work.roofline_bound_s(work.gram_flops(10_000, 10_000, 2),
                                   work.gram_bytes(10_000, 10_000, 2, noise=True))
             + work.roofline_bound_s(work.gram_flops(32, 10_000, 2),
                                     work.gram_bytes(32, 10_000, 2)))
    assert bound == pytest.approx(4.0e8 / 3.35e12, rel=0.01)
    t = trace.Trace(window=(0.0, 1.0), device=[(0.0, 2 * bound / 0.8, "gram_kernel<1>")],
                    host=[], calls=2, wall_s=1.0)
    c = ctx(trace=t)
    assert harness.metric_reader("gram_roofline.select").read(c) == pytest.approx(80.0)
    empty = trace.Trace(window=(0.0, 1.0), device=[], host=[], calls=2, wall_s=1.0)
    assert harness.metric_reader("gram_roofline.select").read(ctx(trace=empty)) is None


def test_mfu_shares():
    f = sum(work.greedy_mi_flops(10_000, 32, 50).values())
    got = harness.metric_reader("select_mfu").read(ctx())
    assert got == pytest.approx(100 * f * 40 / 10.0 / 67e12)


def _episode(samples, last_sites=True):
    plans = [{"n_sampled": m, "sites": [1, 2], "wall": 0.05} for m in samples]
    plans[-1]["sites"] = [3] if last_sites else []
    return {"plans": plans, "fits": [], "sampled_idx": list(range(samples[-1] + 1)),
            "latencies": [0.1] * len(samples),
            "records": [{"step_s": 0.02, "enum_s": 0.004}] * len(samples)}


C5 = {"num_rows": 8, "num_cols": 8, "num_inducing": 4, "kcenter_subsample": 100,
      "kcenter_target": 16, "max_samples": 6, "fit_restarts": 4, "fit_iters": 10,
      "refit_restarts": 2, "refit_iters": 5, "refit_every": 4}


def test_episode_flops_hand_count():
    # n = 64, M = 4, design over 64 points; plans at m = 2 and 3
    seed = 4 * 64 * 10 + 3 * 16 * 64 + 4 * 4 * 64
    plans = sum(m * 64 * 10 + m * m * 64 + 4 * m * 64 for m in (2, 3))
    assert work.episode_flops(64, 4, 64, [2, 3]) == pytest.approx(seed + plans)
    a = _episode([2, 3])
    got = harness.metric_reader("step_mfu").read(ctx(config=C5, answers={0: a}, calls=2))
    want = work.episode_flops(64, 4, 64, [2, 3, 4]) / 10.0 / 67e12 * 100
    assert got == pytest.approx(want)
    b = _episode([2, 3], last_sites=False)
    got = harness.metric_reader("step_mfu").read(ctx(config=C5, answers={0: b}, calls=2))
    assert got == pytest.approx(work.episode_flops(64, 4, 64, [2, 3]) / 10.0 / 67e12 * 100)
    # a pilot fit and a warm refit: two seeds and the fits' own flops
    b["fits"] = [{"n_sampled": 2, "step": 0}, {"n_sampled": 3, "step": 4}]
    got = harness.metric_reader("step_mfu").read(ctx(config=C5, answers={0: b}, calls=2))
    want = (work.episode_flops(64, 4, 64, [2, 3]) + seed - 4 * 4 * 64
            + work.adam_fit_flops(2, 4, 10) + work.adam_fit_flops(3, 2, 5))
    assert got == pytest.approx(want / 10.0 / 67e12 * 100)


def test_gram_roofline_step_bound():
    # two plans at m = 2 and 3, the second with no path, so the final
    # posterior over the episode's 4 samples; one seed at M = 4; n = 64
    a = _episode([2, 3], last_sites=False)

    def cross(m):
        return work.roofline_bound_s(work.gram_flops(m, 64, 2), work.gram_bytes(m, 64, 2))
    want = cross(2) + cross(4) + cross(4)
    t = trace.Trace(window=(0.0, 1.0), device=[(0.0, want / 0.5, "gram_kernel<1>")],
                    host=[], calls=2, wall_s=1.0, runs=1)
    got = harness.metric_reader("gram_roofline.step").read(ctx(config=C5, trace=t, traced={0: a}))
    assert got == pytest.approx(50.0)
    # rows are the samples a plan needs, not the capacity (6 here)
    assert cross(2) < cross(C5["max_samples"])


def test_refit_ms_is_the_mean_of_fit_records():
    recs = [{"phase": "pilot", "step": 0, "fit_s": 0.7},
            {"phase": "plan", "step": 1, "fit_s": 0.0},
            {"phase": "plan", "step": 4, "fit_s": 0.3},
            {"phase": "plan", "step": 5, "fit_s": 0.0},
            {"phase": "plan", "step": 8, "fit_s": 0.2}]
    got = harness.metric_reader("refit_ms.step").read(ctx(config=C5, answers={0: {"records": recs}}))
    assert got == pytest.approx(400.0)
    assert harness.metric_reader("refit_ms.step").read(ctx(config=C5, answers={})) is None


def test_plan_wait_is_the_mean_over_every_plan_call():
    a, b = _episode([2, 3]), _episode([2, 3, 4])
    b["plans"][0]["wall"] = 0.2  # the first call carries the design and seed
    got = harness.metric_reader("plan_wait_ms").read(ctx(config=C5, answers={0: a, 1: b}))
    assert got == pytest.approx(1e3 * (4 * 0.05 + 0.2) / 5)
    assert harness.metric_reader("plan_wait_ms").read(ctx(config=C5, answers={})) is None


def test_plan_mfu_counts_what_the_plan_calls_wait_for():
    # two calls at m = 2 and 3 over 0.1 s: the design, one seed and two
    # conditioning passes; no fit flops, no final posterior
    a = _episode([2, 3], last_sites=True)
    got = harness.metric_reader("plan_mfu").read(ctx(config=C5, answers={0: a}))
    assert got == pytest.approx(work.episode_flops(64, 4, 64, [2, 3]) / 0.1 / 67e12 * 100)
    # with a pilot fit and a refit: a second seed, still no fit flops
    a["fits"] = [{"n_sampled": 2, "step": 0}, {"n_sampled": 3, "step": 4}]
    got = harness.metric_reader("plan_mfu").read(ctx(config=C5, answers={0: a}))
    want = work.episode_flops(64, 4, 64, [2, 3], seeds=2)
    assert got == pytest.approx(want / 0.1 / 67e12 * 100)
    assert harness.metric_reader("plan_mfu").read(ctx(config=C5, answers={})) is None


@pytest.mark.parametrize("name,of", [("step_ms.refit4", "step_ms"),
                                     ("step_mfu.refit4", "step_mfu"),
                                     ("refit_step_ms_p95.step", "step_ms_p95.step"),
                                     ("idle_share.refit4", "idle_share.step")])
def test_refit4_readers_read_as_their_originals(name, of):
    t = trace.Trace(window=(0.0, 1.0), device=[(0.0, 0.6, "k")], host=[], calls=2, wall_s=1.0)
    c = ctx(config=C5, answers={0: _episode([2, 3])}, calls=2, trace=t)
    got = harness.metric_reader(name).read(c)
    assert got is not None and got == harness.metric_reader(of).read(c)
