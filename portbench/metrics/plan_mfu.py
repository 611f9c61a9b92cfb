"""plan_mfu: the plan calls' share of the card's FP32 peak over the time
that the window's plan calls took (the time plan_wait_ms averages), from
the flops the plain algorithm needs for what those calls wait for
(work.episode_flops without fits): each call's conditioning on its m
samples (the (m, N) cross-Gram, the triangular solve m²N, the mean and
variance 4mN), the k-center design and the low-rank seed of each
episode's first call, and each re-seed that a refit queues just before
the next call (one a fit: the (M, N) Gram, L_zz⁻¹K_zx M²N,
B = I + Σ u uᵀ/d 2M²N).  A terminal call (no path left) runs the final
posterior instead: one more conditioning pass at its m, counted as the
others.  Left out: the path sets' scores (under 1 % of a call) and the
final posterior where it runs after a last call that still had a path."""


def read(ctx):
    c = ctx.config
    n = c["num_rows"] * c["num_cols"]
    n_design = (c["kcenter_target"] if n > c["kcenter_subsample"] else n)
    flops = wall = 0.0
    for a in ctx.answers.values():
        plans = a.get("plans", [])
        flops += ctx.work.episode_flops(n, c["num_inducing"], n_design,
                                        [p["n_sampled"] for p in plans],
                                        seeds=max(1, len(a.get("fits", []))))
        wall += sum(p["wall"] for p in plans)
    return 100.0 * flops / wall / ctx.work.PEAK_FP32_FLOPS if wall > 0 else None
