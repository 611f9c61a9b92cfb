"""step_mfu: the episodes' share of the card's FP32 peak over the window,
from the flops that the plain algorithm needs for what the window ran
(work.episode_flops): each plan call's conditioning on its m samples
(the (m, N) cross-Gram, the triangular solve m²N, the mean and variance
4mN), the final posterior's, each fit and the low-rank seed after it
(one seed where no fit runs: the (M, N) Gram, L_zz⁻¹K_zx M²N,
B = I + Σ u uᵀ/d 2M²N) and each episode's k-center design; the path
sets' scores, under 1 % of a step, are left out."""


def _posteriors(a) -> list:
    """The sample counts of the episode's posterior passes: one a plan
    call, and the final one where the last plan still had a path."""
    m = [p["n_sampled"] for p in a["plans"]]
    return m + [len(a["sampled_idx"])] if a["plans"][-1]["sites"] else m


def read(ctx):
    if not ctx.calls:
        return None
    c = ctx.config
    n = c["num_rows"] * c["num_cols"]
    n_design = (c["kcenter_target"] if n > c["kcenter_subsample"] else n)
    flops = 0.0
    for a in ctx.answers.values():
        fits = [(f["n_sampled"], c["fit_restarts"] if k == 0 else c["refit_restarts"],
                 c["fit_iters"] if k == 0 else c["refit_iters"])
                for k, f in enumerate(a["fits"])]
        flops += ctx.work.episode_flops(n, c["num_inducing"], n_design, _posteriors(a),
                                        seeds=max(1, len(fits)), fits=fits)
    return 100.0 * flops / ctx.window_s / ctx.work.PEAK_FP32_FLOPS
