"""gram_roofline.step: the Gram kernel's share of its roofline in the
traced sub-window of c5_4m's episodes.  Its work is what each traced
episode needs of it: every plan call's (m, N) cross-Gram of the
conditioning pass on its m samples and the final posterior's on all of
them (the rows the plain algorithm needs, not the kernel's padded
capacity), and each low-rank seed's (M, N) K_zx, each bounded by
max(bytes / 3.35 TB/s, flops / 67 TFLOP/s).  Its time: the summed device
time of the operations named in gram_roofline.step.names.  The traced
episodes are the first calls of the run (ctx.traced)."""


def bound(ctx) -> float:
    c, w = ctx.config, ctx.work
    n, M = c["num_rows"] * c["num_cols"], c["num_inducing"]

    def cross(m):
        return w.roofline_bound_s(w.gram_flops(m, n, 2), w.gram_bytes(m, n, 2))

    total = 0.0
    for a in ctx.traced.values():
        conditioned = [p["n_sampled"] for p in a["plans"] if p["sites"]]
        # + the final posterior's; one seed a fit, or one where none runs
        total += (sum(cross(m) for m in conditioned) + cross(len(a["sampled_idx"]))
                  + max(1, len(a["fits"])) * cross(M))
    return total


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced:
        return None
    names = ctx.names(ctx.metrics_dir / "gram_roofline.step.names")
    busy = t.device_time(lambda op: any(p in op for p in names))
    if busy <= 0:
        return None
    return 100.0 * bound(ctx) / busy
