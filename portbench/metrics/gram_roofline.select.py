"""gram_roofline.select: the Gram kernel's share of its roofline in the
traced sub-window of main10k.select.  Its work a call is what the traffic
needs of it: the seed's N × N block with its noise diagonal and the
pilots' (m, N) cross-Gram, each bounded by max(bytes / 3.35 TB/s,
flops / 67 TFLOP/s) (work.roofline_bound_s) with each input byte read and
each output byte written once; its time is the summed device time of
the operations named in gram_roofline.select.names.  None where the trace
holds none of them."""


def bound_per_call(ctx) -> float:
    c, w = ctx.config, ctx.work
    n, m = c["num_rows"] * c["num_cols"], c["num_pilot"]
    return (w.roofline_bound_s(w.gram_flops(n, n, 2), w.gram_bytes(n, n, 2, noise=True))
            + w.roofline_bound_s(w.gram_flops(m, n, 2), w.gram_bytes(m, n, 2)))


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    names = ctx.names(ctx.metrics_dir / "gram_roofline.select.names")
    busy = t.device_time(lambda op: any(p in op for p in names))
    if busy <= 0:
        return None
    return 100.0 * bound_per_call(ctx) * t.calls / busy
