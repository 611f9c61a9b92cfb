"""select_mfu: the whole call's share of the card's FP32 peak, from the
flops that the plain algorithm needs for these inputs (work.greedy_mi_flops:
the exact seed's factor and triangular inverse, its Gram entries, the
pilots' removal from the precision, one precision column a round) over
the measured window."""


def flops_per_call(ctx) -> float:
    c = ctx.config
    return sum(ctx.work.greedy_mi_flops(c["num_rows"] * c["num_cols"], c["num_pilot"],
                                        c["rounds"]).values())


def read(ctx):
    if not ctx.calls:
        return None
    return 100.0 * flops_per_call(ctx) * ctx.calls / ctx.window_s / ctx.work.PEAK_FP32_FLOPS
