"""idle_share.select: 1 − (union of the device operations' intervals
÷ the traced sub-window), in %; overlapping operations count once."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
