"""select_ms: the window over the calls of `greedy_select` (Krause MI,
known hyperparameters) that completed in it, one closed-loop caller."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.calls if ctx.calls else None
