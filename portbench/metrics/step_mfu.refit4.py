"""step_mfu.refit4: step_mfu (the episodes' share of the card's FP32 peak
over the window, their fits included) in c5_4m.refit4."""

from portbench.harness import metric_reader


def read(ctx):
    return metric_reader("step_mfu").read(ctx)
