"""idle_share.long: idle_share.step (1 − the union of the device
operations' intervals ÷ the traced sub-window, in %) in
c5_long.campaign."""

from portbench.harness import metric_reader


def read(ctx):
    return metric_reader("idle_share.step").read(ctx)
