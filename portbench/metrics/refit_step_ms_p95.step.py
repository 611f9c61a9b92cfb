"""refit_step_ms_p95.step: step_ms_p95.step (the 95th percentile of the
window's step latencies) in c5_4m.refit4, where the refit steps, paced
by the host's Adam loop, make the tail."""

from portbench.harness import metric_reader


def read(ctx):
    return metric_reader("step_ms_p95.step").read(ctx)
