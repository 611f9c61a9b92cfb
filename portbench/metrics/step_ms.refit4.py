"""step_ms.refit4: step_ms (the window over the plan steps that completed
in it) in c5_4m.refit4, where it is per layer: the host's Adam loop and
evaluation tail pace it, and on a shared host its runs spread wider than
the largest bound an end-to-end metric may take."""

from portbench.harness import metric_reader


def read(ctx):
    return metric_reader("step_ms").read(ctx)
