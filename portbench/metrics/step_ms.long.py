"""step_ms.long: step_ms (the window over the plan steps that completed in
it) in c5_long.campaign, where it is per layer: the host's Adam loop
(about 40 fits an episode) paces it."""

from portbench.harness import metric_reader


def read(ctx):
    return metric_reader("step_ms").read(ctx)
