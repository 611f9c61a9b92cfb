"""plan_wait_ms: the robot's wait for its next path at a waypoint, once it
has sensed and any refit has run: the benchmark's host clock around each
plan call of `episode.Agent.run` (`Agent._plan_and_metrics`: the host's
path enumeration, the plan step at every candidate on the card, the low-
rank seed or re-seed that the call waits for, and its one read; a
terminal call, with no path left, fetches the final posterior and the
host's RMSE over every cell instead), summed over every plan call of the
window's episodes and divided by their count."""


def read(ctx):
    w = [p["wall"] for a in ctx.answers.values() for p in a.get("plans", [])]
    return 1e3 * sum(w) / len(w) if w else None
