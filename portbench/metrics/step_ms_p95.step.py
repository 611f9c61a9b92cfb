"""step_ms_p95.step: the 95th percentile over every plan step of the
window of its latency: from the previous plan record, or the start of its
episode, to its own record (an episode's tail after its last record
counts to its last step, so an episode's latencies add up to its wall
time).  Per layer, not end to end: the host paces this tail (the last
step carries the final posterior's host work over 4.2M cells, and with
refits a refit step carries the host's Adam loop)."""


def read(ctx):
    lat = [t for a in ctx.answers.values() for t in a.get("latencies", [])]
    return 1e3 * ctx.quantile(lat, 0.95) if lat else None
