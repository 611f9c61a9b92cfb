"""step_ms: the window over the plan steps of `episode.Agent.run` that
completed in it (each episode's resume plan and every `plan` record),
episodes one after another."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.calls if ctx.calls else None
