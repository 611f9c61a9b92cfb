"""plan_ms.step: the mean over the window's plan steps of the program's
`step_s` record (its plan call through the step's one device-to-host
read, acquisition_lowrank.plan_episode_step_lowrank_factors(_metrics))."""


def read(ctx):
    v = [r["step_s"] for a in ctx.answers.values() for r in a.get("records", []) if "step_s" in r]
    return 1e3 * sum(v) / len(v) if v else None
