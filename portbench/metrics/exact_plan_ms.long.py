"""exact_plan_ms.long: the mean over the window's plan records of the
program's `step_s`: the exact planner's step (`acquisition.
plan_episode_step`: the conditioning on every sample at the capacity the
budget sets, the Schur corrections from the seed W, the path sets'
scores) through its one read of the (2, N) mean and variance and their
evaluation; the re-seed queued after a refit lands in it."""


def read(ctx):
    v = [r["step_s"] for a in ctx.answers.values() for r in a.get("records", [])
         if r.get("phase") == "plan" and "step_s" in r]
    return 1e3 * sum(v) / len(v) if v else None
