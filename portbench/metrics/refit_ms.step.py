"""refit_ms.step: the mean over the window's fits of the program's
`fit_s` record: the pilot fit on the pilot record and each refit on the
record of its step (`models/gp.py` `_fit_batched` / `fit_step_warm`,
through `episode.Agent.fit_model`).  `fit_s` times the host's enqueue of
a host-bound Adam loop; the device's tail of the fit and of the re-seed
after it lands in the next `step_s`."""


def read(ctx):
    every = ctx.config["refit_every"]
    v = [r["fit_s"] for a in ctx.answers.values() for r in a.get("records", [])
         if "fit_s" in r and (r.get("phase") == "pilot"
                              or (r.get("phase") == "plan" and r["step"] % every == 0))]
    return 1e3 * sum(v) / len(v) if v else None
