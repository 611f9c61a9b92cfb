"""sgpr_fit_ms.long: the mean over the window's SGPR fits of the program's
`fit_s` record: the records whose `fit_kind` is "sgpr" (a refit past
`sparse_threshold` samples, `models/sparse_gp.py` `fit_step_sparse(_warm)`:
its k-center design and its Adam loop on the collapsed bound, through
`episode.Agent.fit_model`).  `fit_s` times the host's enqueue of a
host-bound Adam loop; the device's tail of the fit and the exact re-seed
after it land in the next plan call.  None where no record names its
fit's kind."""


def read(ctx):
    v = [r["fit_s"] for a in ctx.answers.values() for r in a.get("records", [])
         if r.get("fit_kind") == "sgpr"]
    return 1e3 * sum(v) / len(v) if v else None
