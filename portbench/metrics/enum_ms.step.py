"""enum_ms.step: the mean over the window's plan steps of the program's
`enum_s` record (the host's path enumeration, planning.enumerate_batch
into native/pathenum.c)."""


def read(ctx):
    v = [r["enum_s"] for a in ctx.answers.values() for r in a.get("records", []) if "enum_s" in r]
    return 1e3 * sum(v) / len(v) if v else None
