"""sgpr_mfu.long: the SGPR fits' share of the card's FP32 peak: the flops
the plain collapsed bound needs (`fit_flops`) over the summed `fit_s` of
the records whose `fit_kind` is "sgpr", ÷ 67 TFLOP/s.  A fit on n samples
over M inducing points costs, for each restart and Adam step, the (M, n)
Gram, L_zz (M³/3), A = L_zz⁻¹ K_zx (M²n), B = I + A Aᵀ (M²n), L_B (M³/3)
and the solves for c (2Mn), three times over for the backward pass, and
one forward pass a restart for the final iterate.  Left out, each under
1 % at c5_long's sizes: K_zz's Gram (M²), the diagonal terms (O(n)).
A warm refit runs `refit_restarts` × `refit_iters`, a first fit
`fit_restarts` × `fit_iters`.  None where no record names its fit's
kind."""


def fit_flops(w, n: int, M: int, restarts: int, iters: int) -> float:
    forward = (w.gram_flops(M, n, 2) + 2.0 * w.cholesky_flops(M) + 2.0 * M * M * n
               + 2.0 * M * n)
    return restarts * (3 * iters + 1) * forward


def read(ctx):
    c, w = ctx.config, ctx.work
    flops = secs = 0.0
    for a in ctx.answers.values():
        for r in a.get("records", []):
            if r.get("fit_kind") != "sgpr":
                continue
            first = r.get("phase") in ("pilot", "resume")
            R = c["fit_restarts"] if first else (c["refit_restarts"] or c["fit_restarts"])
            T = c["fit_iters"] if first else (c["refit_iters"] or c["fit_iters"])
            flops += fit_flops(w, r["n_sampled"], c["sparse_inducing"], R, T)
            secs += r["fit_s"]
    return 100.0 * flops / secs / w.PEAK_FP32_FLOPS if secs > 0 else None
