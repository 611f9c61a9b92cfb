#!/usr/bin/env python3
"""Time the exact seed's triangular inverse W = L⁻¹ on one NVIDIA GPU:
the solve against the identity (`tri_inv` up to 1 024) against the blocked
inversion (`ops.linalg._tri_inv_blocked`) at several leaf sizes, on the
factors of the two exact seeds, and print one JSON line a factor.

    python3 tools/tri_inv_times.py [--leaves 256,320,384,512] [--reps 10] [--out FILE]

Factors, built by the program: main10k's (100 × 100 grid, RBF, ls 8, noise
variance 0.01, padded to 10 240 by `acquisition.pad_candidates`) and
c5_long's (the same grid, Matérn 3/2, ls 8, noise variance 0.01 through
`acquisition.seed_matrix`, n = 10 000).  Each variant: device ms, the mean
of `--reps` calls by CUDA events, warm, in turns (solve, blocked leaves,
blocked leaves reversed, solve), the median of its turns; its host enqueue
ms; its device launches (profiler); its largest |W − W64| ÷ max|W64|
against the f64 solve on the card.  The bound is n³/3 flops at the FP32
peak of 67 TFLOP/s (no tensor cores).  `--out` appends the lines to FILE
too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from algp_tpu_torch import acquisition as acq  # noqa: E402
from algp_tpu_torch.ops import linalg as la  # noqa: E402
from algp_tpu_torch.ops.gram import gram_kernel_with_noise  # noqa: E402
from algp_tpu_torch.ops.kernels import KernelSpec  # noqa: E402

PEAK_FLOPS = 67e12


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls, CUDA events, warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_ms(fn) -> float:
    """Host ms to enqueue fn() on an idle device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3


def launches(fn) -> int:
    """Device operations (kernels, memsets, copies) of one fn()."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def factors(dev):
    r, c = np.divmod(np.arange(10000), 100)
    x = torch.tensor(np.stack([c, r], 1), dtype=torch.float32, device=dev)
    nv = torch.full((10000,), 0.01, device=dev)
    rbf = KernelSpec("rbf", ds=2)
    p = rbf.init_params(ls_spatial=8.0, outputscale=1.0, noise=0.1, device=dev)
    xp, nvp = acq.pad_candidates(x, nv, align=512)
    yield "main10k", la.cholesky(gram_kernel_with_noise(rbf, p, xp, nvp / p.noise_var))
    m32 = KernelSpec("matern32", ds=2)
    p = m32.init_params(ls_spatial=8.0, outputscale=1.0, noise=0.1, device=dev)
    yield "c5_long", la.cholesky(acq.seed_matrix(m32, p, x))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leaves", default="256,320,384,512")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    leaves = [int(v) for v in args.leaves.split(",")]
    for name, L in factors(dev):
        n = L.shape[-1]
        eye = torch.eye(n, dtype=torch.float32, device=dev)
        variants = {"solve": lambda: torch.linalg.solve_triangular(L.mT, eye, upper=True).mT}
        for leaf in leaves:
            variants[f"leaf{leaf}"] = lambda leaf=leaf: la._tri_inv_blocked(L, leaf)
        want = torch.linalg.solve_triangular(
            L.double().mT, eye.double(), upper=True).mT
        scale = want.abs().max().item()
        order = list(variants)
        turns = {k: [] for k in order}
        for seq in (order, order[::-1]):
            for k in seq:
                turns[k].append(cuda_ms(variants[k], args.reps))
        row = {"factor": name, "n": n, "card": card,
               "bound_ms": n ** 3 / 3 / PEAK_FLOPS * 1e3, "variants": {}}
        for k in order:
            W = variants[k]()
            ms = statistics.median(turns[k])
            row["variants"][k] = {
                "device_ms": round(ms, 4),
                "turns_ms": [round(t, 4) for t in turns[k]],
                "roofline_pct": round(100 * row["bound_ms"] / ms, 2),
                "enqueue_ms": round(enqueue_ms(variants[k]), 3),
                "launches": launches(variants[k]),
                "err": (W.double() - want).abs().max().item() / scale,
                "contiguous": W.is_contiguous(),
            }
            del W
        line = json.dumps(row)
        print(line, flush=True)
        if args.out is not None:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del want, L


if __name__ == "__main__":
    main()
