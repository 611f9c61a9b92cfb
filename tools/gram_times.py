#!/usr/bin/env python3
"""Time the Gram kernel of one checkout through its wrapper
(`algp_tpu_torch.ops.gram.gram_kernel`) at the paths' shapes, on one
NVIDIA GPU, and print one JSON line.

    python3 tools/gram_times.py [--root DIR]

`--root` names the checkout whose `algp_tpu_torch` is timed (default: this
one).  To compare two versions, unpack the other with `git archive` under
`build/` and run both in turns in one call:

    for r in build/parent . . build/parent; do python3 tools/gram_times.py --root $r; done

Shapes: RBF at 10 240² (ls 8, the main path's seed), Matérn 3/2 at
512 × 2²⁰ (ls 80, the million-point seed), and the composite Matérn 5/2 ×
RBF (ls 4 and 1) at 1 000² with d = 2 + 1, 2 + 3, 2 + 4 (the truths and
plan cross-Grams of the feature paths) and 10 240² with d = 2 + 3, 2 + 4
(greedy c2's seeds); inputs are integer grids beside N(0, 1) features from
a seed.  Each shape: 5 samples, each the mean of 20 launches by CUDA
events, warm, the wrapper's host work included.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` launches, CUDA events, warm."""
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


def grid(rows: int, cols: int) -> np.ndarray:
    r, c = np.divmod(np.arange(rows * cols), cols)
    return np.stack([c, r], 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops.kernels import KernelSpec

    if not Path(G.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {G.__file__}, not the checkout at {root}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    out = {"root": str(root), "card": smi}

    def sample(tag, spec, p, x1, x2):
        out[tag] = [cuda_ms(lambda: G.gram_kernel(spec, p, x1, x2)) for _ in range(5)]

    t0 = time.perf_counter()
    spec = KernelSpec("rbf", ds=2)
    p = spec.init_params(ls_spatial=8.0, outputscale=1.0, device=dev)
    x = torch.tensor(grid(80, 128), dtype=torch.float32, device=dev)
    G.gram_kernel(spec, p, x[:4], x[:4])
    torch.cuda.synchronize()
    out["first_call_s"] = time.perf_counter() - t0  # the build, where there is one
    sample("rbf_10240", spec, p, x, x)
    spec = KernelSpec("matern32", ds=2)
    p = spec.init_params(ls_spatial=80.0, outputscale=1.0, device=dev)
    xg = torch.tensor(grid(1024, 1024), dtype=torch.float32, device=dev)
    sample("matern32_512x2^20", spec, p, xg[::2048][:512].contiguous(), xg)
    del xg
    torch.cuda.empty_cache()
    rng = np.random.default_rng(12)
    for n, (rows, cols), df in ((1000, (25, 40), 1), (1000, (25, 40), 3),
                                (1000, (25, 40), 4), (10240, (80, 128), 3),
                                (10240, (80, 128), 4)):
        spec = KernelSpec("matern52", "rbf", ds=2, df=df)
        p = spec.init_params(ls_spatial=4.0, ls_feature=1.0, outputscale=1.0, device=dev)
        x = torch.tensor(np.concatenate([grid(rows, cols), rng.standard_normal((n, df))], 1),
                         dtype=torch.float32, device=dev)
        sample(f"composite_{n}_d2+{df}", spec, p, x, x)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
