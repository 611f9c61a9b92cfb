#!/usr/bin/env python3
"""Time and profile the hand-written Cholesky kernel (`algp_tpu_torch.ops.chol`)
against `torch.linalg.cholesky` on one NVIDIA GPU, at the seed sizes of the
two paths (n = 10 240 and 10 000).

    python3 tools/chol_profile.py [--root DIR] [--out FILE]

`--root` names the checkout whose `algp_tpu_torch` is measured (default:
the one holding this script), so that two versions of the kernel can be
measured by one script in one call.  For each n it prints one JSON line:

- times by CUDA events, warm, taken in turns: library, kernel, kernel,
  library (`library_ms`, `ms` are the means of the two turns each);
- one factorization under torch.profiler: device ms and launches by kernel
  name, the device span (first start to last end), the host wall time of
  the call ended by a synchronise, and wall minus device busy (the gaps);
- the factor's residual max|LLᵀ − K| / max|K| in f64, beside the library's.

`chip_smoke.py` phase 10 loads `split` and `turns` from this file.
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


def cuda_ms(fn, reps: int) -> float:
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


def turns(kernel, library, reps: int = 5) -> dict:
    """Kernel and library times taken in turns (library, kernel, kernel,
    library), each turn the mean of `reps` warm launches."""
    lib = [cuda_ms(library, reps)]
    ker = [cuda_ms(kernel, reps), cuda_ms(kernel, reps)]
    lib.append(cuda_ms(library, reps))
    return {"ms": float(np.mean(ker)), "library_ms": float(np.mean(lib)),
            "ms_turns": ker, "library_ms_turns": lib}


def split(fn) -> dict:
    """One warm call of fn() under torch.profiler: device ms and launches
    by kernel name, the device span, the host wall time, and the gaps
    (wall minus the summed device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    first, last = float("inf"), 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name[:60], []).append(e.time_range.elapsed_us())
            first = min(first, e.time_range.start)
            last = max(last, e.time_range.end)
    busy = sum(sum(us) for us in by_name.values()) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_span_ms": (last - first) / 1e3 if by_name else 0.0,
            "gaps_ms": wall - busy,
            "launches": sum(len(us) for us in by_name.values()),
            "by_kernel": {k: {"count": len(us), "ms": round(sum(us) / 1e3, 4),
                              "us_min_median_max": [round(min(us), 1),
                                                    round(float(np.median(us)), 1),
                                                    round(max(us), 1)]}
                          for k, us in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))}}


def residual(L: torch.Tensor, K: torch.Tensor) -> float:
    L64 = L.double()
    return float((L64 @ L64.T - K.double()).abs().max() / K.abs().max())


def seed(n: int, dev) -> torch.Tensor:
    """A seed matrix of the paths' kind: K + σ²I over a 100 × 100 grid
    (n = 10 000: Matérn 3/2 as c5_10k; n = 10 240: RBF over the grid
    padded with far sentinels, as the main path)."""
    from algp_tpu_torch.acquisition import pad_candidates
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops.kernels import KernelSpec

    r, c = np.divmod(np.arange(10000), 100)
    x = torch.tensor(np.stack([c, r], 1), dtype=torch.float32, device=dev)
    if n == 10000:
        spec = KernelSpec("matern32", ds=2)
    else:
        spec = KernelSpec("rbf", ds=2)
        x, _ = pad_candidates(x, torch.ones(10000, device=dev), align=n)
    p = spec.init_params(ls_spatial=8.0, outputscale=1.0, noise=0.1, device=dev)
    return G.gram_kernel_with_noise(spec, p, x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chol_profile: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from algp_tpu_torch.ops import chol as C

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    lines = []
    for n in (10240, 10000):
        K = seed(n, dev)
        out = {"root": str(Path(args.root).resolve()), "n": n, "card": smi}
        out.update(turns(lambda: C.cholesky(K), lambda: torch.linalg.cholesky(K)))
        before = C.LAUNCHES
        out["kernel_split"] = split(lambda: C.cholesky(K))
        out["wrapper_calls_in_split"] = C.LAUNCHES - before
        out["library_split"] = split(lambda: torch.linalg.cholesky(K))
        out["residual"] = residual(C.cholesky(K), K)
        out["residual_library"] = residual(torch.linalg.cholesky(K), K)
        # n³/3 flops at 67 TFLOP/s FP32 (H100 SXM data sheet, 700 W)
        out["bound_ms"] = n ** 3 / 3 / 67e12 * 1e3
        out["tflops"] = n ** 3 / 3 / (out["ms"] * 1e-3) / 1e12
        print(json.dumps(out), flush=True)
        lines.append(json.dumps(out))
        del K
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
