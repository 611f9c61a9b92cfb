#!/usr/bin/env python3
"""Time design variants of the precision-column kernel
(`algp_tpu_torch/csrc/wtw_column.cu`) at the paths' shapes, on one NVIDIA
GPU, and print one JSON line.

    python3 tools/wtw_variants.py          # from the repository root

Each variant is the kernel's source with one or two of its constants
edited (rows a lane has in flight, blocks a cluster, threads a block),
built beside the others with the package's nvcc flags under
`build/wtw_variants/`, and called through its C entry point.  Shapes: the
square call at N = 10 240 (j = 0 and 5000) and every rank's row strip for
S = 2 and 4 (j = 0), W lower-triangular N(0, 1/N) from seed 0.  Each
variant is held within 1e-4 relative of the f64 column, then timed in
turns (variants in order, then reversed) as device time alone: 50 calls
in one CUDA graph (`chip_smoke.graph_ms`).  Prints the ptxas report of
each variant's f32×4 instance first.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from algp_tpu_torch.ops import _cuda  # noqa: E402

OUT = ROOT / "build" / "wtw_variants"
UNROLL, CLUSTER, THREADS = ("constexpr int kUnroll = 8;", "constexpr int kCluster = 8;",
                            "constexpr int kThreads = 256;")
# name → edits of the source; "u8" is the kernel as it is
VARIANTS = {
    "u8": {},
    "u4": {UNROLL: "constexpr int kUnroll = 4;"},
    "u16": {UNROLL: "constexpr int kUnroll = 16;"},
    "cluster4": {CLUSTER: "constexpr int kCluster = 4;"},
    "threads128": {THREADS: "constexpr int kThreads = 128;"},
    "cluster4_threads512": {CLUSTER: "constexpr int kCluster = 4;",
                            THREADS: "constexpr int kThreads = 512;"},
}


def build(name: str, edits: dict):
    src = (_cuda.CSRC / "wtw_column.cu").read_text()
    for old, new in edits.items():
        if old not in src:
            raise ValueError(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    path = OUT / f"{name}.cu"
    path.write_text(src)
    lib = OUT / f"lib{name}.so"
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-shared",
                           "-o", str(lib), str(path)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stdout}{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    # the f32×4 instance's spill line and register report
    at = next(i for i, line in enumerate(log) if "wtw_column_kernelILi4E" in line)
    report = [line.split("ptxas info    : ")[-1].strip() for line in log[at + 1:at + 4]
              if "spill" in line or "Used" in line]
    fn = ctypes.CDLL(str(lib)).algp_wtw_column
    fn.restype = ctypes.c_int
    fn.argtypes = _cuda._SIGNATURES["algp_wtw_column"][1]
    return fn, "; ".join(report)


def main() -> None:
    smi = chip_smoke.phase_device()[1]
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 10240
    W = torch.tril(torch.randn((n, n), generator=gen, device=dev) / n ** 0.5)
    cases = {"square j=0": (W, 0, 0), "square j=5000": (W, 0, 5000)}
    for S in (2, 4):
        nl = n // S
        for r in range(S):
            cases[f"S={S} rank {r}"] = (W[r * nl:(r + 1) * nl].contiguous(), r * nl, 0)
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    times = {}
    for tag, (W_loc, row0, j) in cases.items():
        jt = torch.tensor([j], device=dev)
        out = torch.empty(n, device=dev)
        want = W_loc[:, j].double() @ W_loc.double()
        turns = {}
        for name in order:
            fn = built[name][0]

            def call():
                _cuda.check(fn(W_loc.data_ptr(), jt.data_ptr(), out.data_ptr(), n, row0,
                               W_loc.shape[0], _cuda.stream_ptr(dev)), name)

            call()
            torch.cuda.synchronize()
            rel = float((out.double() - want).abs().max() / want.abs().max())
            if not rel <= 1e-4:
                raise AssertionError(f"variant {name} at {tag}: rel {rel}")
            turns.setdefault(name, []).append(chip_smoke.graph_ms(call))
        times[tag] = {k: float(np.mean(v)) for k, v in turns.items()}
    print(json.dumps({"wtw_variants_device_ms": times,
                      "ptxas": {k: v[1] for k, v in built.items()}, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
