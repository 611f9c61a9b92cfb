#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (algp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one output line each, in order; any failure raises, so the
script exits non-zero and never prints the final line:

  1. device   — CUDA present; torch, CUDA, nvcc versions; card name and
                power limit (nvidia-smi)
  2. build    — nvcc builds csrc/*.cu from the checkout (seconds, ptxas
                by source), and beside them the Gram kernel's earlier
                designs (tools/gram_variants.cu); the SASS instructions and
                global loads per output of the Gram kernel's hot loops
                (cuobjdump); fails if a composite instance the paths run
                loads from global memory in its hot loop
  3. gram     — the Gram kernel vs its plain PyTorch version on the card:
                bitwise for RBF and Matérn 3/2, within 2e-6·s² for Matérn
                5/2 and the composites (at the template's edges: df = 1, 3,
                4, 5, 8 and the runtime 9, ds = 1, 3 and the runtime 4), at
                ragged shapes (n2 % 4 = 1, 2, 3 too);
                then bitwise and timed in turns against the plain version
                and the shared-tile design at the paths' shapes: RBF at the main
                path's 10 240², Matérn 3/2 at the low-rank seed's
                1 024 × 102 400, the million-point seeds' 512 × 1 048 576
                and 512 × 4 194 304 (2³¹ outputs), and the conditioning
                pass's 352 × 1 048 576, 640 × 1 048 576 and 224 × 4 194 304;
                and the composite template (Matérn 5/2 × RBF) within
                2e-6·s² and timed in turns against the earlier composite
                design and the plain version at the feature paths' shapes:
                1 000² at d = 2 + 3 (c2, c10), 1 000² at d = 2 + 1 (the
                warped truth), 10 240² at d = 2 + 3 (phase 12d's seed), and
                the deep kernel's embedded width d = 2 + 4 at 1 000² (14c's
                plan cross-Gram) and 10 240² (14d's seed)
  4. wtw      — the precision-column kernel vs W[:, j] @ W at N = 10 240
                and a ragged N; bitwise repeatability; every rank's row
                strip at N = 10 240 for S = 2 and 4 vs W_loc[:, j] @ W_loc
                within 1e-4·max|u|; one kernel launch a call (profiler)
                and no allocation over 100 calls with `out`; for the
                square call (j = 0, 5000) and every strip (j = 0): the
                wrapper's time back to back, the device time of the kernel
                alone (one CUDA graph of 50 calls), the same two for the
                plain version and for W_loc[:, j] @ W_loc, the bytes bound,
                and the device time of an empty kernel on the same launch
                shape (the floor)
  5. fidelity — 50-round greedy entropy / MI selections on the card equal
                the f64 oracle (tests/oracle.py) index for index
  6. main     — bench.py's workload through the port: a 100×100 field,
                32 pilots, a 4 × 100 Adam fit and 50 Krause-MI rounds via
                fit_and_select; launch counts, checks, median / min ms
  7. layers   — the main path's layers timed one by one
  8. profile  — one episode under torch.profiler: device busy share and
                the kernels by device time
  9. episode  — the config-5 episode `c5_10k` (100×100 field, exact MI
                planner) through `algp_tpu_torch.cli.main` in this process,
                once to warm up and once timed: steps, samples, budget,
                RMSE and held-out RMSE at the pilot and at the end,
                calibration, plan / refit-step ms, launches (every plan
                call launches the Gram kernel), peak memory, device→host
                syncs per planning step
  9b. lowrank_main — greedy low-rank MI at N = 102 400
                (`fit_and_select_lowrank`, benchmarks/lowrank_bench.py's
                workload, M = 1 024): unique selections, no pilot picked
                again, median / min of 5 runs, layer times (fit, k-center,
                seed, 50 rounds), peak memory, launches, and 30 selections
                equal to the f64 low-rank oracle on a 30 × 30 grid
  9c. episode_100k — `c5_100k` (320×320 FITC field, low-rank planner,
                device metrics) through the CLI, warm-up + timed, the
                checks of phase 9; plan, seed and refit-step ms; at step 2
                the small-factor step picks the full-seed step's path
  9d. episode_long — `c5_long` (~160 steps on the 10k grid) through the
                CLI once: the checks of phase 9, and at least one refit by
                the SGPR bound; its final nlpd_test and cov90_test beside
                the smallest held-out variance (measured and checked against
                a plain reference by the benchmark cell `c5_long.campaign`)
  9e. lowrank_1m — phase 9b at N = 1 048 576, M = 512 (lowrank_bench.py
                --n-grid 1024 --inducing 512): the seeds' solves are
                explicit-inverse products; the 30 × 30 oracle check runs
                with the gate forced to 1
  9f-9i. episode_1m, episode_4m, episode_4m_ens, episode_1m_long — the
                presets `c5_1m`, `c5_4m`, `c5_4m --mi-ensemble 4` and
                `c5_1m_long` through the CLI once each, with phase 9's
                checks; the FITC truth's time and Gram chunks, the seeds'
                chunks, the k-center chains' sizes and times, the seed's
                time; at c5_1m's step 1 the plan step with its (cap, N)
                cross-Gram on the Gram kernel and on the plain `gram` (the
                same C bit for bit, the same path; the pass's ms and peak
                on each route); c5_4m stops at its hard cap of 224 samples and
                streams its truth and seed (at step 1 the streamed and the
                monolithic seed pick the same path; their largest LB
                difference is printed), c5_1m_long refits by SGPR and
                keeps its capacity of 640
 12d, 14d run first of the feature phases (their f64 oracles, ≈ 150 s of
                host numpy each, run in two worker processes while the
                card goes on) and print their lines after phase 10:
 12a-12c. episode_c2, episode_c2_lbfgs, episode_c2_warp — the preset
                `c2_composite_restarts` (25 × 40 field with 3 features,
                Matérn 5/2 × RBF, 4 restarts) through the CLI once each: Adam,
                `--optimizer lbfgs --iters 40`, `--feature-warp tanh`; phase
                9's checks, the fits' seconds
 12d. greedy_c2 — `c2_composite_restarts --rows 100 --cols 100 --mode greedy
                --acq-rounds 50` through `cli.run_greedy`: the composite Gram at
                10 000², the exact MI seed, 50 rounds on the wtw kernel; the
                50 selections equal the f64 oracle's (tests/oracle.py) on the
                fitted params
 13a-13c. episode_table, episode_table_traits, episode_traits_10k — `c10_table`,
                `c10_table --value-cols height,width,stand_count` and `c5_10k
                --num-traits 3 --trait-corr 0.5 --trait-obs-frac 0.5` through
                the CLI once each, with phase 9's checks; for the trait runs
                every trait's RMSE finite, trait 0's scored as the headline
                RMSE is scored, and the end-of-episode trait fits' seconds
 14a-14b. episode_traits_icm, episode_table_icm — `c5_10k --num-traits 3
                --trait-corr 0.8 --trait-obs-frac 0.25 --multi-fit icm` and
                `c10_table --value-cols height,width,stand_count --multi-fit
                icm` through the CLI once each, with phase 9's checks; the
                end-of-episode ICM fit's seconds, and beside its per-trait
                held-out RMSE the independent family's on the same final
                state (planning does not depend on the family)
 14c. episode_c2_deep — `c2_composite_restarts --feature-warp tanh
                --deep-hidden 16 --deep-out 4` through the CLI once, with
                phase 9's checks; the deep refits' seconds against 12c's
 14d. greedy_c2_deep — phase 12d's command with `--deep-hidden 16 --deep-out
                4`: the composite Gram at 10 000² over the embedded d = 2 + 4,
                50 rounds on the wtw kernel; the 50 selections equal the f64
                oracle's on the embedded candidates and the fitted params
 10. chol     — the Cholesky kernel vs its plain version (cuSOLVER) and an
                f64 factor at n = 997 (ragged), the episode's 10 000 seed
                and the main path's 10 240 seed: residuals, errors, NaN on
                a non-SPD input, the W = L⁻¹ columns the seed serves; the
                seed comparison (the main path's 50 MI selections seeded by the
                kernel, by cuSOLVER and by an f64 factor, and where they
                part, the tied scores); kernel and library times in turns,
                the torch.profiler split of one factorization by kernel,
                launches per factorization, TFLOP/s and share of the bound
 15. the mesh paths (algp_tpu_torch.parallel), every rank on card 0 through
                `parallel.launch`; the times are of ranks sharing one card
                (gloo stages through host memory), never a multi-card figure:
 15a. mesh_dryrun — `dryrun_multichip` on a world of 1 (NCCL: no
                device→host sync in the greedy loops, one read a plan call
                in the mesh episodes) and of 4 (gloo), its episode blocks
                included (4 mesh episodes, each equal to the single rank's)
 15b. mesh_main — the main path's workload through `sharded_training_step`
                on 2 × 2 (MI and entropy) from the restart inits of a
                single-rank `fit_and_select`: winning NLL within 1e-4
                relative; selections equal the single-rank `greedy_select`
                on the mesh's fitted params, MI equal the f64 oracle's,
                each pair equal or parting first where the reference's
                scores tie within 1e-5 relative; median ms of 3 after the
                counted run, per-rank peak memory, launches per rank
 15c. mesh_dist_seed — MI with the distributed seed on 1 × 4, same field:
                against the oracle, where it parts from the replicated seed,
                each rank's (N/4, N) W strip
 15f. mesh_oracle_follow — the f64 oracle replays 15b's MI and 15c's
                selections (tests/oracle.follow_selection): at each of the
                50 rounds the mesh's pick scores within 1e-5 relative of
                the round's best, so the rounds after a tie-rule parting
                are checked too
 15d. mesh_lowrank — phase 9b's workload on 1 × 4 against the single-rank
                `greedy_select_lowrank`; each rank's (N/4, M) VT strip
 15e. mesh_icm — `sharded_fit_icm` (234 plots, 3 traits, 4 restarts) on
                2 × 1 from a single-rank `fit_icm`'s inits: every NLL within
                1e-4 relative
 15g. mesh_episode_exact — the `c5_10k` preset through `episode.Agent(mesh=)`
                on 2 × 2 for MESH_EPISODE_STEPS steps (two refits): the exact
                seed by the distributed strip factorization, W (5 120,
                10 240) a rank; the sites equal the single-rank Agent's on
                the same env, index for index; the ranks' fitted parameters
                equal after every fit; plan ms, refit-step ms, per-rank peak
                and strip, launches (the Gram kernel on every rank)
 15h. mesh_episode_lowrank — `c5_100k` (320², M = 1 024, FITC truth) on 1 × 4
                for the same steps: VT (25 600, 1 024) a rank, the same checks
 16. the tools slice, after phase 15:
 16a. tools_profile — `c5_10k --budget 60` through the CLI untraced and with
                `--profile-dir`: the summaries equal, the trace parses, its
                CUDA kernel events (CUPTI) include the hand Gram kernel by
                name (launched through the ctypes library); the trace's
                size, kernel events and hand kernels found
 16b. tools_plots — the same run with `--plots`: where matplotlib imports,
                `maps_run0.png` and `curves.png` not empty; in a process
                that cannot import it, the CLI exits non-zero with the
                plotting error (`"matplotlib"` says which the card has)
 16c. tools_debug — `utils.debug.checked` names a CUDA op that made a NaN
                and passes the Gram kernel's K + σ²I at 10 240;
                `assert_finite_tree` on the main path's seed;
                `fit_health_report` on phase 6's fit
 16d. quickstart — examples/quickstart_torch.py as a subprocess: every
                milestone, exact resume, section 9's world of 2 ranks
 16e. tools_reference_api — `complement_precision` at 10 240 against its
                plain version and WᵀW of the seed; `plan_path_step` against
                `plan_episode_step` at the cut c5_10k's step 2
 17. quality  — the final posterior and calibration on the card against
                the same run on the CPU, from the same draws made on the
                host (the field and sensing noise from the phase's seed,
                every fit's inits from the port's CPU generators; the deep
                fits are chaotic in f32, so the CPU run replays the card's):
 17a. quality_deep_c2 — 14c's command (`c2_composite_restarts
                --feature-warp tanh --deep-hidden 16 --deep-out 4`) at its
                full length
 17b. quality_long_sgpr — c5_long at full width (10 000 candidates, M =
                256), 264 pilots over an SGPR threshold of 256 (the pilot
                fit is the SGPR bound; no threshold below M is accepted),
                3 steps
                For each device: nlpd_test, cov90_test, cov95_test, the
                smallest held-out variance and the held-out cells below
                1e-6; fails if a card coverage is more than one cell's
                share from the CPU's or the card's nlpd_test more than
                twice the CPU's
 11. kernels  — one JSON line for all kernels: launches on the paths, error
                against the plain version, kernel / plain / library ms and
                the card's bound
Each path (main, episode, lowrank_main, episode_100k, episode_long,
lowrank_1m, episode_1m, episode_4m, episode_4m_ens, episode_1m_long, the
phases 12a-14d, the Cholesky seed path, the mesh paths 15b-15h in every
rank, the tools paths 16a-16e, 16d in its own process, the card runs of
17a-17b) runs with the kernel counts set to 0 just before it and read
just after; phase 15 runs after phase 10 (15f after 15e), then phases 16
and 17, before the kernels line.  The line before the kernels line gives the
script's total seconds.
Last line: {"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"  # the episode runs' metrics and states
REPS = 5
GRID = 100  # the main path's field is GRID × GRID (bench.py: 100 × 100)
EPISODE_ARGS = ["--preset", "c5_10k"]  # the episode phase's command line
# greedy low-rank MI (benchmarks/lowrank_bench.py): a jittered
# LOWRANK_GRID² grid, LOWRANK_M inducing points, 64 pilots, 50 rounds
LOWRANK_GRID, LOWRANK_M = 320, 1024
EPISODE_100K_ARGS = ["--preset", "c5_100k"]
EPISODE_LONG_ARGS = ["--preset", "c5_long"]
# the million-point regime: greedy low-rank MI over a jittered 1024² grid
# with 512 inducing points, and the episodes of the largest presets
LOWRANK_1M_GRID, LOWRANK_1M_M = 1024, 512
# the Gram kernel against n1 points of a side² integer grid at the preset's
# lengthscale: the seeds' 512 (c5_1m; c5_4m, 2³¹ outputs) and the
# conditioning pass's cap (c5_1m 352, c5_1m_long 640; c5_4m 224)
GRAM_SCALE_CASES = ((1024, 80.0, (512, 352, 640)), (2048, 160.0, (512, 224)))
EPISODE_1M_ARGS = ["--preset", "c5_1m"]
EPISODE_4M_ARGS = ["--preset", "c5_4m"]
EPISODE_4M_ENS_ARGS = ["--preset", "c5_4m", "--mi-ensemble", "4"]
EPISODE_1M_LONG_ARGS = ["--preset", "c5_1m_long"]
# the feature and trait paths (phases 12a-13c): (tag, command line)
C2_ARGS = ["--preset", "c2_composite_restarts"]
FIELD_EPISODES = (
    ("episode_c2", C2_ARGS),
    # depth cut, 150 → 40 L-BFGS steps a refit: past convergence every
    # restart batch's line search runs its 20 trips, one loss evaluation
    # each, and the preset's 150 steps take ≈ 16 s a refit on the card
    ("episode_c2_lbfgs", C2_ARGS + ["--optimizer", "lbfgs", "--iters", "40"]),
    ("episode_c2_warp", C2_ARGS + ["--feature-warp", "tanh"]),
)
GREEDY_C2_ARGS = C2_ARGS + ["--rows", "100", "--cols", "100", "--mode", "greedy",
                            "--acq-rounds", "50"]
TRAIT_EPISODES = (
    ("episode_table", ["--preset", "c10_table"]),
    ("episode_table_traits", ["--preset", "c10_table", "--value-cols",
                              "height,width,stand_count"]),
    ("episode_traits_10k", ["--preset", "c5_10k", "--num-traits", "3",
                            "--trait-corr", "0.5", "--trait-obs-frac", "0.5"]),
)
# the model families (phases 14a-14d): the ICM at the end of a trait
# episode, the deep kernel in an episode and in greedy selection
DEEP_ARGS = ["--deep-hidden", "16", "--deep-out", "4"]
ICM_EPISODES = (
    ("episode_traits_icm", ["--preset", "c5_10k", "--num-traits", "3", "--trait-corr",
                            "0.8", "--trait-obs-frac", "0.25", "--multi-fit", "icm"]),
    ("episode_table_icm", ["--preset", "c10_table", "--value-cols",
                           "height,width,stand_count", "--multi-fit", "icm"]),
)
DEEP_EPISODE = ("episode_c2_deep", C2_ARGS + ["--feature-warp", "tanh"] + DEEP_ARGS)
GREEDY_C2_DEEP_ARGS = GREEDY_C2_ARGS + DEEP_ARGS
# the composite Gram (Matérn 5/2 × RBF) at the feature paths' shapes:
# (side of the square, rows × cols of the grid, feature width); width 4 is
# the deep kernel's embedding
COMPOSITE_GRAM_CASES = ((1000, (25, 40), 3), (1000, (25, 40), 1), (10240, (100, 100), 3),
                        (1000, (25, 40), 4), (10240, (100, 100), 4))
# the composite's (ds, df) at its template edges, checked at ragged shapes:
# the exact feature widths 1-4, the 8-wide bucket (5, 8), the spatial
# widths 1 and 3, and the runtime widths (df = 9, ds = 4)
COMPOSITE_EDGES = ((2, 1), (2, 3), (2, 4), (2, 5), (2, 8), (1, 2), (3, 8), (2, 9), (4, 3))
# the card's published peaks (H100 SXM data sheet, at 700 W): HBM bytes/s
# and FP32 flop/s outside the tensor cores
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time the card could take (ms) and what bounds it."""
    tb, tf = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def wall_ms(fn) -> float:
    """Host time of fn() ended by a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    from algp_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [_cuda._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    print(smi, flush=True)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc, python=sys.version.split()[0],
         name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         device_count=torch.cuda.device_count())
    return torch.cuda.get_device_name(0), smi


def phase_build():
    """Build the kernels, and beside them (in parallel) the Gram kernel's
    shared-tile design from tools/gram_variants.cu, which phase 3 times against
    the kernel; print the ptxas report and the SASS instructions per
    output of the Gram kernel's hot loop.  Returns (gram tool, the
    variants' library)."""
    from concurrent.futures import ThreadPoolExecutor

    from algp_tpu_torch.ops import _cuda

    tool = load_module("gram_profile", ROOT / "tools" / "gram_profile.py")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        variants = pool.submit(tool.build)
        _cuda.library()
        secs = time.perf_counter() - t0
        variants = variants.result()
    emit("build", seconds=round(secs, 3), variants_seconds=round(time.perf_counter() - t0, 3),
         **ptxas_summary(_cuda.build_log(), {**tool.KERNEL_PATTERNS,
                                             **tool.COMPOSITE_PATTERNS}))
    # instructions of the innermost storing loop over the outputs one trip
    # writes, and its global loads; the shared-tile design's stores are
    # straight-line code (None); the earlier composite's hot loop holds its
    # two runtime coordinate loops, each counted once
    sass = tool.sass_per_output(_cuda.build(), {**tool.KERNEL_PATTERNS,
                                                **tool.COMPOSITE_PATTERNS})
    sass.update(tool.sass_per_output(variants, {
        "shared_tile_matern32": "shared_tile_kernelILi1E", "shared_tile_rbf": "shared_tile_kernelILi0E",
        **tool.OLD_COMPOSITE_PATTERN}))
    for tag in tool.COMPOSITE_PATTERNS:
        if not sass[tag] or sass[tag].get("global_loads", 1):
            raise AssertionError(f"composite hot loop {tag}: not found or loads from global "
                                 f"memory: {sass[tag]}")
    emit("gram_sass", per_output={k: v and v.get("per_output") for k, v in sass.items()},
         global_loads_per_output={k: v and v.get("global_loads_per_output")
                                  for k, v in sass.items()}, loops=sass)
    return tool, tool.load(variants)


def ptxas_summary(log: str, patterns: dict) -> dict:
    """The ptxas report by source: kernels compiled, registers (least and
    most), spilled bytes, and the report of each kernel instance named in
    `patterns` (tag → a piece of its mangled name)."""
    out, cur, reports, name = {}, None, {}, None
    for line in log.splitlines():
        if line.startswith("$ ") and " -c " in line:
            cur = out.setdefault(Path(line.split()[-1]).name,
                                 {"kernels": 0, "registers": [], "spill_bytes": 0})
        elif cur is None:
            continue
        elif "Compiling entry function" in line:
            cur["kernels"] += 1
            name = line.split("'")[1]
        elif "Used" in line and "registers" in line:
            cur["registers"].append(int(line.split("Used ")[1].split()[0]))
            reports[name] = line.split("ptxas info    : ")[-1].strip()
        else:
            cur["spill_bytes"] += sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
    for v in out.values():
        regs = v.pop("registers")
        v["registers"] = [min(regs), max(regs)] if regs else None
    return {"ptxas": out, "instances": {
        tag: next((r for k, r in reports.items() if p in k), None)
        for tag, p in patterns.items()}}


def main_grid(dev):
    """The main path's candidate set: the 100×100 grid, 512-aligned."""
    from algp_tpu_torch.acquisition import pad_candidates

    r, c = np.divmod(np.arange(GRID * GRID), GRID)
    x = torch.tensor(np.stack([c, r], 1), dtype=torch.float32, device=dev)
    x_pad, _ = pad_candidates(x, torch.ones(GRID * GRID, device=dev))
    return x_pad


def phase_gram(dev, tool, variants) -> dict:
    """The Gram kernel against its plain version: bitwise for RBF and
    Matérn 3/2 (the kernel repeats the plain arithmetic in its order),
    within 2e-6·s² for Matérn 5/2 and the composite (whose ÷3 and
    per-segment sums may round apart), at ragged shapes (n2 % 4 = 1, 2, 3:
    the 4-byte-store path) and at the paths' shapes; times in turns
    (kernel, shared-tile design, plain, plain, shared-tile design, kernel) at the paths'
    shapes: the main seed's 10 240² (RBF), the low-rank seed's
    1 024 × 102 400 and the million-point seeds' 512 × 2²⁰ and 512 × 2²²,
    and the conditioning pass's (cap, N) of c5_1m, c5_1m_long and c5_4m
    (Matérn 3/2)."""
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops.kernels import KernelSpec

    rng = np.random.default_rng(0)
    bitwise = ("rbf", "matern32")
    results, worst = [], 0.0

    def check(spec, x1, x2, params=None):
        """Kernel against plain at `params` (default: the phase's `p`)."""
        nonlocal worst
        q = p if params is None else params
        K = G.gram_kernel(spec, q, x1, x2)
        P = G.gram_reference(spec, q, x1, x2)
        err = float((K - P).abs().max())
        exact = spec.spatial_kind in bitwise and not spec.df
        if not (torch.equal(K, P) if exact else err <= 2e-6 * float(q.outputscale)):
            raise AssertionError(f"gram kernel vs plain at {tuple(K.shape)} ({spec}): "
                                 f"{err}{' (not bitwise)' if exact else ''}")
        worst = max(worst, err)
        return {"spec": f"{spec.spatial_kind}x{spec.feature_kind if spec.df else '-'}"
                        f"_d{spec.ds}+{spec.df}",
                "shape": list(K.shape), "max_abs_err": err,
                "tol": "bitwise" if exact else "2e-6*s2"}

    for spec in (KernelSpec("rbf", ds=2), KernelSpec("matern32", ds=2),
                 KernelSpec("matern52", ds=2), KernelSpec("rbf", "matern32", ds=1, df=4),
                 *(KernelSpec("matern52", "rbf", ds=ds, df=df) for ds, df in COMPOSITE_EDGES)):
        p = spec.init_params(ls_spatial=2.5, ls_feature=1.3, outputscale=1.7, device=dev)

        def rand(n):
            xs = rng.uniform(0, 20, (n, spec.ds))
            xf = rng.standard_normal((n, spec.df))
            return torch.tensor(np.concatenate([xs, xf], 1), dtype=torch.float32,
                                device=dev)

        for n1, n2 in ((997, 1283), (63, 33), (513, 4000), (7, 4001), (64, 4002),
                       (1, 4003)):
            results.append(check(spec, rand(n1), rand(n2)))

    def timed(spec, x1, x2, reps):
        """Kernel (bitwise against plain), then times in turns: the plain
        version `reps` launches a turn, the kernel and the shared-tile design 20
        (so the first call's host latency does not count)."""
        case = check(spec, x1, x2)
        n1, n2 = x1.shape[0], x2.shape[0]
        runs = {"ms": lambda: G.gram_kernel(spec, p, x1, x2),
                "shared_tile_ms": lambda: tool.shared_tile(variants, spec, p, x1, x2),
                "plain_ms": lambda: G.gram_reference(spec, p, x1, x2)}
        order = list(runs)
        turns = {k: [] for k in runs}
        for k in order + order[::-1]:
            turns[k].append(cuda_ms(runs[k], reps if k == "plain_ms" else 20))
        case.update({k: float(np.mean(v)) for k, v in turns.items()})
        # each output written once, inputs read once; per entry ds
        # subtracts, multiplies and adds, then the form (RBF: a multiply and
        # the exp; Matérn 3/2: the clamp, square root, two multiplies, an
        # add and the exp) and the scale
        case["bound_ms"], case["bound_by"] = bound(
            4 * (n1 * n2 + spec.ds * (n1 + n2)),
            n1 * n2 * (3 * spec.ds + (3 if spec.spatial_kind == "rbf" else 7)))
        case["share_of_bound"] = case["bound_ms"] / case["ms"]
        results.append(case)
        return case

    at = {}
    spec = KernelSpec("rbf", ds=2)
    p = spec.init_params(ls_spatial=8.0, outputscale=1.0, device=dev)
    x = main_grid(dev)
    main = timed(spec, x, x, 5)
    # the low-rank seed's K_zx: 1 024 inducing points against the 320 × 320
    # grid, Matérn 3/2 (the c5_100k truth's is 2 048 × 102 400)
    spec = KernelSpec("matern32", ds=2)
    p = spec.init_params(ls_spatial=25.0, outputscale=1.0, device=dev)
    xg = torch.tensor(lowrank_workload(LOWRANK_GRID)[0], device=dev)
    z = xg[:: xg.shape[0] // LOWRANK_M][:LOWRANK_M].contiguous()
    at[f"at_{z.shape[0]}x{xg.shape[0]}"] = timed(spec, z, xg, 5)
    del xg, z
    # side² integer grids at the preset's lengthscale: the seeds' 512
    # points, then the conditioning pass's cap points (c5_1m, c5_1m_long,
    # c5_4m), evenly strided
    for side, ls, caps in GRAM_SCALE_CASES:
        p = spec.init_params(ls_spatial=ls, outputscale=1.0, device=dev)
        r, c = np.divmod(np.arange(side * side), side)
        xg = torch.tensor(np.stack([c, r], 1), dtype=torch.float32, device=dev)
        for n1 in caps:
            z = xg[:: xg.shape[0] // n1][:n1].contiguous()
            at[f"at_{n1}x{xg.shape[0]}"] = timed(spec, z, xg, 3)
            del z
            torch.cuda.empty_cache()
        del xg
    torch.cuda.empty_cache()
    composite = composite_gram_cases(dev, check, results, tool, variants)
    emit("gram", cases=results, tol="bitwise for rbf and matern32; 2e-6*s2 otherwise",
         **{k: main[k] for k in ("ms", "shared_tile_ms", "plain_ms", "bound_ms")})
    keys = ("ms", "shared_tile_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    return {"max_abs_err": worst, "ms": main["ms"], "shared_tile_ms": main["shared_tile_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            **{k: {q: v[q] for q in keys} for k, v in at.items()}, **composite}


def composite_gram_cases(dev, check, results, tool, variants) -> dict:
    """The composite template (Matérn 5/2 × RBF) at the feature paths'
    shapes: [grid | N(0, 1) features] against itself (the truth's Gram),
    the 10 240 case the 100 × 100 grid padded as `pad_candidates` pads it
    (the MI seed's).  Held within 2e-6·s² of the plain version by `check`,
    then the kernel, the earlier composite design (wrapped as its wrapper
    was: tools/gram_variants.cu) and plain timed in turns (kernel, earlier,
    plain, plain, earlier, kernel)."""
    from algp_tpu_torch.acquisition import pad_candidates
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops.kernels import KernelSpec

    rng = np.random.default_rng(12)
    out = {}
    for n, (rows, cols), df in COMPOSITE_GRAM_CASES:
        spec = KernelSpec("matern52", "rbf", ds=2, df=df)
        p = spec.init_params(ls_spatial=4.0, ls_feature=1.0, outputscale=1.0, device=dev)
        r, c = np.divmod(np.arange(rows * cols), cols)
        x = np.concatenate([np.stack([c, r], 1), rng.standard_normal((rows * cols, df))], 1)
        x = torch.tensor(x, dtype=torch.float32, device=dev)
        if n != rows * cols:
            x, _ = pad_candidates(x, torch.ones(rows * cols, device=dev))
        if x.shape[0] != n:
            raise AssertionError(f"composite case: {x.shape[0]} points, not {n}")
        case = check(spec, x, x, p)
        case["old_design_bitwise_equal"] = bool(torch.equal(
            G.gram_kernel(spec, p, x, x), tool.old_composite(variants, spec, p, x, x)))
        runs = {"ms": lambda: G.gram_kernel(spec, p, x, x),
                "old_design_ms": lambda: tool.old_composite(variants, spec, p, x, x),
                "plain_ms": lambda: G.gram_reference(spec, p, x, x)}
        turns = {k: [] for k in runs}
        order = list(runs)
        for k in order + order[::-1]:
            turns[k].append(cuda_ms(runs[k], 3 if k == "plain_ms" else 20))
        case.update({k: float(np.mean(v)) for k, v in turns.items()})
        # each output written once, inputs read once; per output 3 operations
        # a coordinate (difference, square, sum), the Matérn 5/2 form (clamp,
        # square root, √5·r, a², ÷3, two adds, the exp, the product: 9), the
        # RBF form (a multiply and the exp), the product of the two and the
        # scale
        case["bound_ms"], case["bound_by"] = bound(
            4 * (n * n + 2 * spec.dim * n), n * n * (3 * spec.dim + 9 + 2 + 2))
        case["share_of_bound"] = case["bound_ms"] / case["ms"]
        results.append(case)
        out[f"composite_{n}x{n}_d{spec.dim}"] = {
            q: case[q] for q in ("ms", "old_design_ms", "plain_ms", "bound_ms", "bound_by",
                                 "max_abs_err")}
        del x
        torch.cuda.empty_cache()
    return out


def phase_wtw(dev) -> dict:
    """The precision-column kernel against W[:, j] @ W (within 1e-4·max|u|)
    and against itself (bit for bit); one launch and no allocation a call
    with `out`; then each rank's strip at N = 10 240 for S = 2 and 4
    against W_loc[:, j] @ W_loc; times of the square call and of the
    strips (`wtw_times`)."""
    from algp_tpu_torch.ops import updates as U

    gen = torch.Generator(device=dev).manual_seed(0)
    worst_abs, worst_rel, times = 0.0, 0.0, {}
    for n, js in ((10240, (0, 511, 512, 5000, 10239)), (1000, (0, 511, 512, 999))):
        W = torch.randn((n, n), generator=gen, device=dev) / n ** 0.5
        W = torch.tril(W)
        for j in js:
            jt = torch.tensor(j, device=dev)
            u1, u2 = U.wtw_column(W, jt), U.wtw_column(W, jt)
            ref = U.wtw_column_reference(W, jt)
            if not torch.equal(u1, u2):
                raise AssertionError(f"wtw kernel not repeatable (N={n}, j={j})")
            err = float((u1 - ref).abs().max())
            rel = err / float(ref.abs().max())
            if not rel <= 1e-4:
                raise AssertionError(f"wtw kernel vs plain: rel {rel} (N={n}, j={j})")
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if n == 10240:
            calls = wtw_one_launch_no_alloc(dev, W)
            for j in (0, 5000):
                # the lower triangle from row j on read once, the column written once
                times[f"square j={j}"] = wtw_times(dev, W, j, 0)
            strip = wtw_strips(dev, W, js, times)
            worst_abs = max(worst_abs, strip.pop("max_abs_err"))
        del W
    emit("wtw", max_abs_err=worst_abs, max_rel_err=worst_rel, tol="1e-4*max|u|",
         calls=calls, strip=strip, times=times,
         timing="ms: the wrapper with `out`, 50 calls back to back (CUDA events); "
                "device_ms: one CUDA graph of 50 calls, replayed; plain_*: "
                "wtw_column_reference; library_*: W_loc[:, j] @ W_loc (one call); "
                "floor_device_ms: an empty kernel on the call's grid and cluster shape")
    sq = times["square j=0"]
    return {"max_abs_err": worst_abs, "ms": sq["ms"], "device_ms": sq["device_ms"],
            "plain_ms": sq["plain_ms"], "bound_ms": sq["bound_ms"], "bound_by": sq["bound_by"],
            "library_ms": sq["library_ms"], "floor_device_ms": sq["floor_device_ms"],
            "times": times}


def graph_ms(fn, reps: int = 50) -> float:
    """Device time of one fn() with no host work between calls: `reps`
    calls captured in one CUDA graph, the graph replayed 3 times (CUDA
    events), warm."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def wtw_times(dev, W_loc, j: int, row0: int) -> dict:
    """One case's times at index j (the strip W_loc of rows [row0, row0 +
    rows)): kernel, plain version and W_loc[:, j] @ W_loc, each back to
    back through its call and as device time alone; an empty kernel on
    the kernel's launch shape; the bytes bound (the strip's entries at
    columns ≤ the row from row max(row0, j) on read once, the (N,) column
    written once; one multiply-add an entry)."""
    from algp_tpu_torch.ops import _cuda
    from algp_tpu_torch.ops import updates as U

    rows, n = W_loc.shape
    jt = torch.tensor([j], device=dev)
    out = torch.empty(n, device=dev)
    lib = _cuda.library()
    runs = {"": lambda: U.wtw_column_strip(W_loc, jt, row0, out=out),
            "plain_": lambda: U.wtw_column_reference(W_loc, jt),
            "library_": lambda: W_loc[:, j] @ W_loc}
    case = {}
    for tag in list(runs) + list(runs)[::-1]:  # in turns: kernel, plain, library, ...
        case.setdefault(f"{tag}ms", []).append(cuda_ms(runs[tag], 50))
        case.setdefault(f"{tag}device_ms", []).append(graph_ms(runs[tag]))
    case = {k: float(np.mean(v)) for k, v in case.items()}
    case["floor_device_ms"] = graph_ms(lambda: _cuda.check(lib.algp_wtw_empty(
        W_loc.data_ptr(), n, row0, rows, _cuda.stream_ptr(dev)), "wtw empty launch"))
    k0 = max(row0, j)
    entries = max(row0 + rows - k0, 0) * (k0 + row0 + rows + 1) / 2
    case["bound_ms"], case["bound_by"] = bound(4 * entries + 4 * n, entries)
    case["device_share_of_bound"] = case["bound_ms"] / case["device_ms"]
    case["no_slower_than_library"] = case["ms"] <= case["library_ms"]
    return case


def wtw_one_launch_no_alloc(dev, W) -> dict:
    """A call with `out` (the loops' form), square and strip: exactly one
    kernel on the device (torch.profiler), and no allocation over 100
    calls (the caching allocator's count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from algp_tpu_torch.ops import updates as U

    n = W.shape[0]
    W_loc = W[n // 4:n // 2].contiguous()
    jt = torch.tensor([1], device=dev)
    out = torch.empty(n, device=dev)
    res = {}
    for tag, call in (("square", lambda: U.wtw_column(W, jt, out=out)),
                      ("strip", lambda: U.wtw_column_strip(W_loc, jt, n // 4, out=out))):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        for _ in range(100):
            call()
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
        if len(kernels) != 1 or allocs:
            raise AssertionError(f"wtw {tag} call: device kernels {kernels}, "
                                 f"{allocs} allocations over 100 calls")
        res[tag] = {"device_kernels": kernels, "allocations_in_100_calls": allocs}
    del W_loc
    return res


def wtw_strips(dev, W, js, times) -> dict:
    """Every rank's strip of W (N = 10 240) for S = 2 and 4: the kernel
    within 1e-4·max|u| of W_loc[:, j] @ W_loc with exact zeros past the
    strip's last row, the strips' sum within 1e-4·max|u| of the square
    column; at j = 0 each strip's times (`wtw_times`) into `times`."""
    from algp_tpu_torch.ops import updates as U

    n = W.shape[0]
    worst = 0.0
    for S in (2, 4):
        nl = n // S
        strips = [W[r * nl:(r + 1) * nl].contiguous() for r in range(S)]
        for j in js:
            jt = torch.tensor(j, device=dev)
            total = torch.zeros(n, device=dev)
            for r, W_loc in enumerate(strips):
                got = U.wtw_column_strip(W_loc, jt, r * nl)
                ref = U.wtw_column_reference(W_loc, jt)
                err = float((got - ref).abs().max())
                if not err <= 1e-4 * float(ref.abs().max()):
                    raise AssertionError(f"wtw strip {r} of {S} vs plain: {err} (j={j})")
                if (got[(r + 1) * nl:] != 0).any():
                    raise AssertionError(f"wtw strip {r} of {S}: nonzero past its rows (j={j})")
                worst = max(worst, err)
                total += got
            full = U.wtw_column_reference(W, jt)
            if not float((total - full).abs().max()) <= 1e-4 * float(full.abs().max()):
                raise AssertionError(f"wtw strips of {S} do not add up to the column (j={j})")
        for r, W_loc in enumerate(strips):
            times[f"S={S} rank {r}"] = wtw_times(dev, W_loc, 0, r * nl)
        del strips
    return {"max_abs_err": worst, "tol": "1e-4*max|u|"}


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lowrank_workload(n, num_pilot=64):
    """benchmarks/lowrank_bench.py's inputs, from numpy seed 0 in its order:
    an n × n grid (ij order) jittered by U(-0.05, 0.05), the pilots, and
    smooth observations at them.  Returns (x, pilot, y)."""
    rng = np.random.default_rng(0)
    xs, ys = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    x = np.stack([xs.ravel(), ys.ravel()], axis=1)
    x += rng.uniform(-0.05, 0.05, x.shape).astype(np.float32)
    pilot = rng.choice(n * n, size=num_pilot, replace=False)
    y = np.sin(0.05 * x[pilot, 0]) * np.cos(0.07 * x[pilot, 1])
    y = (y + 0.1 * rng.standard_normal(num_pilot)).astype(np.float32)
    return x, pilot, y


def jittered_grid(rows, cols, seed):
    rng = np.random.default_rng(seed)
    r, c = np.divmod(np.arange(rows * cols), cols)
    return np.stack([c + 0.1 * rng.standard_normal(rows * cols),
                     r + 0.1 * rng.standard_normal(rows * cols)], 1)


def phase_fidelity(dev, oracle) -> None:
    from algp_tpu_torch.acquisition import greedy_select
    from algp_tpu_torch.ops.kernels import KernelSpec

    x = jittered_grid(10, 15, seed=17)
    spec = KernelSpec("rbf", ds=2)
    params = spec.init_params(ls_spatial=3.0, outputscale=1.0, noise=0.15,
                              device=dev)
    pilot = np.linspace(0, len(x) - 1, 8).round().astype(np.int64)
    nv = 0.15 ** 2
    K = oracle.gram(x, x, ls_spatial=3.0, outputscale=1.0)
    out = {}
    for strategy in ("entropy", "mi"):
        res = greedy_select(
            spec, params, torch.tensor(x, dtype=torch.float32, device=dev),
            torch.full((len(x),), nv, device=dev),
            torch.tensor(pilot, device=dev), rounds=50, num_pilot=8,
            strategy=strategy,
        )
        sel = res.selected.cpu().numpy()
        if strategy == "entropy":
            ref, _ = oracle.greedy_variance_selection(K, nv, 50, pilot)
        else:
            ref, _ = oracle.greedy_mi_selection(K, nv, 50, pilot)
        if not np.array_equal(sel, ref):
            first = int(np.flatnonzero(sel != ref)[0])
            raise AssertionError(
                f"{strategy} selection differs from the f64 oracle from round "
                f"{first}: {sel[first:first + 5]} vs {ref[first:first + 5]}")
        out[strategy] = "50/50 equal"
    emit("fidelity", grid="10x15 jittered, ls 3, s2 1, noise 0.15, 8 pilots",
         **out)


def phase_main(dev, oracle, card: str) -> dict:
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch.config import FieldConfig, FitConfig
    from algp_tpu_torch.field import FieldEnv
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops import updates as U
    from algp_tpu_torch.ops.kernels import KernelSpec

    tie = torch.zeros(1 << 20, device=dev)
    tie[[777, 5000, 900000]] = 1.0
    if int(torch.argmax(tie)) != 777 or int(torch.argmax(
            torch.tensor([1.0, 3.0, 3.0, 2.0], device=dev))) != 1:
        raise AssertionError("torch.argmax on CUDA does not return the first "
                             "index of a tied maximum")

    spec = KernelSpec("rbf", ds=2)
    fitcfg = FitConfig(iters=100, restarts=4)
    rounds, num_pilot = 50, 32

    _zero_counts()
    env = FieldEnv(FieldConfig(num_rows=GRID, num_cols=GRID, true_ls_spatial=8.0,
                               seed=0), spec, device=dev)
    n = env.n
    pilot = np.linspace(0, n - 1, num_pilot).round().astype(np.int64)
    s = env.collect(pilot, "precise")
    pilot_j = torch.tensor(s.indices, device=dev)
    x_pilot = env.X.index_select(0, pilot_j)
    y_pilot = torch.tensor(s.y, dtype=torch.float32, device=dev)

    def episode(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        fit_res, sel = acq.fit_and_select(
            spec, fitcfg, x_pilot, y_pilot, env.X, pilot_j,
            rounds=rounds, num_pilot=num_pilot, strategy="mi", generator=gen,
        )
        return fit_res, float(fit_res.nll.cpu()), sel.selected.cpu().numpy()

    times, per_episode = [], []
    for rep in range(REPS + 1):
        c0 = _counts()
        t0 = time.perf_counter()
        fit_res, nll, sel = episode(rep)
        dt = (time.perf_counter() - t0) * 1e3
        per_episode.append({k: v - c0[k] for k, v in _counts().items()})
        if rep:  # rep 0 is the warm-up
            times.append(dt)
        if not np.isfinite(nll):
            raise AssertionError(f"non-finite NLL {nll}")
        if len(np.unique(sel)) != rounds or not (sel < n).all() or (sel < 0).any():
            raise AssertionError(f"bad selection {sel}")
    launches = _counts()
    # Gram launches: the pilots' cross-Gram and the MI seed; the seed's
    # factor is the library's
    for run in per_episode:
        if (run["gram"], run["wtw_column"], run["cholesky"]) != (2, rounds, 0):
            raise AssertionError(f"episode launches {run}")

    # the fitted NLL agrees with the f64 oracle's at the fitted params
    p = fit_res.params
    ls2 = torch.exp(p.log_ls_spatial).cpu().numpy().astype(np.float64)
    nv = max(float(torch.exp(2 * p.log_noise)), fitcfg.min_noise ** 2)
    xp = x_pilot.cpu().numpy().astype(np.float64)
    Kp = oracle.gram(xp, xp, ls_spatial=ls2, outputscale=float(torch.exp(
        p.log_outputscale))) + (nv + fitcfg.jitter) * np.eye(num_pilot)
    ref_nll = oracle.nll(Kp, y_pilot.cpu().numpy().astype(np.float64))
    # f32 factor of a 32 × 32 system at noise ≈ 1e-2 vs f64
    if not abs(nll - ref_nll) <= 1e-3 * abs(ref_nll) + 1e-3:
        raise AssertionError(f"fit NLL {nll} vs f64 oracle {ref_nll}")
    emit("main", workload="fit_and_select N=10000 (100x100 rbf ls 8), 32 pilots, "
         "adam 4x100, 50 MI rounds", median_ms=float(np.median(times)),
         min_ms=float(min(times)), reps_ms=times, nll=nll, nll_f64_oracle=ref_nll,
         launches=launches, per_episode_launches=per_episode[0],
         first_selected=sel[:10].tolist(), card=card)
    return {"env": env, "x_pilot": x_pilot, "y_pilot": y_pilot,
            "median_ms": float(np.median(times)),
            "pilot_j": pilot_j, "launches": launches, "params": p,
            "episode": episode, "selected": sel, "min_noise": fitcfg.min_noise,
            "fit": fit_res}


def phase_layers(dev, main) -> None:
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch.config import FitConfig
    from algp_tpu_torch.models import gp
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops import linalg as la
    from algp_tpu_torch.ops.kernels import KernelSpec

    spec = KernelSpec("rbf", ds=2)
    p = main["params"]
    x = main_grid(dev)
    nvs = torch.ones(x.shape[0], device=dev)
    out = {}
    out["fit_ms"] = wall_ms(lambda: gp.fit(
        spec, FitConfig(iters=100, restarts=4), main["x_pilot"], main["y_pilot"],
        generator=torch.Generator(device=dev).manual_seed(0)))
    out["gram_with_noise_ms"] = cuda_ms(
        lambda: G.gram_kernel_with_noise(spec, p, x, nvs), 5)
    K = G.gram_kernel_with_noise(spec, p, x, nvs)
    out["cholesky_ms"] = cuda_ms(lambda: acq._seed_factor(K), 3)
    L = acq._seed_factor(K)
    out["tri_inv_ms"] = cuda_ms(lambda: la.tri_inv(L), 3)
    del K, L
    nv = torch.full((GRID * GRID,), float(torch.exp(2 * p.log_noise)), device=dev)
    for strategy in ("mi", "entropy"):
        out[f"greedy_select_{strategy}_ms"] = wall_ms(lambda: acq.greedy_select(
            spec, p, main["env"].X, nv, main["pilot_j"], rounds=50,
            num_pilot=32, strategy=strategy))
    out["peak_mem_GB"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
    emit("layers", n_padded=x.shape[0], **out)


def phase_profile(main) -> None:
    """One main-path episode under torch.profiler: the device's busy
    share of the episode's wall time and the kernels that fill it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    main["episode"](100)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        main["episode"](101)
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    emit("profile", wall_ms_profiled=wall, device_busy_ms=busy,
         device_busy_share=busy / wall, device_launches=sum(
             c for c, _ in by_name.values()),
         top_kernels=[{"name": k[:90], "count": c, "ms": round(ms, 3)}
                      for k, (c, ms) in top])


def _counts() -> dict:
    from algp_tpu_torch.ops import chol as C
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops import updates as U

    return {"gram": G.LAUNCHES, "wtw_column": U.LAUNCHES, "cholesky": C.LAUNCHES,
            "gram_composite": G.COMPOSITE_LAUNCHES}


def _zero_counts() -> None:
    from algp_tpu_torch.ops import chol as C
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops import updates as U

    G.LAUNCHES = G.COMPOSITE_LAUNCHES = U.LAUNCHES = C.LAUNCHES = 0


def run_episodes(dev, args: list, tag: str, warm: bool, capture_step=None) -> dict:
    """An episode through the CLI, in this process: a warm-up run when
    `warm`, then the timed run with the kernel counts zeroed just before
    it.  Every plan call runs under torch's sync debug mode, which warns at
    each synchronizing operation: a step may make one (its read of the
    outputs).  `capture_step`: keep the agent and the state its timed run's
    plan saw at that step (`agent`, `plan_state`).  The timed run also
    records, from host-side counts only, each k-center chain's size, each
    small-factor seed's Gram launches (its chunks) and the FITC truth's
    time (synchronised: it runs before the first plan) and launches, and
    the end-of-episode trait fits' env, mean fields, RMSEs and seconds."""
    from algp_tpu_torch import acquisition_lowrank as acq_lr
    from algp_tpu_torch import cli, episode
    from algp_tpu_torch import field as field_mod
    from algp_tpu_torch.models import multifit, sparse_gp
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.utils import checkpoint as ckpt

    OUT.mkdir(parents=True, exist_ok=True)
    syncs: list[int] = []
    sync_sites: list[list] = []  # file:line of each plan call's syncs
    plan_grams: list[int] = []  # Gram kernel launches of each plan call
    sparse_refits: list[int] = []
    captured: dict = {}
    probes: dict = {"kcenter": [], "seed_chunks": [], "truth": [], "traits": [],
                    "final": []}
    orig = episode.Agent._plan_and_metrics
    orig_traits, orig_fields = episode.Agent._trait_posteriors, multifit.multitrait_mean_fields
    orig_sparse = {k: getattr(sparse_gp, k)
                   for k in ("fit_step_sparse", "fit_step_sparse_warm")}
    orig_kc, orig_seed = acq_lr.kcenter_indices, acq_lr.lowrank_factors_seed
    orig_truth = field_mod.FieldEnv._synthesize_lowrank
    orig_eval = field_mod.FieldEnv.evaluate

    def kcenter(x, m, *a, **k):
        probes["kcenter"].append([int(x.shape[0]), int(m)])
        return orig_kc(x, m, *a, **k)

    def seed(*a, **k):
        g0 = G.LAUNCHES
        out = orig_seed(*a, **k)
        probes["seed_chunks"].append(G.LAUNCHES - g0)
        return out

    def truth(self, *a, **k):
        torch.cuda.synchronize()
        g0, t0 = G.LAUNCHES, time.perf_counter()
        out = orig_truth(self, *a, **k)
        torch.cuda.synchronize()
        probes["truth"].append({"s": time.perf_counter() - t0,
                                "gram_chunks": G.LAUNCHES - g0})
        return out

    def evaluate(self, mean, var):
        probes["final"][:] = [(self, var)]  # the last one scored is the final posterior
        return orig_eval(self, mean, var)

    def fields(*a, **k):
        M = orig_fields(*a, **k)
        probes["traits"].append({"M": M})
        return M

    def traits(self, st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_traits(self, st)
        probes["traits"][-1].update(env=self.env, rmse=out, s=time.perf_counter() - t0)
        return out

    def counted(self, st):
        if capture_step is not None and st.step == capture_step and not captured:
            captured.update(agent=self, plan_state=dataclasses.replace(st))
        g0 = G.LAUNCHES
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return orig(self, st)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                hits = [w for w in caught if "synchroniz" in str(w.message)]
                syncs.append(len(hits))
                sync_sites.append([f"{Path(w.filename).name}:{w.lineno}" for w in hits])
                plan_grams.append(G.LAUNCHES - g0)

    def sparse_counted(name):
        def fit(*a, **k):
            sparse_refits.append(1)
            return orig_sparse[name](*a, **k)
        return fit

    def run(run_tag):
        metrics = OUT / f"{tag}_{run_tag}.jsonl"
        state = OUT / f"{tag}_{run_tag}.npz"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([*args, "--metrics-jsonl", str(metrics),
                           "--checkpoint", str(state)])
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        history = [json.loads(line) for line in metrics.read_text().splitlines()]
        return summary, history, ckpt.load(str(state), dev)

    episode.Agent._plan_and_metrics = counted
    for k in orig_sparse:
        setattr(sparse_gp, k, sparse_counted(k))
    acq_lr.kcenter_indices, acq_lr.lowrank_factors_seed = kcenter, seed
    field_mod.FieldEnv._synthesize_lowrank = truth
    field_mod.FieldEnv.evaluate = evaluate
    episode.Agent._trait_posteriors, multifit.multitrait_mean_fields = traits, fields
    try:
        warm_s = None
        if warm:
            t0 = time.perf_counter()
            run("warm")
            warm_s = time.perf_counter() - t0
        syncs.clear()
        sync_sites.clear()
        plan_grams.clear()
        sparse_refits.clear()
        for v in probes.values():
            v.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        summary, history, st = run("timed")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        episode.Agent._plan_and_metrics = orig
        for k, fn in orig_sparse.items():
            setattr(sparse_gp, k, fn)
        acq_lr.kcenter_indices, acq_lr.lowrank_factors_seed = orig_kc, orig_seed
        field_mod.FieldEnv._synthesize_lowrank = orig_truth
        field_mod.FieldEnv.evaluate = orig_eval
        episode.Agent._trait_posteriors = orig_traits
        multifit.multitrait_mean_fields = orig_fields
    return dict(summary=summary, history=history, state=st, syncs=list(syncs),
                sync_sites=list(sync_sites),
                plan_grams=list(plan_grams),
                launches=launches, wall_s=wall_s, warm_s=warm_s, peak=peak,
                sparse_refits=len(sparse_refits), probes=probes, **captured)


def check_episode(run: dict, args: list, workload: str, card: str) -> dict:
    """The episode's checks (finite metrics, held-out RMSE falls, budget
    not overdrawn, indices on the grid, one sync per plan, the Gram kernel
    launched and the Cholesky kernel not) and its summary fields."""
    from algp_tpu_torch import cli

    summary, history, st = run["summary"], run["history"], run["state"]
    syncs, launches = run["syncs"], run["launches"]
    pilot = next(h for h in history if h["phase"] == "pilot")
    plans = [h for h in history if h["phase"] == "plan"]
    calib = next(h for h in history if h["phase"] == "calibration")
    cfg = cli.config_from_args(cli.build_parser().parse_args(args))
    n = cfg.field.num_rows * cfg.field.num_cols
    budget, refit_every = cfg.episode.budget, cfg.episode.refit_every
    metrics = [pilot["rmse"], pilot["rmse_test"], pilot["mean_var"],
               summary["final_rmse"], summary["final_rmse_test"],
               summary["mean_var"]] + [h[k] for h in plans
                                       for k in ("rmse", "rmse_test", "mean_var")]
    metrics += [v for k, v in calib.items()
                if k not in ("t_wall", "step", "phase", "eval_device")]
    if not np.isfinite(metrics).all():
        raise AssertionError(f"non-finite episode metric: {metrics}")
    if not summary["final_rmse_test"] < pilot["rmse_test"]:
        raise AssertionError(f"held-out RMSE did not fall: pilot {pilot['rmse_test']}, "
                             f"final {summary['final_rmse_test']}")
    if st.budget_left < -1e-6:
        raise AssertionError(f"budget overdrawn: {st.budget_left}")
    if st.sampled_idx.min() < 0 or st.sampled_idx.max() >= n:
        raise AssertionError("a sampled index lies outside the grid")
    if len(syncs) != len(plans) + 1 or max(syncs) > 1:
        raise AssertionError(f"device→host syncs per planning step: {syncs}, at "
                             f"{run['sync_sites']}")
    # the seeds' factors are the library's: no Cholesky kernel launch
    if launches["gram"] < 1 or launches["cholesky"] != 0:
        raise AssertionError(f"episode launches: {launches}")
    # every plan call launches the Gram kernel: a plan step's cross-Gram
    # (plus any seed it queues), the final call's posterior
    if min(run["plan_grams"]) < 1:
        raise AssertionError(f"a plan call launched no Gram kernel: {run['plan_grams']}")
    # step wall time from the logger's clock: a step's record follows its
    # plan; refit steps (step % refit_every == 0) also queue the fit and seed
    t_prev = [pilot["t_wall"]] + [h["t_wall"] for h in plans[:-1]]
    step_ms = {h["step"]: (h["t_wall"] - t) * 1e3 for h, t in zip(plans, t_prev)}
    refit = [v for k, v in step_ms.items() if k % refit_every == 0]
    other = [v for k, v in step_ms.items() if k % refit_every]
    return dict(
        workload=workload, steps=summary["steps"], samples=summary["n_sampled"],
        budget_used=budget - st.budget_left, budget=budget,
        rmse_pilot=pilot["rmse"], rmse_test_pilot=pilot["rmse_test"],
        rmse_final=summary["final_rmse"], rmse_test_final=summary["final_rmse_test"],
        calibration={k: v for k, v in calib.items()
                     if k not in ("t_wall", "step", "phase")},
        plan_ms_median=float(np.median([h["plan_s"] for h in plans])) * 1e3,
        # the plan's parts: host path enumeration, queueing the seed, the
        # fused step and its one read
        plan_parts_ms_median={k: float(np.median([h[k] for h in plans if k in h])) * 1e3
                              for k in ("enum_s", "seed_s", "step_s")},
        step_ms_median=float(np.median(other)) if other else None,
        refit_step_ms_median=float(np.median(refit)) if refit else None,
        pilot_fit_s=pilot.get("fit_s"),
        episode_wall_s=run["wall_s"], warmup_wall_s=run["warm_s"],
        syncs_per_plan=syncs, launches=launches,
        plan_gram_launches=sorted(set(run["plan_grams"])),
        peak_mem_GB=round(run["peak"] / 1e9, 3), card=card,
    )


def phase_episode(dev, card: str) -> dict:
    """c5_10k through the CLI: a warm-up run, then the timed run."""
    run = run_episodes(dev, EPISODE_ARGS, "episode", warm=True)
    out = check_episode(
        run, EPISODE_ARGS,
        "c5_10k via algp_tpu_torch.cli.main: 100x100 Matern-3/2 field (ls 8), "
        "64 pilots, budget 400, 8 waypoints, 10 samples/step, exact MI planner, "
        "warm refits 60x2 every 4 steps", card)
    emit("episode", **out)
    return {"launches": run["launches"], "params": run["state"].params}


def phase_lowrank_main(dev, oracle, card: str, grid: int = LOWRANK_GRID,
                       m_ind: int = LOWRANK_M, reps: int = REPS,
                       tag: str = "lowrank_main", gate: int = 0) -> dict:
    """Greedy low-rank MI over a jittered grid² (benchmarks/lowrank_bench.py's
    workload) through `acquisition_lowrank.fit_and_select_lowrank`: one
    warm-up and `reps` timed runs with the counts zeroed before them, then
    the layers one by one, then the small-size fidelity check (with
    `acquisition.COND_MATMUL_N` set to `gate` when it is not 0)."""
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch import acquisition_lowrank as lr
    from algp_tpu_torch.config import FitConfig
    from algp_tpu_torch.models import gp
    from algp_tpu_torch.ops.kernels import KernelSpec

    spec = KernelSpec("matern32", ds=2)
    fitcfg = FitConfig(iters=60, restarts=4)
    rounds, num_pilot = 50, 64
    x_np, pilot_np, y_np = lowrank_workload(grid, num_pilot)
    x = torch.tensor(x_np, device=dev)
    pilot = torch.tensor(pilot_np, device=dev)
    x_train, y = x.index_select(0, pilot), torch.tensor(y_np, device=dev)

    def run(seed):
        fit, sel = lr.fit_and_select_lowrank(
            spec, fitcfg, x_train, y, x, pilot, rounds=rounds, num_pilot=num_pilot,
            num_inducing=m_ind, generator=torch.Generator(device=dev).manual_seed(seed))
        return fit, float(fit.nll.cpu()), sel.selected.cpu().numpy()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    times, per_run = [], []
    for rep in range(reps + 1):
        c0 = _counts()
        t0 = time.perf_counter()
        fit, nll, sel = run(rep)
        dt = (time.perf_counter() - t0) * 1e3
        per_run.append({k: v - c0[k] for k, v in _counts().items()})
        if rep:  # rep 0 is the warm-up
            times.append(dt)
        if not np.isfinite(nll):
            raise AssertionError(f"non-finite NLL {nll}")
        if len(np.unique(sel)) != rounds or np.isin(sel, pilot_np).any():
            raise AssertionError(f"duplicate or pilot selections: {sel}")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    # two Gram kernel launches per run: the pilots' cross-Gram and the
    # seed's K_zx
    for c in per_run:
        if c["gram"] != 2 or c["wtw_column"] != 0 or c["cholesky"] != 0:
            raise AssertionError(f"low-rank run launches: {c}")

    # the layers, at the last run's fitted params
    p = fit.params
    nv_base = torch.clamp_min(p.noise_var, fitcfg.min_noise ** 2)
    nv = nv_base * torch.ones(x.shape[0], device=dev)
    layers = {"fit_ms": wall_ms(lambda: gp.fit(
        spec, fitcfg, x_train, y, generator=torch.Generator(device=dev).manual_seed(0)))}
    layers["kcenter_ms"] = wall_ms(lambda: lr.kcenter_indices(x, m_ind))
    z = x.index_select(0, lr.kcenter_indices(x, m_ind))
    layers["seed_ms"] = wall_ms(lambda: lr.lowrank_precision_seed(spec, p, x, nv, z))
    greedy_ms = wall_ms(lambda: lr.greedy_select_lowrank(
        spec, p, x, nv, pilot, z, rounds=rounds, num_pilot=num_pilot))
    layers["rounds_ms"] = greedy_ms - layers["seed_ms"]
    layers["greedy_select_lowrank_ms"] = greedy_ms
    del z

    # fidelity: on a 30 × 30 jittered grid, 150 k-center points, 6 pilots,
    # the card's 30 selections (kernel-built seed) equal the f64 oracle's
    xs = jittered_grid(30, 30, seed=11)
    sp = KernelSpec("rbf", ds=2)
    ps = sp.init_params(ls_spatial=3.0, outputscale=1.0, noise=0.15, device=dev)
    xst = torch.tensor(xs, dtype=torch.float32, device=dev)
    zidx = lr.kcenter_indices(xst, 150)
    pil = np.linspace(0, len(xs) - 1, 6).round().astype(np.int64)
    gate_n = acq.COND_MATMUL_N
    acq.COND_MATMUL_N = gate or gate_n
    try:
        got = lr.greedy_select_lowrank(
            sp, ps, xst, torch.full((len(xs),), 0.15 ** 2, device=dev),
            torch.tensor(pil, device=dev), xst.index_select(0, zidx), rounds=30,
            num_pilot=6).selected.cpu().numpy()
    finally:
        acq.COND_MATMUL_N = gate_n
    ref, _ = oracle.greedy_mi_selection_lowrank(
        oracle.gram(xs, xs, ls_spatial=3.0, outputscale=1.0), zidx.cpu().numpy(),
        0.15 ** 2, 30, pil)
    if not np.array_equal(got, ref):
        first = int(np.flatnonzero(got != ref)[0])
        raise AssertionError(f"low-rank selections differ from the f64 oracle from "
                             f"round {first}: {got[first:first + 5]} vs {ref[first:first + 5]}")
    emit(tag,
         workload=f"fit_and_select_lowrank N={x.shape[0]} ({grid}x{grid} jittered grid, "
                  f"matern32), M={m_ind} k-center, 64 pilots, adam 4x60, 50 MI rounds",
         median_ms=float(np.median(times)), min_ms=float(min(times)), reps_ms=times,
         nll=nll, launches=launches, per_run_launches=per_run[0], layers=layers,
         peak_mem_GB=round(peak / 1e9, 3), first_selected=sel[:10].tolist(),
         fidelity="30x30 jittered, rbf ls 3, M 150, 6 pilots: 30/30 equal to the "
                  "f64 low-rank oracle" + (f", COND_MATMUL_N = {gate}" if gate else ""),
         card=card)
    del x, x_train
    torch.cuda.empty_cache()
    return {"launches": launches}


def plan_inputs(agent, st, dev):
    """The fused step's inputs at a state an episode planned from: the
    path batch the agent enumerates there, padded as it pads it.  Returns
    (args, keyword arguments, mask of the real paths)."""
    from algp_tpu_torch import planning

    cfg = agent.cfg
    batch = planning.enumerate_batch(
        agent.env, st.pose, min(st.budget_left, cfg.episode.budget / cfg.episode.num_waypoints),
        max_paths=agent._pad_paths, k_max=agent._k_max,
        min_cost_frac=cfg.episode.min_cost_frac)
    P = agent._pad_paths
    sets = np.zeros((P, agent._k_max), np.int64)
    sizes, costs = np.zeros(P, np.int64), np.ones(P, np.float32)
    sets[:len(batch)], sizes[:len(batch)], costs[:len(batch)] = (
        batch.sets, batch.sizes, batch.costs)
    idx_pad, m, ns_pad, y_pad = agent._padded_obs(st)
    common = dict(min_noise=cfg.fit.min_noise, nv_mult=agent._nv_mult,
                  path_utility=agent._path_utility)
    args = (agent.spec, st.params, agent._Xdev, idx_pad, m, ns_pad, y_pad,
            torch.tensor(sets, device=dev), torch.tensor(sizes, device=dev),
            torch.tensor(costs, device=dev))
    return args, common, sizes > 0


def phase_episode_100k(dev, card: str) -> dict:
    """c5_100k through the CLI (FITC truth, low-rank planner, device
    metrics): a warm-up run and the timed run.  Then, at the state the
    timed run planned from at step 2, the small-factor step against the
    full-seed step."""
    from algp_tpu_torch import acquisition_lowrank as lr

    run = run_episodes(dev, EPISODE_100K_ARGS, "episode_100k", warm=True,
                       capture_step=2)
    out = check_episode(
        run, EPISODE_100K_ARGS,
        "c5_100k via algp_tpu_torch.cli.main: 320x320 Matern-3/2 field (ls 25, "
        "FITC truth over 2048 k-center points), 128 pilots, budget 1280, 8 "
        "waypoints, 10 samples/step, low-rank MI planner M=1024, warm refits "
        "100x3 every 4 steps, device metrics", card)
    if run["launches"]["wtw_column"] != 0:
        raise AssertionError(f"episode_100k launches: {run['launches']}")

    agent, st = run["agent"], run["plan_state"]
    cfg, dev_x = agent.cfg, agent._Xdev
    args, common, live = plan_inputs(agent, st, dev)
    z = agent._lowrank_z()
    fac = lr.lowrank_factors_seed(agent.spec, st.params, dev_x, z,
                                  min_noise=cfg.fit.min_noise, nv_mult=agent._nv_mult)
    full = lr.lowrank_seed_with_z(agent.spec, st.params, dev_x, z,
                                  min_noise=cfg.fit.min_noise, nv_mult=agent._nv_mult)
    b_f, _, _, s_f = lr.plan_episode_step_lowrank_factors(*args, fac, **common)
    b_s, _, _, s_s = lr.plan_episode_step_lowrank(*args, full, **common)
    s_f, s_s = s_f.cpu().numpy(), s_s.cpu().numpy()
    step_check = {"step": st.step, "paths": int(live.sum()), "best_factors": int(b_f),
                  "best_full_seed": int(b_s),
                  "max_rel_score_diff": float(np.max(np.abs(s_f - s_s)[live]
                                                     / np.abs(s_s[live]).clip(1e-6)))}
    if int(b_f) != int(b_s):
        raise AssertionError(f"the factors step and the full-seed step part: {step_check}")
    out["factors_vs_full_seed"] = step_check
    out["seed_ms"] = cuda_ms(lambda: lr.lowrank_factors_seed(
        agent.spec, st.params, dev_x, z, min_noise=cfg.fit.min_noise,
        nv_mult=agent._nv_mult), 5)
    out["kcenter_ms"] = wall_ms(lambda: lr.kcenter_indices(dev_x, z.shape[0]))
    emit("episode_100k", **out)
    return {"launches": run["launches"]}


def phase_episode_long(dev, card: str) -> dict:
    """c5_long through the CLI: the exact planner over ~160 steps, refits
    switching to SGPR past 512 samples; one timed run."""
    run = run_episodes(dev, EPISODE_LONG_ARGS, "episode_long", warm=False)
    out = check_episode(
        run, EPISODE_LONG_ARGS,
        "c5_long via algp_tpu_torch.cli.main: 100x100 Matern-3/2 field (ls 8), "
        "64 pilots, budget 4800, 80 waypoints, 10 samples/step, exact MI planner, "
        "warm refits 60x2 every 4 steps, SGPR over 256 k-center points past 512 "
        "samples", card)
    out.update(sgpr_checks(run, EPISODE_LONG_ARGS))
    # the campaign's final calibration beside its smallest held-out variance
    env, var = run["probes"]["final"][-1]
    out.update(nlpd_test=out["calibration"]["nlpd_test"],
               cov90_test=out["calibration"]["cov90_test"],
               **held_out_diagnostics(env, var.cpu().numpy()))
    emit("episode_long", **out)
    return {"launches": run["launches"]}


def sgpr_checks(run: dict, args: list) -> dict:
    """At least one SGPR refit, and one for every refit step past the
    sparse threshold (the fit ran on the samples the record counts)."""
    from algp_tpu_torch import cli

    if run["sparse_refits"] < 1:
        raise AssertionError(f"no SGPR refit ran in {args}")
    cfg = cli.config_from_args(cli.build_parser().parse_args(args))
    thr = cfg.fit.sparse_threshold
    refits = [h for h in run["history"] if h["phase"] == "plan"
              and h["step"] % cfg.episode.refit_every == 0]
    sgpr = [h["fit_s"] for h in refits if h["n_sampled"] > thr]
    exact = [h["fit_s"] for h in refits if h["n_sampled"] <= thr]
    if len(sgpr) != run["sparse_refits"]:
        raise AssertionError(f"SGPR refits: {run['sparse_refits']} calls, "
                             f"{len(sgpr)} refit steps past {thr} samples")
    return dict(sgpr_refits=len(sgpr), exact_refits=len(exact),
                sgpr_refit_s_median=float(np.median(sgpr)),
                exact_refit_s_median=float(np.median(exact)) if exact else None)


def phase_episode_scale(dev, card: str, args: list, tag: str, workload: str,
                        checks=None) -> dict:
    """A million-point preset through the CLI, once, with phase 9's checks,
    then its set-up layers timed one by one on the run's agent and final
    params: the truth's k-center chain, the planner's design (the chains
    of every design variant) and the per-refit seed.  `checks(run, out)`
    adds the preset's own checks."""
    from algp_tpu_torch import acquisition_lowrank as lr

    run = run_episodes(dev, args, tag, warm=False, capture_step=1)
    out = check_episode(run, args, workload, card)
    if run["launches"]["wtw_column"] != 0:
        raise AssertionError(f"{tag} launches: {run['launches']}")
    pr = run["probes"]
    if len(pr["truth"]) != 1:
        raise AssertionError(f"{tag}: FITC truth calls {pr['truth']}")
    agent, st = run["agent"], run["state"]
    out.update(truth_s=pr["truth"][0]["s"], truth_gram_chunks=pr["truth"][0]["gram_chunks"],
               seeds=len(pr["seed_chunks"]), seed_gram_chunks=sorted(set(pr["seed_chunks"])),
               kcenter_chains=pr["kcenter"], capacity=agent._max_samples,
               z_shape=list(agent._lowrank_z().shape))
    if checks is not None:
        checks(run, out)
    m_truth = agent.env.cfg.synth_inducing
    layers = {"truth_kcenter_ms": wall_ms(lambda: lr.kcenter_indices(agent.env.X, m_truth))}
    agent._z_cache = None
    layers["design_ms"] = wall_ms(agent._lowrank_z)
    agent._lr_cache = None
    layers["seed_ms"] = wall_ms(lambda: agent._lowrank_seed(st))
    out["layers"] = layers
    emit(tag, **out)
    del agent, run
    torch.cuda.empty_cache()
    return {"launches": out["launches"], "plan_ms_median": out["plan_ms_median"]}


def _design_chain(agent) -> list:
    """[candidates, M] of the planner's k-center chain: the whole grid, or
    its sub-grid past episode._KCENTER_SUBSAMPLE candidates."""
    from algp_tpu_torch import episode

    env = agent.env
    n = env.n
    if n > episode._KCENTER_SUBSAMPLE:
        n = len(episode._kcenter_subgrid_indices(env.num_rows, env.num_cols,
                                                 episode._KCENTER_TARGET))
    return [n, agent._num_inducing]


def cross_gram_route(run, dev) -> dict:
    """At the state the run planned from at step 1: the conditioning
    pass's C and the fused step's choice with the (cap, N) cross-Gram on
    the Gram kernel (the port's route) and on the plain `gram` (the
    reference's), which must agree bit for bit; the pass's time and peak
    memory on each route."""
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch import acquisition_lowrank as lr
    from algp_tpu_torch.ops import gram as G

    agent, st = run["agent"], run["plan_state"]
    args, common, live = plan_inputs(agent, st, dev)
    spec, params, x, idx_pad, m, ns_pad, y_pad = args[:7]
    fac = lr.lowrank_factors_seed(spec, params, x, agent._lowrank_z(),
                                  min_noise=agent.cfg.fit.min_noise, nv_mult=agent._nv_mult)

    def step():
        return (lr._condition_and_mean(spec, params, x, idx_pad, m, ns_pad, y_pad,
                                       agent.cfg.fit.min_noise)[0],
                lr.plan_episode_step_lowrank_factors(*args, fac, **common))

    def pass_only():
        return lr._condition_and_mean(spec, params, x, idx_pad, m, ns_pad, y_pad,
                                      agent.cfg.fit.min_noise)

    out = {"step": st.step, "cap": int(idx_pad.shape[0]), "N": int(x.shape[0])}
    routes = {}
    for route, fn in (("kernel", G.gram_kernel), ("plain", G.gram_reference)):
        acq.gram_kernel = fn
        try:
            C, (best, _, _, scores) = step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out[f"{route}_pass_ms"] = cuda_ms(pass_only, 3)
            out[f"{route}_pass_peak_GB"] = round(
                (torch.cuda.max_memory_allocated() - base) / 1e9, 3)
        finally:
            acq.gram_kernel = G.gram_kernel
        routes[route] = (C, int(best), scores.cpu().numpy()[live])
    (Ck, bk, sk), (Cp, bp, sp) = routes["kernel"], routes["plain"]
    out.update(C_bitwise_equal=bool(torch.equal(Ck, Cp)), best_kernel=bk, best_plain=bp,
               scores_bitwise_equal=bool(np.array_equal(sk, sp)))
    if not (out["C_bitwise_equal"] and bk == bp):
        raise AssertionError(f"the kernel and the plain cross-Gram part: {out}")
    del routes, Ck, Cp, fac
    torch.cuda.empty_cache()
    return out


def phase_episode_1m(dev, card: str) -> dict:
    def checks(run, out):
        if out["truth_gram_chunks"] != 1 or out["seed_gram_chunks"] != [1]:
            raise AssertionError(f"c5_1m streamed its truth or seed: {out}")
        if _design_chain(run["agent"]) not in out["kcenter_chains"]:
            raise AssertionError(f"c5_1m design chains: {out['kcenter_chains']}")
        out["cross_gram_route"] = cross_gram_route(run, dev)

    return phase_episode_scale(
        dev, card, EPISODE_1M_ARGS, "episode_1m",
        "c5_1m via algp_tpu_torch.cli.main: 1024x1024 Matern-3/2 field (ls 80, "
        "FITC truth over 1024 k-center points), 128 pilots, budget 4096, 8 "
        "waypoints, 10 samples/step, low-rank MI planner M=512, warm refits 60x2 "
        "every 4 steps, device metrics", checks)


def _checks_4m(ensemble: int):
    """c5_4m: no more samples than its hard cap, which does not grow; the
    truth's and every seed's K_zx streamed in chunks of 2²⁰ points (4 at
    2048²); the truth's chain over the whole grid, then one chain per
    design over the 1024² sub-grid."""
    def checks(run, out):
        from algp_tpu_torch import acquisition_lowrank as lr
        from algp_tpu_torch import field

        agent = run["agent"]
        cap, n = agent.cfg.episode.max_samples, agent.env.n
        if out["samples"] > cap or out["capacity"] != cap:
            raise AssertionError(f"c5_4m past its hard cap: {out['samples']} samples, "
                                 f"capacity {out['capacity']}")
        truth_chunks, seed_chunks = -(-n // field._SYNTH_CHUNK), -(-n // lr._SEED_CHUNK)
        if (min(truth_chunks, seed_chunks) < 2 or out["truth_gram_chunks"] != truth_chunks
                or out["seed_gram_chunks"] != [seed_chunks]):
            raise AssertionError(f"c5_4m did not stream: {out}")
        want = [[n, agent.env.cfg.synth_inducing]] + [_design_chain(agent)] * ensemble
        if out["kcenter_chains"] != want:
            raise AssertionError(f"c5_4m k-center chains: {out['kcenter_chains']}")
        if out["seeds"] % ensemble:
            raise AssertionError(f"c5_4m seeds {out['seeds']} for {ensemble} designs")
    return checks


def seed_streamed_vs_monolithic(run, dev) -> dict:
    """At the state the run planned from at step 1: the small-factor seed
    streamed (as the preset runs it) and monolithic (the gate lifted),
    their largest LB difference, and the fused step's choice under each,
    which must agree (bits may differ: the chunks change B's sums)."""
    from algp_tpu_torch import acquisition_lowrank as lr

    agent, st = run["agent"], run["plan_state"]
    args, common, live = plan_inputs(agent, st, dev)
    kw = dict(min_noise=agent.cfg.fit.min_noise, nv_mult=agent._nv_mult)
    z = agent._lowrank_z()
    fac_s = lr.lowrank_factors_seed(agent.spec, st.params, agent._Xdev, z, **kw)
    gate = lr._SEED_CHUNK_BYTES
    lr._SEED_CHUNK_BYTES = 1 << 62
    try:
        fac_m = lr.lowrank_factors_seed(agent.spec, st.params, agent._Xdev, z, **kw)
    finally:
        lr._SEED_CHUNK_BYTES = gate
    b_s, _, _, s_s = lr.plan_episode_step_lowrank_factors(*args, fac_s, **common)
    b_m, _, _, s_m = lr.plan_episode_step_lowrank_factors(*args, fac_m, **common)
    s_s, s_m = s_s.cpu().numpy()[live], s_m.cpu().numpy()[live]
    diff = float((fac_s.LB - fac_m.LB).abs().max())
    out = {"step": st.step, "paths": int(live.sum()), "max_abs_LB_diff": diff,
           "max_abs_LB_diff_rel": diff / float(fac_m.LB.abs().max()),
           "best_streamed": int(b_s), "best_monolithic": int(b_m),
           "max_rel_score_diff": float(np.max(np.abs(s_s - s_m)
                                              / np.abs(s_m).clip(1e-6)))}
    if int(b_s) != int(b_m):
        raise AssertionError(f"streamed and monolithic seeds pick different paths: {out}")
    del fac_m
    torch.cuda.empty_cache()
    return out


def phase_episode_4m(dev, card: str) -> dict:
    def checks(run, out):
        _checks_4m(1)(run, out)
        out["seed_streamed_vs_monolithic"] = seed_streamed_vs_monolithic(run, dev)

    return phase_episode_scale(
        dev, card, EPISODE_4M_ARGS, "episode_4m",
        "c5_4m via algp_tpu_torch.cli.main: 2048x2048 Matern-3/2 field (ls 160, "
        "FITC truth over 512 k-center points, streamed), 96 pilots, budget 8192, "
        "8 waypoints, 8 samples/step, low-rank MI planner M=512 over the 1024x1024 "
        "sub-grid, per_sample utility, hard cap 224, warm refits 60x2 every 4 "
        "steps, device metrics", checks)


def phase_episode_4m_ens(dev, card: str, single: dict) -> dict:
    def checks(run, out):
        _checks_4m(4)(run, out)
        out["plan_ms_median_single_design"] = single["plan_ms_median"]

    return phase_episode_scale(
        dev, card, EPISODE_4M_ENS_ARGS, "episode_4m_ens",
        "c5_4m --mi-ensemble 4 via algp_tpu_torch.cli.main: as episode_4m, with "
        "4 k-center design variants (starts j*2^20/4) averaged in every plan",
        checks)


def phase_episode_1m_long(dev, card: str) -> dict:
    def checks(run, out):
        out.update(sgpr_checks(run, EPISODE_1M_LONG_ARGS))
        if out["capacity"] != run["agent"].cfg.episode.max_samples:
            raise AssertionError(f"c5_1m_long grew its capacity to {out['capacity']}")

    return phase_episode_scale(
        dev, card, EPISODE_1M_LONG_ARGS, "episode_1m_long",
        "c5_1m_long via algp_tpu_torch.cli.main: the c5_1m field, budget 20480, "
        "40 waypoints, 10 samples/step, low-rank MI planner M=512, capacity 640, "
        "warm refits 60x2 every 4 steps, SGPR over 256 k-center points past 512 "
        "samples, device metrics", checks)


def phase_field_episode(dev, card: str, tag: str, args: list,
                        fit_s_against: tuple = None) -> dict:
    """A feature, trait or model-family preset through the CLI, once, with
    phase 9's checks and the fits' seconds (refit steps' `fit_s`; beside
    them another phase's, `fit_s_against` = (tag, seconds)).  On a
    multi-trait field also: one end-of-episode trait evaluation, every
    trait's RMSE finite, and trait 0's RMSE scored as the headline RMSE is
    scored (`env.rmse` of trait 0's mean field); the headline (the last
    refit's posterior) and trait 0's fit (every sample, its own inits) are
    reported side by side.  Under the ICM family also the independent
    family's per-trait RMSE on the same final state."""
    from algp_tpu_torch import cli
    from algp_tpu_torch.models import multifit

    run = run_episodes(dev, args, tag, warm=False)
    cfg = cli.config_from_args(cli.build_parser().parse_args(args))
    out = check_episode(run, args, f"{tag} via algp_tpu_torch.cli.main {' '.join(args)}",
                        card)
    fits = [h["fit_s"] for h in run["history"] if h["phase"] == "plan"
            and h["step"] % cfg.episode.refit_every == 0]
    out.update(fit_s_median=float(np.median(fits)), fit_s_total=float(np.sum(fits)),
               optimizer=cfg.fit.optimizer, features=cfg.kernel.df)
    if cfg.deep is not None:
        out.update(deep={"hidden": list(cfg.deep.hidden), "out": cfg.deep.out},
                   embedded_dim=cfg.kernel.ds + cfg.deep.out,
                   mlp_shapes=[list(W.shape) for W, _ in run["state"].mlp])
    if fit_s_against is not None:
        out["fit_s_median_of_" + fit_s_against[0]] = fit_s_against[1]
    pr = run["probes"]["traits"]
    T = run["state"].y_traits.shape[1] if run["state"].y_traits is not None else 1
    if T > 1:
        if len(pr) != 1:
            raise AssertionError(f"{tag}: {len(pr)} trait evaluations")
        env, (tr, trt), M = pr[0]["env"], pr[0]["rmse"], pr[0]["M"]
        if len(tr) != T or not np.isfinite(tr + trt).all():
            raise AssertionError(f"{tag}: trait RMSE {tr}, held-out {trt}")
        if (env.rmse(M[:, 0]), env.rmse(M[:, 0], test_only=True)) != (tr[0], trt[0]):
            raise AssertionError(f"{tag}: trait 0 scored apart from the headline RMSE")
        st = run["state"]
        path = ("ICM over the observed cells" if cfg.fit.multi_fit == "icm" else
                "batched fit_multi" if not np.isnan(st.y_traits).any()
                else "per-trait (visits skipped traits)")
        out.update(traits=T, trait_rmse=tr, trait_rmse_test=trt,
                   trait_fit_s=pr[0]["s"], multi_fit=cfg.fit.multi_fit, trait_path=path,
                   headline_rmse_test=out["rmse_test_final"])
        if cfg.fit.multi_fit == "icm":
            # the independent family on the same final state: the planning
            # does not depend on the family, so the pair is exact
            ind = dataclasses.replace(cfg.fit, multi_fit="independent")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M_ind = multifit.multitrait_mean_fields(
                cfg.kernel, ind, env.X, np.asarray(st.sampled_idx), st.y_traits,
                st.noise_scale, env.observed_traits,
                multifit.trait_inits(cfg.kernel, ind, cfg.episode.seed, dev))
            out.update(icm_rank=cfg.fit.icm_rank,
                       independent_trait_fit_s=time.perf_counter() - t0,
                       independent_trait_rmse=env.rmse_traits(M_ind),
                       independent_trait_rmse_test=env.rmse_traits(M_ind, test_only=True))
    emit(tag, **out)
    return {"launches": run["launches"], "fit_s_median": out["fit_s_median"]}


def _oracle_gram(oracle_path: str, spec: dict, x, ls_spatial, ls_feature,
                 outputscale: float) -> tuple:
    """(the f64 oracle module, its Gram of x)."""
    oracle = load_module("oracle", Path(oracle_path))
    return oracle, oracle.gram(x, x, spatial_kind=spec["spatial_kind"],
                               feature_kind=spec["feature_kind"], ds=spec["ds"],
                               ls_spatial=ls_spatial, ls_feature=ls_feature,
                               outputscale=outputscale)


def oracle_greedy_mi_scores(oracle_path: str, spec: dict, x, ls_spatial, ls_feature,
                            outputscale: float, nv: float, rounds: int, pilot) -> tuple:
    """The f64 oracle's greedy MI on the given inputs (host numpy; runs in a
    worker process too): (selections, (rounds, N) scores, seconds)."""
    t0 = time.perf_counter()
    oracle, K = _oracle_gram(oracle_path, spec, x, ls_spatial, ls_feature, outputscale)
    ref, traces = oracle.greedy_mi_selection(K, nv, rounds, pilot)
    return ref, np.stack(traces), time.perf_counter() - t0


def oracle_follow_mi(oracle_path: str, spec: dict, x, ls_spatial, ls_feature,
                     outputscale: float, nv: float, rounds: int, pilot,
                     selections) -> tuple:
    """The f64 oracle replaying `selections` on the inputs of
    `oracle_greedy_mi_scores` (`oracle.follow_selection`; host numpy, in a
    worker process): ((rounds, 2) the pick's score and the round's best,
    seconds)."""
    t0 = time.perf_counter()
    oracle, K = _oracle_gram(oracle_path, spec, x, ls_spatial, ls_feature, outputscale)
    pairs = oracle.follow_selection(K, nv, selections, pilot, strategy="mi")
    return np.asarray(pairs), time.perf_counter() - t0


def greedy_vs_oracle(dev, oracle, args: list, pool) -> dict:
    """Greedy MI of `cli.run_greedy` (a field with features): its record,
    the fitted params, nv and pilots it selected with, its selections,
    and the f64 oracle's on the same inputs (the candidates it selected
    over: embedded ones for a deep kernel).  The Gram and wtw launches of
    the run are counted; the oracle's work is host numpy in `pool`
    (`oracle_future` resolves to `oracle_greedy_mi_scores`' result)."""
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch import cli

    seen = {}
    orig = acq.greedy_select

    def spy(spec, params, X, nv, pilot, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(spec, params, X, nv, pilot, **kw)
        sel = res.selected.cpu().numpy()
        seen.update(spec=spec, params=params, X=X, nv=nv, pilot=pilot, selected=sel,
                    select_ms=(time.perf_counter() - t0) * 1e3)
        return res

    acq.greedy_select = spy
    try:
        cfg = cli.config_from_args(cli.build_parser().parse_args(args))
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rec = cli.run_greedy(cfg, 1, dev)[0]
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
    finally:
        acq.greedy_select = orig
    launches = _counts()
    spec, p = seen["spec"], seen["params"]
    x = seen["X"].cpu().numpy().astype(np.float64)
    job = (str(Path(oracle.__file__).resolve()), dataclasses.asdict(spec), x,
           np.exp(p.log_ls_spatial.cpu().numpy().astype(np.float64)),
           np.exp(p.log_ls_feature.cpu().numpy().astype(np.float64)),
           float(torch.exp(p.log_outputscale)), float(seen["nv"][0]),
           cfg.acquisition.rounds, seen["pilot"].cpu().numpy())
    out = dict(rec=rec, selected=seen["selected"], run_ms=run_ms, X_dim=int(x.shape[1]),
               select_ms=seen["select_ms"], launches=launches)
    out["oracle_future"] = pool.apply_async(oracle_greedy_mi_scores, job)
    return out


def phase_greedy_c2(dev, oracle, card: str, main_ms: float, tag: str, args: list,
                    workload: str, pool) -> dict:
    """12d / 14d: c2_composite_restarts' greedy MI on the 100 × 100 field
    with 3 features (the composite Gram at 10 000², the exact seed, 50
    rounds on the wtw kernel), counted from 0; 14d with the deep kernel,
    over the embedded d = 2 + 4.  The f64 oracle runs in `pool`: the
    returned `finish` waits for it, holds the selections against it and
    prints the phase's line."""
    torch.cuda.synchronize()
    _zero_counts()
    out = greedy_vs_oracle(dev, oracle, args, pool)
    sel, rec, launches = out["selected"], out["rec"], out["launches"]
    if not np.isfinite([rec["final_rmse"], rec["final_rmse_test"]]).all():
        raise AssertionError(f"{tag}: non-finite RMSE {rec}")
    if launches["wtw_column"] != 50 or launches["gram"] < 3 or launches["cholesky"]:
        raise AssertionError(f"{tag} launches: {launches}")

    def finish():
        ref, _, oracle_s = out["oracle_future"].get()
        if not np.array_equal(sel, ref):
            first = int(np.flatnonzero(sel != ref)[0])
            raise AssertionError(f"{tag} selections differ from the f64 oracle from round "
                                 f"{first}: {sel[first:first + 5]} vs {ref[first:first + 5]}")
        emit(tag, workload=workload, run_ms=out["run_ms"],
             greedy_select_ms=out["select_ms"], candidate_dim=out["X_dim"],
             main_path_median_ms=main_ms, rmse_final=rec["final_rmse"],
             rmse_test_final=rec["final_rmse_test"], launches=launches,
             first_selected=sel[:10].tolist(),
             fidelity=f"50/50 equal to the f64 oracle ({oracle_s:.1f} s of host numpy "
             "in a worker process)", card=card)

    return {"launches": launches, "finish": finish}


def phase_chol(dev, main_run, episode_run, card: str) -> dict:
    """The Cholesky kernel on the seed matrices of the paths.  The seed
    path — factor each seed with the kernel, then serve the main path's
    50 (WᵀW) columns from W = L⁻¹ — runs with the counts zeroed; the
    comparisons and timings come after it and do not count."""
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch.ops import chol as C
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops import linalg as la
    from algp_tpu_torch.ops import updates as U
    from algp_tpu_torch.ops.kernels import KernelSpec

    rng = np.random.default_rng(1)
    spec = KernelSpec("rbf", ds=2)
    p = spec.init_params(ls_spatial=2.5, outputscale=1.0, noise=0.1, device=dev)
    x997 = torch.tensor(rng.uniform(0, 20, (997, 2)), dtype=torch.float32, device=dev)
    r, c = np.divmod(np.arange(GRID * GRID), GRID)
    grid = torch.tensor(np.stack([c, r], 1), dtype=torch.float32, device=dev)
    # the episode's seed at its final params, and the main path's (as
    # fit_and_select builds it: padded sentinels keep nv = 1)
    seeds = {
        "ragged_997": G.gram_kernel_with_noise(spec, p, x997),
        "episode_10000": acq.seed_matrix(KernelSpec("matern32", ds=2),
                                         episode_run["params"], grid),
    }
    mp = main_run["params"]
    xm = main_grid(dev)
    nv_base = torch.clamp_min(mp.noise_var, main_run["min_noise"] ** 2)
    nvm = torch.where(torch.arange(xm.shape[0], device=dev) < GRID * GRID, nv_base, 1.0)
    seeds["main_10240"] = G.gram_kernel_with_noise(spec, mp, xm, nvm / mp.noise_var)
    selected = torch.tensor(main_run["selected"], device=dev)

    # the seed path
    torch.cuda.synchronize()
    _zero_counts()
    hand = {k: C.cholesky(K) for k, K in seeds.items()}
    W_h = la.tri_inv(hand["main_10240"])
    u_h = torch.stack([U.wtw_column(W_h, j) for j in selected])
    torch.cuda.synchronize()
    launches = _counts()
    if launches["cholesky"] != len(seeds) or launches["wtw_column"] != len(selected):
        raise AssertionError(f"seed path launches: {launches}")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    cases, worst = {}, 0.0
    for k, K in seeds.items():
        Lh, Lp = hand[k], C.cholesky_reference(K)
        K64 = K.double()
        L64 = torch.linalg.cholesky(K64)
        res = {}
        for tag, L in (("hand", Lh), ("cusolver", Lp)):
            L = L.double()
            res[f"residual_{tag}"] = rel(L @ L.T, K64)
            res[f"err_vs_f64_{tag}"] = rel(L, L64)
        diff = float((Lh - Lp).abs().max())
        res["max_abs_diff_hand_vs_plain"] = diff
        worst = max(worst, diff)
        if not np.isfinite(list(res.values())).all():
            raise AssertionError(f"chol {k}: non-finite {res}")
        # tolerances: the hand factor is no worse than 4× cuSOLVER's f32
        # factor, in residual and against the f64 factor (plus a floor at
        # f32 resolution)
        if not res["residual_hand"] <= 4 * res["residual_cusolver"] + 1e-7:
            raise AssertionError(f"chol {k}: residual {res}")
        if not res["err_vs_f64_hand"] <= 4 * res["err_vs_f64_cusolver"] + 1e-6:
            raise AssertionError(f"chol {k}: error vs f64 {res}")
        if not diff <= (5 * res["err_vs_f64_cusolver"] + 1e-6) * float(L64.abs().max()):
            raise AssertionError(f"chol {k}: hand vs plain {res}")
        cases[k] = res
        del K64, L64

    # the factor serves the seed: W = L⁻¹ columns at the main path's picks
    K = seeds["main_10240"]
    W_c = la.tri_inv(C.cholesky_reference(K))
    W64 = la.tri_inv(torch.linalg.cholesky(K.double()))
    u_c = torch.stack([U.wtw_column_reference(W_c, j) for j in selected])
    u64 = torch.stack([U.wtw_column_reference(W64, j) for j in selected])
    seed = {"rel_hand_vs_cusolver": rel(u_h, u_c),
            "rel_cusolver_vs_f64": rel(u_c.double(), u64),
            "rel_hand_vs_f64": rel(u_h.double(), u64)}
    seed_tol = 4 * seed["rel_cusolver_vs_f64"] + 1e-4
    if not seed["rel_hand_vs_cusolver"] <= seed_tol:
        raise AssertionError(f"seed columns from the hand factor: {seed}")
    del W_c, W64, W_h

    # a non-SPD input: NaN from the failing column on, finite before it
    Kbad = seeds["ragged_997"].clone()
    Kbad[500, 500] = -1.0
    Lbad = C.cholesky(Kbad)
    low = torch.tril(torch.ones_like(Lbad, dtype=torch.bool))
    if not (torch.isnan(Lbad[:, 500:])[low[:, 500:]].all()
            and torch.isfinite(Lbad[:, :500]).all()
            and torch.isnan(C.cholesky_reference(Kbad)).any()):
        raise AssertionError("non-SPD input: the factor is not NaN from column 500 on")

    # the seed comparison: the main path's 50 MI selections at its fitted
    # params, seeded by the hand factor, by cuSOLVER, and by an f64 factor
    # rounded to f32; where two differ, the scores of the two picks at the
    # first round that differs, under each seed
    nv = torch.full((GRID * GRID,), float(torch.exp(2 * mp.log_noise)), device=dev)
    runs, orig = {}, acq._seed_factor
    for tag, factor in (("hand", lambda K: C.nan_if_failed(C.cholesky(K))),
                        ("cusolver", la.cholesky),
                        ("f64", lambda K: torch.linalg.cholesky(K.double()).float())):
        acq._seed_factor = factor
        try:
            res = acq.greedy_select(spec, mp, main_run["env"].X, nv, main_run["pilot_j"],
                                    rounds=50, num_pilot=32, strategy="mi",
                                    return_scores=True)
        finally:
            acq._seed_factor = orig
        runs[tag] = (res.selected.cpu().numpy(), res.scores.cpu().double().numpy())
    parting = {}
    for a_, b_ in (("hand", "cusolver"), ("hand", "f64"), ("cusolver", "f64")):
        diff = np.flatnonzero(runs[a_][0] != runs[b_][0])
        if not len(diff):
            parting[f"{a_}_vs_{b_}"] = "50/50 equal"
            continue
        r = int(diff[0])
        i, j = int(runs[a_][0][r]), int(runs[b_][0][r])
        parting[f"{a_}_vs_{b_}"] = {
            "first_differing_round": r, "picks": [i, j],
            "scores": {t: [float(q[r][i]), float(q[r][j])] for t, (_, q) in runs.items()},
            "rel_gap_of_picks": {t: float((q[r][i] - q[r][j]) / abs(q[r][i]))
                                 for t, (_, q) in runs.items()}}
    seed_uses_kernel = acq._seed_factor is not la.cholesky
    emit("chol_seed", seed_uses_kernel=seed_uses_kernel, selections=parting)
    if seed_uses_kernel and parting["hand_vs_cusolver"] != "50/50 equal":
        raise AssertionError(f"the seed uses the Cholesky kernel, but its 50 MI "
                             f"selections differ from cuSOLVER-seeded ones: {parting}")

    # times in turns (library, kernel, kernel, library), the profiler's
    # split of one factorization, the wrapper's pad and copy at ragged n
    tool = load_module("chol_profile", ROOT / "tools" / "chol_profile.py")
    times = {}
    for k in ("episode_10000", "main_10240"):
        K = seeds[k]
        n = K.shape[0]
        t = tool.turns(lambda: C.cholesky(K), lambda: torch.linalg.cholesky(K))
        t["plain_ms"] = cuda_ms(lambda: C.cholesky_reference(K), 5)
        split = tool.split(lambda: C.cholesky(K))
        t["split"] = split
        t["kernel_launches_per_factor"] = sum(
            v["count"] for name, v in split["by_kernel"].items() if "chol_" in name)
        t["bound_ms"], _ = bound(2 * 4 * n * n, n ** 3 / 3)
        t["tflops"] = n ** 3 / 3 / (t["ms"] * 1e-3) / 1e12
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        N = -(-n // 128) * 128

        def pad_and_copy():
            A = torch.empty((N, N), device=dev)
            A[:n, :n] = K
            A[n:].zero_()
            A[n:, n:].diagonal().fill_(1.0)
            return A[:n, :n].contiguous()

        t["pad_and_copy_ms"] = cuda_ms(pad_and_copy, 5) if N != n else 0.0
        times[k] = t
    emit("chol", cases=cases, tol={
        "residual": "max|LL^T-K|/max|K| <= 4*cusolver + 1e-7",
        "err_vs_f64": "max|L-L64|/max|L64| <= 4*cusolver + 1e-6",
        "hand_vs_plain": "max|L-Lplain| <= (5*cusolver_err_vs_f64 + 1e-6)*max|L64|",
        "seed_columns": f"rel <= 4*rel_cusolver_vs_f64 + 1e-4 = {seed_tol:.3g}"},
        seed_columns=seed, nan_case="NaN from column 500 on, finite before",
        seed_uses_kernel=seed_uses_kernel,
        times=times, seed_path_launches=launches, card=card)
    t = times["main_10240"]
    return {"launches": launches, "max_abs_err": worst, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": "operations",
            "library_ms": t["library_ms"]}


# ---------------------------------------------------------------------------
# Phase 15: the mesh paths (algp_tpu_torch.parallel), every rank on card 0
# ---------------------------------------------------------------------------

MESH_ROUNDS = 50
MESH_REPS = 3  # timed runs after the counted warm-up
MESH_EPISODE_STEPS = 8  # 15g / 15h: the pilot fit, refits at steps 4 and 8
LAUNCH_KEYS = ("gram", "wtw_column", "cholesky", "gram_composite")


def _mesh_timed(fn) -> tuple:
    """(the counted first run's result, its launch counts, the ms of
    MESH_REPS more runs, peak bytes): every run starts behind a barrier of
    the world and ends in a host read of its result."""
    import torch.distributed as dist

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out = fn()
    launches = np.asarray([_counts()[k] for k in LAUNCH_KEYS])
    times = []
    for _ in range(MESH_REPS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, launches, np.asarray(times), torch.cuda.max_memory_allocated()


def mesh_rank(job: str, restarts_axis: int, data: dict) -> dict:
    """Phase 15's work on one rank of a world started by
    `algp_tpu_torch.parallel.launch` (this module is imported in every
    rank; nothing here runs at import)."""
    from algp_tpu_torch.config import FitConfig
    from algp_tpu_torch.convert import icm_params_from_numpy, kernel_params_from_numpy
    from algp_tpu_torch.ops.kernels import KernelSpec
    from algp_tpu_torch.parallel import sharded, sharded_lowrank, sharded_mi

    mesh = sharded.make_mesh(restarts_axis=restarts_axis)
    dev = torch.device("cuda", torch.cuda.current_device())
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt, device=dev)
    spec = KernelSpec(data["kind"], ds=2)
    out = {}

    def record(tag, launches, times, peak):
        out.update({f"{tag}/launches": launches, f"{tag}/ms": times, f"{tag}/peak": peak})

    if job == "episode":
        out.update(mesh_episode_rank(mesh, dev, data))
    elif job == "main":
        cfg = FitConfig(**data["cfg"])
        inits = kernel_params_from_numpy(data["inits"], dev)
        x, xp, yp, pilot = t(data["x"]), t(data["x_pilot"]), t(data["y_pilot"]), t(
            data["pilot"], torch.int64)
        nv = torch.full((x.shape[0],), float(data["nv"]), device=dev)
        for strategy in ("mi", "entropy"):
            def run():
                p, nlls, sel, _ = sharded.sharded_training_step(
                    mesh, spec, cfg, xp, yp, x, nv, pilot, rounds=MESH_ROUNDS,
                    strategy=strategy, inits=inits)
                return p, nlls, sel.cpu().numpy()

            (p, nlls, sel), *rest = _mesh_timed(run)
            record(strategy, *rest)
            out.update({f"{strategy}/selected": sel, f"{strategy}/all_nlls": nlls.cpu().numpy(),
                        **{f"{strategy}/p_{k}": v.cpu().numpy()
                           for k, v in dataclasses.asdict(p).items()}})
    elif job in ("dist_seed", "lowrank"):
        params = kernel_params_from_numpy(data["params"], dev)
        x, pilot = t(data["x"]), t(data["pilot"], torch.int64)
        nv = torch.full((x.shape[0],), float(data["nv"]), device=dev)
        kw = dict(rounds=MESH_ROUNDS, num_pilot=len(data["pilot"]))
        if job == "dist_seed":
            run = lambda: sharded_mi.sharded_greedy_select_mi(
                mesh, spec, params, x, nv, pilot, distributed_seed=True, **kw)
        else:
            z = t(data["z"])
            run = lambda: sharded_lowrank.sharded_greedy_select_mi_lowrank(
                mesh, spec, params, x, nv, pilot, z, **kw)
        def read():
            res = run()
            res.selected.cpu()
            return res

        res, *rest = _mesh_timed(read)
        record(job, *rest)
        out.update({f"{job}/selected": res.selected.cpu().numpy(),
                    **{f"{job}/strip_{k}": np.asarray(v) for k, v in res.strips.items()}})
    elif job == "icm":
        cfg = FitConfig(**data["cfg"])
        inits = icm_params_from_numpy(data["inits"], dev)
        x, Y, obs = t(data["x"]), t(data["Y"]), t(data["obs"], torch.bool)
        def fit_icm():
            fit = sharded.sharded_fit_icm(mesh, spec, cfg, x, Y, obs, inits=inits)
            fit.nll.cpu()
            return fit

        fit, *rest = _mesh_timed(fit_icm)
        record(job, *rest)
        out.update({"icm/all_nlls": fit.all_nlls.cpu().numpy(), "icm/nll": fit.nll.cpu().numpy()})
    else:
        raise ValueError(job)
    return out


def mesh_episode_rank(mesh, dev, data: dict) -> dict:
    """15g / 15h on one rank: the mesh Agent on the parent's env for
    `max_steps` steps, the counts zeroed just before; each fit's
    parameters recorded, so that the parent holds the ranks to one fit."""
    from algp_tpu_torch.convert import field_env_from_attrs, kernel_params_to_numpy
    from algp_tpu_torch.episode import Agent

    agent = Agent(field_env_from_attrs(data["env"], dev), data["cfg"], mesh=mesh)
    fits, fit_model = [], agent.fit_model

    def fit(st, lagged=False):
        res = fit_model(st, lagged)
        fits.append(np.concatenate([np.ravel(v) for v in
                                    kernel_params_to_numpy(res.params).values()]))
        return res

    agent.fit_model = fit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res = agent.run(max_steps=data["max_steps"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = np.asarray([_counts()[k] for k in LAUNCH_KEYS])
    seed = (agent._P_cache[1] if agent._P_cache is not None else agent._lr_cache[1].VT)
    records = [h for h in res.history if h["phase"] in ("pilot", "plan")]
    return {"episode/selected": res.state.sampled_idx, "episode/fit_params": np.stack(fits),
            "episode/launches": launches, "episode/peak": torch.cuda.max_memory_allocated(),
            "episode/wall_s": wall, "episode/strip": np.asarray(seed.shape),
            "episode/steps": np.asarray([h["step"] for h in records]),
            "episode/t_wall": np.asarray([h["t_wall"] for h in records]),
            "episode/plan_s": np.asarray([h.get("plan_s", np.nan) for h in records]),
            "episode/rmse_test": np.asarray([h["rmse_test"] for h in records])}


def _mesh_run(job: str, world: int, restarts_axis: int, data: dict) -> tuple:
    """The job on a gloo world of `world` ranks sharing card 0: (rank
    outputs, seconds of the call, start-up included)."""
    from algp_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    outs = launch.run(f"{Path(__file__).resolve()}:mesh_rank", world, backend="gloo",
                      device="cuda", timeout=600,
                      kwargs={"job": job, "restarts_axis": restarts_axis, "data": data})
    for key in outs[0]:
        if key.endswith(("/selected", "nlls", "/fit_params")):
            for o in outs[1:]:
                if not np.array_equal(o[key], outs[0][key]):
                    raise AssertionError(f"mesh {job}: ranks disagree on {key}")
    return outs, time.perf_counter() - t0


def _rank_stats(outs, tag: str, world: int, card: str) -> dict:
    """The line's common fields: the world, rank 0's ms, each rank's peak,
    and the launches summed over the ranks (the counted run)."""
    launches = sum(o[f"{tag}/launches"] for o in outs)
    ms = outs[0][f"{tag}/ms"]
    return {"backend": "gloo", "world": world, "ranks_per_card": world,
            "median_ms": float(np.median(ms)), "reps_ms": ms.tolist(),
            "peak_mem_GB_by_rank": [round(float(o[f"{tag}/peak"]) / 1e9, 3) for o in outs],
            "launches": dict(zip(LAUNCH_KEYS, launches.tolist())),
            "timing": f"{world} ranks sharing one card through gloo, not a multi-card figure",
            "card": card}


def _check_launches(outs, tag: str, want: dict) -> None:
    """Each rank's counted run launched `want[kernel]` times (others 0)."""
    for r, o in enumerate(outs):
        got = dict(zip(LAUNCH_KEYS, o[f"{tag}/launches"].tolist()))
        if any(got[k] != want.get(k, 0) for k in LAUNCH_KEYS):
            raise AssertionError(f"mesh {tag}, rank {r}: launches {got}, expected {want}")


def tie_rule(what: str, sel, ref, scores_at) -> dict:
    """Equal, or parting first at a round where the reference scores the
    pick of `sel` within 1e-5 relative of its own (the main field's
    near-ties, phase 10); any other parting fails."""
    sel, ref = np.asarray(sel), np.asarray(ref)
    if np.array_equal(sel, ref):
        return {"equal": True}
    r = int(np.flatnonzero(sel != ref)[0])
    s = np.asarray(scores_at(r), np.float64)
    top, other = s[ref[r]], s[sel[r]]
    rel = float((top - other) / abs(top))
    if not rel <= 1e-5:
        raise AssertionError(f"{what}: parts from the reference at round {r}: "
                             f"{sel[r:r + 5]} vs {ref[r:r + 5]}, scores {top} vs {other}")
    return {"equal": False, "parted_at_round": r, "picks": [int(sel[r]), int(ref[r])],
            "reference_scores": [float(top), float(other)], "rel": rel}


def mesh_reference(dev, main_run) -> dict:
    """The single-rank run the mesh phases are held to: the main path's
    `fit_and_select` (MI) from restart inits drawn from seed 0, its NLL,
    fitted params and nv, and the f64 oracle's job on them."""
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch.config import FitConfig
    from algp_tpu_torch.convert import kernel_params_to_numpy
    from algp_tpu_torch.models import gp
    from algp_tpu_torch.ops.kernels import KernelSpec

    spec = KernelSpec("rbf", ds=2)
    cfg = FitConfig(iters=100, restarts=4)
    env, pilot = main_run["env"], main_run["pilot_j"]
    inits = gp.make_restart_inits(spec, cfg, torch.Generator(device=dev).manual_seed(0))
    fit, sel = acq.fit_and_select(spec, cfg, main_run["x_pilot"], main_run["y_pilot"], env.X,
                                  pilot, rounds=MESH_ROUNDS, num_pilot=len(pilot),
                                  strategy="mi", inits=inits)
    p = fit.params
    nv = max(float(torch.exp(2 * p.log_noise)), cfg.min_noise ** 2)
    x64 = env.X.cpu().numpy().astype(np.float64)
    oracle_job = (str(ROOT / "tests" / "oracle.py"), dataclasses.asdict(spec), x64,
                  np.exp(p.log_ls_spatial.cpu().numpy().astype(np.float64)),
                  np.exp(p.log_ls_feature.cpu().numpy().astype(np.float64)),
                  float(torch.exp(p.log_outputscale)), nv, MESH_ROUNDS, pilot.cpu().numpy())
    return {"spec": spec, "cfg": cfg, "nll": float(fit.nll), "nv": nv, "env": env,
            "params_np": kernel_params_to_numpy(p), "oracle_job": oracle_job,
            "selected": sel.selected.cpu().numpy(), "inits": kernel_params_to_numpy(inits),
            "x": env.X.cpu().numpy(), "x_pilot": main_run["x_pilot"].cpu().numpy(),
            "y_pilot": main_run["y_pilot"].cpu().numpy(), "pilot": pilot.cpu().numpy()}


def _single_rank(dev, ref: dict, params_np: dict, strategy: str) -> tuple:
    """Single-rank `greedy_select` on the main field with the given params
    and the reference's nv: (selections, (rounds, N) scores)."""
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch.convert import kernel_params_from_numpy

    env = ref["env"]
    r = acq.greedy_select(ref["spec"], kernel_params_from_numpy(params_np, dev), env.X,
                          torch.full((env.n,), ref["nv"], device=dev),
                          torch.tensor(ref["pilot"], device=dev), rounds=MESH_ROUNDS,
                          num_pilot=len(ref["pilot"]), strategy=strategy, return_scores=True)
    return r.selected.cpu().numpy(), r.scores.cpu().numpy()


def phase_mesh_dryrun(card: str) -> None:
    """15a: the dry run on a world of 1 (NCCL) and of 4 (gloo), on card 0."""
    from algp_tpu_torch.parallel.dryrun import dryrun_multichip

    worlds = []
    for world, backend in ((1, "nccl"), (4, "gloo")):
        t0 = time.perf_counter()
        rec = dryrun_multichip(world, backend=backend, device="cuda")
        line = {"backend": backend, "world": world, "ranks_per_card": world,
                "seconds": round(time.perf_counter() - t0, 3),
                "mi_selected": rec["mi_selected"].tolist(),
                "icm_nlls": rec["icm_nlls"].tolist(),
                "episode_sites": {k[len("episode_"):-len("_sites")]: len(v)
                                  for k, v in rec.items() if k.endswith("_sites")}}
        if len(line["episode_sites"]) != 5:
            raise AssertionError(f"dry-run episode blocks: {sorted(line['episode_sites'])}")
        if backend == "nccl":
            syncs = rec["loop_syncs"].tolist()
            if len(syncs) != 4 or any(syncs):  # the four sharded greedy loops
                raise AssertionError(f"device->host syncs in the NCCL world's loops: {syncs}")
            reads = rec["plan_reads"].tolist()
            if not reads or any(r != 1 for r in reads):
                raise AssertionError(f"mesh episode reads per plan call: {reads}")
            line.update(loop_syncs=syncs, mesh_episode_reads_per_plan=reads)
        worlds.append(line)
    emit("mesh_dryrun", worlds=worlds, checks="selections = single rank (entropy, MI, "
         "distributed seed, low-rank); ICM NLLs within 1e-4; the 5 mesh episodes' sites = "
         "single rank, trait RMSE within 1e-5", card=card)


def phase_mesh_main(dev, ref: dict, oracle_ref, card: str, oracle_s: float) -> dict:
    """15b: bench.py's workload through `sharded_training_step` on a 2 × 2
    world, MI and entropy, from `mesh_reference`'s restart inits: the
    winning NLL against that run's, the selections against the single-rank
    `greedy_select` on the mesh's fitted params, MI against the f64 oracle
    (on the single-rank params)."""
    data = {"kind": "rbf", "cfg": dataclasses.asdict(ref["cfg"]), "inits": ref["inits"],
            "x": ref["x"], "x_pilot": ref["x_pilot"], "y_pilot": ref["y_pilot"],
            "pilot": ref["pilot"], "nv": ref["nv"]}
    outs, secs = _mesh_run("main", 4, 2, data)
    # MI: the pilots' cross-Gram and the replicated seed's Gram, a strip
    # column a round; entropy: the pilots' (32, N/2) cross-Gram
    _check_launches(outs, "mi", {"gram": 2, "wtw_column": MESH_ROUNDS})
    _check_launches(outs, "entropy", {"gram": 1})
    o, lines, launches = outs[0], {}, {}
    for strategy in ("mi", "entropy"):
        nll = float(np.min(o[f"{strategy}/all_nlls"]))
        if not abs(nll - ref["nll"]) <= 1e-4 * abs(ref["nll"]):
            raise AssertionError(f"mesh {strategy}: winning NLL {nll} vs single rank "
                                 f"{ref['nll']}")
        params = {k: o[f"{strategy}/p_{k}"] for k in ref["params_np"]}
        want, scores = _single_rank(dev, ref, params, strategy)
        sel = o[f"{strategy}/selected"]
        lines[strategy] = {"vs_single_rank": tie_rule(f"mesh {strategy}", sel, want,
                                                      lambda r: scores[r]),
                           "nll": nll, "nll_single_rank": ref["nll"],
                           "params_max_abs_diff": max(
                               float(np.abs(params[k] - v).max())
                               for k, v in ref["params_np"].items() if v.size),
                           "first_selected": sel[:10].tolist(),
                           **_rank_stats(outs, strategy, 4, card)}
        launches[strategy] = lines[strategy]["launches"]
    o_sel, traces = oracle_ref
    lines["mi"]["vs_f64_oracle"] = tie_rule("mesh mi vs the oracle", o["mi/selected"], o_sel,
                                            lambda r: traces[r])
    emit("mesh_main", workload="sharded_training_step on 2 x 2: 100x100 rbf ls 8, 32 pilots, "
         "adam 4x100 (2 restarts a rank), 50 rounds", call_seconds=round(secs, 3),
         oracle_seconds=round(oracle_s, 1), **lines)
    return {"launches": {k: launches["mi"][k] + launches["entropy"][k] for k in LAUNCH_KEYS},
            "mi_selected": o["mi/selected"]}


def phase_mesh_dist_seed(dev, ref: dict, oracle_ref, card: str, rep_selected) -> dict:
    """15c: MI on a 1 × 4 world with the distributed seed, on 15b's field
    with `mesh_reference`'s params and nv: against the f64 oracle, and
    where it parts from the replicated seed of 15b (single-rank scores)."""
    data = {"kind": "rbf", "params": ref["params_np"], "x": ref["x"], "pilot": ref["pilot"],
            "nv": ref["nv"]}
    outs, secs = _mesh_run("dist_seed", 4, 1, data)
    # the (N/4, N) seed strip and the pilots' cross-Gram; a strip column a round
    _check_launches(outs, "dist_seed", {"gram": 2, "wtw_column": MESH_ROUNDS})
    sel = outs[0]["dist_seed/selected"]
    _, rep_scores = _single_rank(dev, ref, ref["params_np"], "mi")
    o_sel, traces = oracle_ref
    n_pad = -(-len(ref["x"]) // 512) * 512
    strips = [tuple(o["dist_seed/strip_W"].tolist()) for o in outs]
    if any(s != (n_pad // 4, n_pad) for s in strips):
        raise AssertionError(f"W strips {strips}, not ({n_pad // 4}, {n_pad})")
    stats = _rank_stats(outs, "dist_seed", 4, card)
    emit("mesh_dist_seed", workload="MI on 1 x 4, distributed seed: 15b's field, params, nv",
         vs_f64_oracle=tie_rule("distributed seed vs the oracle", sel, o_sel,
                                lambda r: traces[r]),
         vs_replicated_seed=tie_rule("distributed seed vs the replicated", sel, rep_selected,
                                     lambda r: rep_scores[r]),
         W_strip_by_rank=strips, call_seconds=round(secs, 3),
         first_selected=sel[:10].tolist(), **stats)
    return {"launches": stats["launches"], "selected": sel}


def phase_mesh_lowrank(dev, card: str) -> dict:
    """15d: phase 9b's workload (N = 102 400, M = 1 024) on a 1 × 4 world,
    held against the single-rank `greedy_select_lowrank`."""
    from algp_tpu_torch import acquisition_lowrank as lr
    from algp_tpu_torch.config import FitConfig
    from algp_tpu_torch.convert import kernel_params_to_numpy
    from algp_tpu_torch.ops.kernels import KernelSpec

    spec = KernelSpec("matern32", ds=2)
    cfg = FitConfig(iters=60, restarts=4)
    x_np, pilot_np, y_np = lowrank_workload(LOWRANK_GRID, 64)
    x = torch.tensor(x_np, device=dev)
    pilot = torch.tensor(pilot_np, device=dev)
    fit, _ = lr.fit_and_select_lowrank(
        spec, cfg, x.index_select(0, pilot), torch.tensor(y_np, device=dev), x, pilot,
        rounds=1, num_pilot=64, num_inducing=LOWRANK_M,
        generator=torch.Generator(device=dev).manual_seed(0))
    p = fit.params
    nv = max(float(p.noise_var), cfg.min_noise ** 2)
    z = x.index_select(0, lr.kcenter_indices(x, LOWRANK_M))
    want = lr.greedy_select_lowrank(spec, p, x, torch.full((len(x_np),), nv, device=dev),
                                    pilot, z, rounds=MESH_ROUNDS, num_pilot=64,
                                    return_scores=True)
    want_sel, scores = want.selected.cpu().numpy(), want.scores.cpu().numpy()
    data = {"kind": "matern32", "params": kernel_params_to_numpy(p), "x": x_np,
            "pilot": pilot_np, "nv": nv, "z": z.cpu().numpy()}
    del x, z, want
    torch.cuda.empty_cache()
    outs, secs = _mesh_run("lowrank", 4, 1, data)
    _check_launches(outs, "lowrank", {"gram": 2})  # K(z, x_loc), the pilots' cross-Gram
    sel = outs[0]["lowrank/selected"]
    strips = [tuple(o["lowrank/strip_VT"].tolist()) for o in outs]
    n_pad = -(-len(x_np) // 512) * 512
    if any(s != (n_pad // 4, LOWRANK_M) for s in strips):
        raise AssertionError(f"VT strips {strips}, not ({n_pad // 4}, {LOWRANK_M})")
    stats = _rank_stats(outs, "lowrank", 4, card)
    emit("mesh_lowrank", workload=f"low-rank MI on 1 x 4: {LOWRANK_GRID}x{LOWRANK_GRID} "
         f"jittered matern32, M={LOWRANK_M}, 64 pilots, 50 rounds (9b's fitted params)",
         vs_single_rank=tie_rule("mesh low-rank", sel, want_sel, lambda r: scores[r]),
         VT_strip_by_rank=strips, call_seconds=round(secs, 3),
         first_selected=sel[:10].tolist(), **stats)
    return {"launches": stats["launches"]}


def phase_mesh_icm(dev, card: str) -> dict:
    """15e: `sharded_fit_icm` at 14a's end-of-episode size (234 plots, 3
    traits, a quarter of traits 1-2 observed, 4 restarts of 150 steps) on a
    2 × 1 world, from the single-rank `fit_icm`'s inits."""
    from algp_tpu_torch.config import FitConfig
    from algp_tpu_torch.models import coregional as icm
    from algp_tpu_torch.ops.kernels import KernelSpec

    spec = KernelSpec("matern32", ds=2)
    cfg = FitConfig(iters=150, restarts=4)
    rng = np.random.default_rng(14)
    n = 234
    x = rng.integers(0, 100, (n, 2)).astype(np.float32)
    f = np.sin(0.08 * x[:, 0]) * np.cos(0.06 * x[:, 1])
    Y = np.stack([f, 0.8 * f + 0.6 * np.cos(0.05 * x[:, 0]), 0.8 * f - 0.3], 1)
    Y = (Y + 0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    obs = rng.uniform(size=(n, 3)) < 0.25
    obs[:, 0] = True
    inits = icm.make_icm_inits(spec, cfg, 3, 1, torch.Generator(device=dev).manual_seed(0))
    t = lambda a: torch.tensor(a, device=dev)
    single = icm.fit_icm(spec, cfg, t(x), t(Y), t(obs), inits=inits)
    to_np = lambda p: {k: (to_np(v) if isinstance(v, dict) else v.cpu().numpy())
                       for k, v in p.items()}
    data = {"kind": "matern32", "cfg": dataclasses.asdict(cfg), "x": x, "Y": Y, "obs": obs,
            "inits": to_np(dataclasses.asdict(inits))}
    outs, secs = _mesh_run("icm", 2, 2, data)
    _check_launches(outs, "icm", {})  # the fit's Grams are the plain small ones
    got, want = outs[0]["icm/all_nlls"], single.all_nlls.cpu().numpy()
    best, best_1 = float(outs[0]["icm/nll"]), float(single.nll)
    if not (np.all(np.abs(got - want) <= 1e-4 * np.abs(want))
            and abs(best - best_1) <= 1e-4 * abs(best_1)):
        raise AssertionError(f"mesh ICM NLLs {got} (best {best}) vs single rank {want} "
                             f"(best {best_1})")
    stats = _rank_stats(outs, "icm", 2, card)
    emit("mesh_icm", workload="sharded_fit_icm on 2 x 1: 234 plots, 3 traits, matern32, "
         "adam 4x150 (2 restarts a rank)", all_nlls=got.tolist(), all_nlls_single=want.tolist(),
         nll=best, nll_single=best_1, call_seconds=round(secs, 3), **stats)
    return {"launches": stats["launches"]}


def _episode_times(steps, t_wall, refit_every: int) -> dict:
    """Plan ms (the median of the plan records' step walls that refit
    nothing) and refit-step ms (those that refit), from the logger's
    clock as `check_episode` reads it."""
    step_ms = {int(s): (b - a) * 1e3 for s, a, b in zip(steps[1:], t_wall[:-1], t_wall[1:])}
    refit = [v for k, v in step_ms.items() if k % refit_every == 0]
    other = [v for k, v in step_ms.items() if k % refit_every]
    return {"step_ms_median": float(np.median(other)) if other else None,
            "refit_step_ms_median": float(np.median(refit)) if refit else None,
            "step_ms": [round(v, 3) for v in step_ms.values()]}


def phase_mesh_episode(dev, card: str, tag: str, preset: str, world: int,
                       restarts_axis: int, strip) -> dict:
    """15g / 15h: `preset` through `episode.Agent(mesh=)` on a gloo world of
    `world` ranks sharing card 0, MESH_EPISODE_STEPS steps, against the
    single-rank Agent on the same env at the same cut: the same sites; each
    rank's seed strip `strip`; the Gram kernel launched on every rank."""
    from algp_tpu_torch.config import PRESETS
    from algp_tpu_torch.convert import field_env_attrs, field_env_like
    from algp_tpu_torch.episode import Agent
    from algp_tpu_torch.field import FieldEnv

    cfg = PRESETS[preset]
    env = FieldEnv(cfg.field, cfg.kernel, device=dev)
    attrs = field_env_attrs(env)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = Agent(field_env_like(env, dev), cfg).run(max_steps=MESH_EPISODE_STEPS)
    single_s = time.perf_counter() - t0
    want = single.state.sampled_idx
    single_plan = [h for h in single.history if h["phase"] in ("pilot", "plan")]
    single_times = _episode_times([h["step"] for h in single_plan],
                                  [h["t_wall"] for h in single_plan], cfg.episode.refit_every)
    del env, single
    torch.cuda.empty_cache()
    data = {"kind": cfg.kernel.spatial_kind, "cfg": cfg, "env": attrs,
            "max_steps": MESH_EPISODE_STEPS}
    outs, secs = _mesh_run("episode", world, restarts_axis, data)
    o = outs[0]
    got = o["episode/selected"]
    if not np.array_equal(got, want):
        n = min(len(got), len(want))
        r = int(np.argmax(np.append(got[:n] != want[:n], True)))
        raise AssertionError(f"mesh {tag}: sites part from the single rank's at {r}: "
                             f"{got[r:r + 10]} vs {want[r:r + 10]}")
    strips = [tuple(x["episode/strip"].tolist()) for x in outs]
    if any(s_ != tuple(strip) for s_ in strips):
        raise AssertionError(f"mesh {tag}: seed strips {strips}, not {tuple(strip)}")
    for r, x in enumerate(outs):
        got_l = dict(zip(LAUNCH_KEYS, x["episode/launches"].tolist()))
        if got_l["gram"] < 1 or got_l["cholesky"] or got_l["wtw_column"]:
            raise AssertionError(f"mesh {tag}, rank {r}: launches {got_l}")
    n_fits = len(o["episode/fit_params"])
    if n_fits < 3:
        raise AssertionError(f"mesh {tag}: {n_fits} fits, not the pilot's and two refits")
    launches = sum(x["episode/launches"] for x in outs)
    plan_ms = o["episode/plan_s"][1:] * 1e3
    line = {"workload": f"{preset} through Agent(mesh=) on {restarts_axis} x "
            f"{world // restarts_axis}, {MESH_EPISODE_STEPS} steps",
            "vs_single_rank": {"equal": True, "samples": int(len(got))},
            "fits": n_fits, "ranks_agree_on_fits": True,
            "seed_strip_by_rank": strips, "plan_ms_median": float(np.median(plan_ms)),
            **_episode_times(o["episode/steps"], o["episode/t_wall"], cfg.episode.refit_every),
            "episode_wall_s": float(o["episode/wall_s"]),
            "rmse_test_pilot": float(o["episode/rmse_test"][0]),
            "rmse_test_last": float(o["episode/rmse_test"][-1]),
            "single_rank": {"wall_s": round(single_s, 3), **single_times},
            "backend": "gloo", "world": world, "ranks_per_card": world,
            "peak_mem_GB_by_rank": [round(float(x["episode/peak"]) / 1e9, 3) for x in outs],
            "launches": dict(zip(LAUNCH_KEYS, launches.tolist())),
            "launches_by_rank": [dict(zip(LAUNCH_KEYS, x["episode/launches"].tolist()))
                                 for x in outs],
            "call_seconds": round(secs, 3),
            "timing": f"{world} ranks sharing one card through gloo, not a multi-card figure",
            "card": card}
    emit(tag, **line)
    return {"launches": line["launches"]}


def eps_optimal(what: str, pairs) -> dict:
    """Each round's pick within 1e-5 relative of the round's best score
    under the f64 oracle (15b's tie rule, at every round); else fails."""
    chosen, best = np.asarray(pairs, np.float64).T
    rel = (best - chosen) / np.abs(best)
    bad = np.flatnonzero(~(rel <= 1e-5))
    if bad.size:
        r = int(bad[0])
        raise AssertionError(f"{what}: round {r}'s pick scores {chosen[r]} under the f64 "
                             f"oracle, the round's best {best[r]}")
    return {"rounds": int(rel.size), "worst_rel": float(rel.max()),
            "rounds_below_best": int(np.count_nonzero(rel > 0))}


def phase_mesh(dev, card: str, ref: dict, oracle_future, pool) -> dict:
    """Phase 15, the mesh paths: 15a-15e, 15g and 15h in turn, then 15f, the
    f64 oracle's replay of 15b's MI and 15c's selections (in `pool`, while
    15c-15h run); returns each path's launches (summed over its ranks)."""
    torch.cuda.empty_cache()  # leave the card's memory to the ranks
    phase_mesh_dryrun(card)
    sel, traces, oracle_s = oracle_future.get()
    oracle_ref = (sel, traces)
    main = phase_mesh_main(dev, ref, oracle_ref, card, oracle_s)
    follow = {"mesh_main_mi": pool.apply_async(
        oracle_follow_mi, (*ref["oracle_job"], main["mi_selected"]))}
    dist_seed = phase_mesh_dist_seed(dev, ref, oracle_ref, card, main["mi_selected"])
    follow["mesh_dist_seed"] = pool.apply_async(
        oracle_follow_mi, (*ref["oracle_job"], dist_seed["selected"]))
    out = {"mesh_main": main["launches"], "mesh_dist_seed": dist_seed["launches"],
           "mesh_lowrank": phase_mesh_lowrank(dev, card)["launches"],
           "mesh_icm": phase_mesh_icm(dev, card)["launches"]}
    out["mesh_episode_exact"] = phase_mesh_episode(
        dev, card, "mesh_episode_exact", "c5_10k", 4, 2, (5120, 10240))["launches"]
    out["mesh_episode_lowrank"] = phase_mesh_episode(
        dev, card, "mesh_episode_lowrank", "c5_100k", 4, 1, (25600, 1024))["launches"]
    lines = {}
    for tag, fut in follow.items():
        pairs, secs = fut.get()
        lines[tag] = {**eps_optimal(f"{tag} under the f64 oracle", pairs),
                      "oracle_seconds": round(secs, 1)}
    emit("mesh_oracle_follow", check="every round's pick within 1e-5 relative of the "
         "round's best score, the f64 oracle following the mesh's picks", **lines, card=card)
    return out


# phase 16, the tools slice: c5_10k cut to a short budget (the trace stays
# small), the CLI's --profile-dir and --plots, utils.debug, the quickstart
# twin, and the reference's dense functions
TOOLS_ARGS = EPISODE_ARGS + ["--budget", "60"]
# the small run whose --plots must fail without matplotlib
TOOLS_SMALL_ARGS = ["--preset", "c5_episode", "--rows", "6", "--cols", "10", "--budget",
                    "20", "--num-pilot", "6", "--iters", "10"]
HAND_KERNELS = ("gram_kernel", "composite_kernel", "wtw_column_kernel", "chol_")
QUICKSTART_ARGS: list = []  # the example's command line (default: the card)


def _trace_kernels(trace_dir: Path) -> dict:
    """The one `*.pt.trace.json` under trace_dir: its size, kernel events and
    the hand kernels among them (count by kernel name)."""
    files = list(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"--profile-dir wrote {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    hand: dict = {}
    for k in kernels:
        tag = next((h for h in HAND_KERNELS if h in k), None)
        if tag is not None:
            hand[tag] = hand.get(tag, 0) + 1
    return {"trace_bytes": files[0].stat().st_size, "events": len(events),
            "kernel_events": len(kernels), "hand_kernels": hand,
            "hand_kernel_names": sorted({k[:80] for k in kernels
                                         if any(h in k for h in HAND_KERNELS)})}


def phase_tools_profile(dev, card: str) -> tuple:
    """16a: the cut c5_10k through the CLI untraced, then with --profile-dir:
    the summaries equal, the trace parses and its kernel events (CUPTI) hold
    the hand Gram kernel, launched through ctypes, by name.  Returns (the
    runs' launches, the untraced run with its agent at step 2)."""
    import tempfile

    from algp_tpu_torch import cli
    from algp_tpu_torch.ops import gram as G

    plain = run_episodes(dev, TOOLS_ARGS, "tools_episode", warm=False, capture_step=2)
    window = {}  # the Gram launches inside the traced region (not the truth's)
    orig_trace = cli.trace

    @contextlib.contextmanager
    def counted_trace(log_dir):
        with orig_trace(log_dir):
            g0 = G.LAUNCHES
            yield
            window["gram"] = G.LAUNCHES - g0

    cli.trace = counted_trace
    try:
        with tempfile.TemporaryDirectory(prefix="algp_trace_") as tmp:
            t0 = time.perf_counter()
            traced = run_episodes(dev, TOOLS_ARGS + ["--profile-dir", tmp],
                                  "tools_traced", warm=False)
            traced_s = time.perf_counter() - t0
            trace = _trace_kernels(Path(tmp))
    finally:
        cli.trace = orig_trace
    if traced["summary"] != plain["summary"]:
        raise AssertionError(f"--profile-dir changed the run: {traced['summary']} vs "
                             f"{plain['summary']}")
    if not np.isfinite([plain["summary"][k] for k in ("final_rmse", "final_rmse_test",
                                                      "mean_var")]).all():
        raise AssertionError(f"non-finite summary {plain['summary']}")
    # CUPTI records the kernels launched through the ctypes library (one
    # event a launch in calls so far; the profiler can drop device records
    # as outside its window late in a long process, so the count is
    # reported beside the launches, not held to them)
    if trace["hand_kernels"].get("gram_kernel", 0) < 1:
        raise AssertionError(f"the trace holds no hand Gram kernel: {trace}, "
                             f"{window['gram']} launches in the traced region")
    emit("tools_profile", workload="c5_10k --budget 60 via cli.main, untraced and "
         "with --profile-dir", steps=plain["summary"]["steps"], summary=plain["summary"],
         summaries_equal=True, untraced_s=plain["wall_s"], traced_s=traced_s, **trace,
         gram_launches_traced_region=window["gram"],
         gram_launches_traced_run=traced["launches"]["gram"], card=card)
    return {"tools_episode": plain["launches"], "tools_traced": traced["launches"]}, plain


def _blocked_plots(tmp: str) -> dict:
    """The CLI in a process where matplotlib cannot be imported: it must exit
    non-zero with utils.plotting's error."""
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "from algp_tpu_torch import cli\n"
            "sys.exit(cli.main(sys.argv[1:]))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, *TOOLS_SMALL_ARGS, "--plots", tmp],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    err = proc.stderr.strip().splitlines()
    if proc.returncode == 0 or not err or "--plots" not in err[-1]:
        raise AssertionError(f"--plots without matplotlib: exit {proc.returncode}, "
                             f"{proc.stderr[-2000:]}")
    return {"exit_code": proc.returncode, "error": err[-1][:200]}


def phase_tools_plots(dev, card: str) -> dict:
    """16b: the cut run with --plots: the PNGs exist and are not empty where
    matplotlib imports; in a process where it cannot (the card's machine,
    or one that blocks it) the CLI exits non-zero with the plotting error."""
    import importlib.util
    import tempfile

    have = importlib.util.find_spec("matplotlib") is not None
    out, launches = {"matplotlib": have}, {}
    with tempfile.TemporaryDirectory(prefix="algp_plots_") as tmp:
        if have:
            run = run_episodes(dev, TOOLS_ARGS + ["--plots", tmp], "tools_plots",
                               warm=False)
            sizes = {f.name: f.stat().st_size for f in sorted(Path(tmp).glob("*.png"))}
            if set(sizes) != {"maps_run0.png", "curves.png"} or min(sizes.values()) == 0:
                raise AssertionError(f"--plots wrote {sizes}")
            out.update(pngs=sizes, wall_s=run["wall_s"])
            launches["tools_plots"] = run["launches"]
        out["without_matplotlib"] = _blocked_plots(str(Path(tmp) / "blocked"))
    emit("tools_plots", **out, card=card)
    return launches


def phase_tools_debug(dev, main: dict, card: str) -> dict:
    """16c: utils.debug on the card: `checked` names a CUDA op that made a NaN
    and passes the Gram kernel's K + σ²I at the main path's 10 240;
    `assert_finite_tree` on the main path's seed; `fit_health_report` on
    phase 6's fit."""
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops.kernels import KernelSpec
    from algp_tpu_torch.utils import debug

    def f(x):
        y = torch.sqrt(x - 3.0)  # NaN below 3, mid-way
        return torch.exp(y).sum()

    _zero_counts()
    err, _ = debug.checked(f)(torch.arange(8.0, device=dev))
    try:
        err.throw()
        raise AssertionError("checked() let a NaN through")
    except FloatingPointError as e:
        if "aten.sqrt" not in str(e):
            raise AssertionError(f"checked() named the wrong op: {e}") from e
        nan_msg = str(e)
    spec, p, x = KernelSpec("rbf", ds=2), main["params"], main_grid(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    err, K = debug.checked(G.gram_kernel_with_noise)(spec, p, x)
    checked_s = time.perf_counter() - t0
    err.throw()
    del K
    W, WT = acq.implicit_precision_seed(spec, p, x, min_noise=main["min_noise"])
    debug.assert_finite_tree({"params": p, "seed": (W, WT)}, "main_seed")
    del W, WT
    report = debug.fit_health_report(main["fit"])
    if report["restarts"] != 4 or report["diverged_restarts"] != 0 \
            or not report["nll_improvement"] > 0:
        raise AssertionError(f"fit health {report}")
    launches = _counts()
    if launches["gram"] != 2:  # the checked K, the seed's K
        raise AssertionError(f"tools_debug launches {launches}")
    emit("tools_debug", nan_error=nan_msg, checked_gram_n=x.shape[0],
         checked_gram_s=checked_s, seed_finite=True, fit_health=report, card=card)
    return {"tools_debug": launches}


def phase_quickstart(card: str) -> dict:
    """16d: examples/quickstart_torch.py on the card, as a subprocess: every
    milestone prints, the resume is exact, section 9 runs a world of 2 whose
    sites equal the single rank's; the launches are its own process's (the
    ranks' are not counted)."""
    code = ("import json, runpy, sys\n"
            "sys.argv = sys.argv[1:]  # the example's own command line\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "from algp_tpu_torch.ops import chol as C, gram as G, updates as U\n"
            "print(json.dumps({'gram': G.LAUNCHES, 'wtw_column': U.LAUNCHES,\n"
            "                  'cholesky': C.LAUNCHES,\n"
            "                  'gram_composite': G.COMPOSITE_LAUNCHES}))\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code,
                           str(ROOT / "examples" / "quickstart_torch.py"), *QUICKSTART_ARGS],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"quickstart exit {proc.returncode}: {proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    launches, out = json.loads(lines[-1]), "\n".join(lines[:-1])
    for label in [str(i) for i in range(1, 17) if i not in (3, 4)] + ["3/4"]:
        if not re.search(rf"^{re.escape(label)}\. ", out, re.M):
            raise AssertionError(f"quickstart section {label} never printed:\n{out}")
    for want in ("interrupted@3 + resume ≡ uninterrupted: True",
                 "on a world of 2 ranks (paths ≡ single-device: True)"):
        if want not in out:
            raise AssertionError(f"quickstart: no {want!r}:\n{out}")
    if launches["gram"] < 1 or launches["wtw_column"] < 1 or launches["cholesky"]:
        raise AssertionError(f"quickstart launches {launches}")
    emit("quickstart", seconds=secs, sections=16, lines=lines[:-1], launches=launches,
         card=card)
    return {"quickstart": launches}


def phase_tools_reference_api(dev, main: dict, plain_run: dict, card: str) -> dict:
    """16e: `complement_precision` at the main path's 10 240 candidates
    against its plain version (the plain Gram) and against WᵀW of
    `implicit_precision_seed`; `plan_path_step` against `plan_episode_step`
    at the state the cut c5_10k run planned from at step 2."""
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops import linalg as la
    from algp_tpu_torch.ops.kernels import KernelSpec

    _zero_counts()
    spec, p, x = KernelSpec("rbf", ds=2), main["params"], main_grid(dev)
    base = torch.clamp_min(torch.exp(2.0 * p.log_noise), main["min_noise"] ** 2)
    nv = torch.ones(x.shape[0], device=dev) * base
    t0 = time.perf_counter()
    P = acq.complement_precision(spec, p, x, nv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    K = G.gram_reference(spec, p, x, x)
    K.diagonal().add_(p.noise_var * (nv / p.noise_var))
    scale = P.abs().max()
    out = {"n": x.shape[0], "complement_precision_s": secs,
           "max_abs_P": float(scale),
           "vs_plain_rel": float((P - la.spd_inverse_from_chol(la.cholesky(K))).abs().max()
                                 / scale)}
    del K
    W, _ = acq.implicit_precision_seed(spec, p, x, min_noise=main["min_noise"])
    out["vs_seed_wtw_rel"] = float((P - W.mT @ W).abs().max() / scale)
    del P, W
    if not (out["vs_plain_rel"] <= 1e-6 and out["vs_seed_wtw_rel"] <= 1e-6):
        raise AssertionError(f"complement_precision {out}")
    # plan_path_step: the episode's step with its noise vectors spelled out
    agent, st = plain_run["agent"], plain_run["plan_state"]
    args, common, live = plan_inputs(agent, st, dev)
    sp, params, X, idx_pad, m, ns_pad, y_pad, sets, sizes, costs = args
    W, WT = acq.implicit_precision_seed(sp, params, X, min_noise=common["min_noise"],
                                        nv_mult=common["nv_mult"])
    b_e, _, d_e, s_e = acq.plan_episode_step(*args, W, WT, strategy="mi", **common)
    base = torch.clamp_min(torch.exp(2.0 * params.log_noise), common["min_noise"] ** 2)
    valid = torch.arange(idx_pad.shape[0], device=dev) < m
    pnv = torch.where(valid, base * ns_pad, 1.0)
    nvp = torch.full((X.shape[0],), common["nv_mult"], device=dev) * base
    b_p, d_p, s_p = acq.plan_path_step(sp, params, X, nvp, idx_pad, m, pnv, sets, sizes,
                                       costs, W, WT, strategy="mi",
                                       path_utility=common["path_utility"])
    same = (int(b_p) == int(b_e), torch.equal(s_p, s_e),
            torch.equal(torch.clamp_min(d_p, 0.0), d_e))
    out["plan_path_step"] = {"step": st.step, "n": X.shape[0], "cap": idx_pad.shape[0],
                             "sampled": int(m), "paths": int(live.sum()),
                             "best": int(b_p), "best_equal": same[0],
                             "scores_equal": same[1], "post_var_equal": same[2]}
    if not all(same):
        raise AssertionError(f"plan_path_step vs plan_episode_step: {out['plan_path_step']}")
    launches = _counts()
    emit("tools_reference_api", **out, launches=launches, card=card)
    return {"tools_reference_api": launches}


def phase_tools(dev, card: str, main: dict) -> dict:
    """Phase 16, 16a-16e in turn; returns each path's launches."""
    t0 = time.perf_counter()
    paths, plain = phase_tools_profile(dev, card)
    paths.update(phase_tools_plots(dev, card))
    paths.update(phase_tools_debug(dev, main, card))
    paths.update(phase_quickstart(card))
    paths.update(phase_tools_reference_api(dev, main, plain, card))
    emit("tools", seconds=time.perf_counter() - t0, card=card)
    return paths


# phase 17: the final posterior and its calibration on the card against the
# same run on the host's CPU.  deep_c2 is 14c's command at its full length;
# long_sgpr is c5_long at full width past its SGPR threshold, cut in depth:
# 264 pilots over a threshold of 256 (both packages refuse a threshold
# below the 256 inducing points), so the pilot fit is the SGPR bound, then
# QUALITY_LONG_STEPS steps on one MI seed, the capacity sized to them
QUALITY_SEED = 0
QUALITY_LONG_PILOT, QUALITY_LONG_THRESHOLD, QUALITY_LONG_STEPS = 264, 256, 3


def quality_cases() -> list:
    """(tag, config, steps) of phase 17's two paths."""
    from algp_tpu_torch import config as tc

    c2 = tc.PRESETS["c2_composite_restarts"]
    deep = dataclasses.replace(
        c2, field=dataclasses.replace(c2.field, feature_warp="tanh", seed=QUALITY_SEED),
        episode=dataclasses.replace(c2.episode, seed=QUALITY_SEED),
        deep=tc.MLPSpec(hidden=(16,), out=4))
    lng = tc.PRESETS["c5_long"]
    ep = lng.episode
    long_sgpr = dataclasses.replace(
        lng, fit=dataclasses.replace(lng.fit, sparse_threshold=QUALITY_LONG_THRESHOLD),
        field=dataclasses.replace(lng.field, seed=QUALITY_SEED),
        episode=dataclasses.replace(
            ep, seed=QUALITY_SEED, num_pilot=QUALITY_LONG_PILOT,
            max_samples=QUALITY_LONG_PILOT + (QUALITY_LONG_STEPS + 6) * ep.samples_per_step))
    return [("deep_c2", deep, 1000), ("long_sgpr", long_sgpr, QUALITY_LONG_STEPS)]


def held_out_diagnostics(env, var) -> dict:
    """The held-out cells' smallest final variance and how many sit below
    1e-6."""
    v = np.asarray(var, np.float64)[env.test_mask]
    return {"min_var_test": float(v.min()), "n_var_test_below_1e-6": int((v < 1e-6).sum())}


def quality_run(cfg, base_env, device, steps: int, deep_fits: list) -> tuple:
    """One episode of the port on `device` from host draws: the env a copy
    of `base_env` (truth, features, split, sensing generator), every fit's
    inits from the port's generators on the CPU, moved.  A deep refit is
    run and appended to `deep_fits` while that list is shorter than the
    refits so far, else replayed from it: the joint MLP fit is chaotic in
    f32, so the second device takes the first one's fits.  Returns
    (result, env, seconds, SGPR fits)."""
    from algp_tpu_torch.convert import field_env_like
    from algp_tpu_torch.episode import Agent
    from algp_tpu_torch.models import gp, networks, sparse_gp

    env = field_env_like(base_env, device)
    saved = {(gp, "step_inits"): gp.step_inits,
             (networks, "step_inits"): networks.step_inits,
             (networks, "fit_step"): networks.fit_step,
             (sparse_gp, "fit_step_sparse"): sparse_gp.fit_step_sparse,
             (sparse_gp, "fit_step_sparse_warm"): sparse_gp.fit_step_sparse_warm}
    calls = {"deep": 0, "sparse": 0}

    def host_inits(spec, fit_cfg, seed, step, dev):
        return saved[gp, "step_inits"](spec, fit_cfg, seed, step, "cpu").map(
            lambda a: a.to(dev))

    def host_deep_inits(kspec, mspec, fit_cfg, seed, step, dev):
        mlp0, kinits = saved[networks, "step_inits"](kspec, mspec, fit_cfg, seed, step, "cpu")
        return [(W.to(dev), b.to(dev)) for W, b in mlp0], kinits.map(lambda a: a.to(dev))

    def deep_fit(kspec, mspec, fit_cfg, x, y, ns, seed, step, num_valid=None):
        k = calls["deep"]
        calls["deep"] += 1
        if k < len(deep_fits):
            r = deep_fits[k]
            return dataclasses.replace(
                r, params=r.params.map(lambda a: a.to(x.device)),
                mlp=[(W.to(x.device), b.to(x.device)) for W, b in r.mlp])
        r = saved[networks, "fit_step"](kspec, mspec, fit_cfg, x, y, ns, seed, step,
                                        num_valid=num_valid)
        deep_fits.append(r)
        return r

    def sparse(name):
        def fit(*a, **k):
            calls["sparse"] += 1
            return saved[sparse_gp, name](*a, **k)
        return fit

    gp.step_inits, networks.step_inits = host_inits, host_deep_inits
    networks.fit_step = deep_fit
    sparse_gp.fit_step_sparse = sparse("fit_step_sparse")
    sparse_gp.fit_step_sparse_warm = sparse("fit_step_sparse_warm")
    try:
        _sync(device)
        t0 = time.perf_counter()
        res = Agent(env, cfg).run(max_steps=steps)
        _sync(device)
        seconds = time.perf_counter() - t0
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return res, env, seconds, calls["sparse"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_quality(dev, card: str) -> dict:
    """Phase 17: deep_c2 and long_sgpr once on the card and once on the
    CPU from the same draws (`quality_run`; the card's deep fits replayed
    on the CPU).  For each device the final nlpd_test / cov90_test /
    cov95_test, the smallest held-out variance and the held-out cells
    below 1e-6.  Fails if a card coverage is more than one cell's share
    of its mask from the CPU's, or the card's nlpd_test is more than twice
    the CPU's.  Returns each card run's launches."""
    from algp_tpu_torch.field import FieldEnv

    t_phase = time.perf_counter()
    launches = {}
    for tag, cfg, steps in quality_cases():
        base = FieldEnv(cfg.field, cfg.kernel, device="cpu")
        fits: list = []
        _zero_counts()
        card_res, env, card_s, card_sparse = quality_run(cfg, base, dev, steps, fits)
        launches["quality_" + tag] = _counts()
        cpu_res, cpu_env, cpu_s, cpu_sparse = quality_run(cfg, base, "cpu", steps, fits)
        card_cal, cpu_cal = card_res.calibration, cpu_res.calibration
        if launches["quality_" + tag]["gram"] < 1:
            raise AssertionError(f"quality {tag}: the card run launched no Gram kernel")
        if tag == "long_sgpr" and not (card_sparse and cpu_sparse):
            raise AssertionError(f"quality {tag}: no SGPR fit ({card_sparse}, {cpu_sparse})")
        for k, mask in (("cov90", env.observed_mask), ("cov95", env.observed_mask),
                        ("cov90_test", env.test_mask), ("cov95_test", env.test_mask)):
            if abs(card_cal[k] - cpu_cal[k]) > (1 + 1e-9) / int(mask.sum()):
                raise AssertionError(f"quality {tag}: card {k} {card_cal[k]} against "
                                     f"the CPU's {cpu_cal[k]}, more than one cell apart")
        if card_cal["nlpd_test"] - cpu_cal["nlpd_test"] > abs(cpu_cal["nlpd_test"]):
            raise AssertionError(f"quality {tag}: card nlpd_test {card_cal['nlpd_test']}, "
                                 f"more than twice the CPU's {cpu_cal['nlpd_test']}")
        per = {}
        for name, res, e, s in (("on_card", card_res, env, card_s),
                                ("on_cpu", cpu_res, cpu_env, cpu_s)):
            per[name] = dict({k: res.calibration[k] for k in
                              ("nlpd_test", "cov90_test", "cov95_test", "nlpd", "cov90",
                               "cov95")},
                             rmse_test=res.rmse_test, seconds=s,
                             **held_out_diagnostics(e, res.var))
        emit("quality_" + tag, steps=int(card_res.state.step),
             samples=len(card_res.state.sampled_idx),
             same_sites=bool(np.array_equal(card_res.state.sampled_idx,
                                            cpu_res.state.sampled_idx)),
             max_abs_mean_diff=float(np.abs(card_res.mean - cpu_res.mean).max()),
             max_abs_var_diff=float(np.abs(card_res.var - cpu_res.var).max()),
             deep_fits_replayed=len(fits), sgpr_fits=card_sparse,
             launches=launches["quality_" + tag], card=card, **per)
    emit("quality", seconds=time.perf_counter() - t_phase, card=card)
    return launches


def main() -> None:
    t_start = time.perf_counter()
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    tool, variants = phase_build()
    gram = phase_gram(dev, tool, variants)
    wtw = phase_wtw(dev)
    oracle = load_module("oracle", ROOT / "tests" / "oracle.py")
    phase_fidelity(dev, oracle)
    main_run = phase_main(dev, oracle, smi)
    phase_layers(dev, main_run)
    phase_profile(main_run)
    mesh_ref = mesh_reference(dev, main_run)
    episode_run = phase_episode(dev, smi)
    lowrank_run = phase_lowrank_main(dev, oracle, smi)
    episode_100k = phase_episode_100k(dev, smi)
    episode_long = phase_episode_long(dev, smi)
    lowrank_1m = phase_lowrank_main(dev, oracle, smi, LOWRANK_1M_GRID, LOWRANK_1M_M,
                                    reps=3, tag="lowrank_1m", gate=1)
    episode_1m = phase_episode_1m(dev, smi)
    episode_4m = phase_episode_4m(dev, smi)
    episode_4m_ens = phase_episode_4m_ens(dev, smi, episode_4m)
    episode_1m_long = phase_episode_1m_long(dev, smi)
    # the f64 oracles of the greedy phases and of the mesh phases, and 15f's
    # replays (150-200 s of host numpy each) run in three worker processes
    # while the card goes on; BLAS threads capped so the workers leave the
    # host loop of the episodes cores
    blas = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in blas}
    os.environ.update({k: "2" for k in blas})
    pool = multiprocessing.get_context("spawn").Pool(processes=3)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k)
        else:
            os.environ[k] = v
    try:
        mesh_oracle = pool.apply_async(oracle_greedy_mi_scores, mesh_ref["oracle_job"])
        greedy = {
            "greedy_c2": phase_greedy_c2(
                dev, oracle, smi, main_run["median_ms"], "greedy_c2", GREEDY_C2_ARGS,
                "c2_composite_restarts --rows 100 --cols 100 --mode greedy --acq-rounds 50 "
                "via cli.run_greedy: 10 000 candidates, d = 2 + 3, Matern-5/2 x RBF, 32 "
                "pilots, adam 4x150 twice, exact MI seed, 50 rounds", pool),
            "greedy_c2_deep": phase_greedy_c2(
                dev, oracle, smi, main_run["median_ms"], "greedy_c2_deep",
                GREEDY_C2_DEEP_ARGS, "greedy_c2 with --deep-hidden 16 --deep-out 4: the "
                "3 features embedded to 4 by a 3-16-4 tanh MLP trained with the kernel "
                "(adam 4x150 twice), the composite Gram over d = 2 + 4, exact MI seed, "
                "50 rounds", pool),
        }
        field_runs = {tag: phase_field_episode(dev, smi, tag, args)
                      for tag, args in FIELD_EPISODES}
        field_runs.update({tag: phase_field_episode(dev, smi, tag, args)
                           for tag, args in TRAIT_EPISODES + ICM_EPISODES})
        tag, args = DEEP_EPISODE
        field_runs[tag] = phase_field_episode(
            dev, smi, tag, args,
            fit_s_against=("episode_c2_warp", field_runs["episode_c2_warp"]["fit_s_median"]))
        chol = phase_chol(dev, main_run, episode_run, smi)
        for run in greedy.values():
            run["finish"]()
        mesh = phase_mesh(dev, smi, mesh_ref, mesh_oracle, pool)
        pool.close()
        pool.join()
    finally:
        pool.terminate()
        pool.join()
    tools = phase_tools(dev, smi, main_run)
    quality = phase_quality(dev, smi)
    paths = {"main": main_run["launches"], "episode": episode_run["launches"],
             "lowrank_main": lowrank_run["launches"],
             "episode_100k": episode_100k["launches"],
             "episode_long": episode_long["launches"],
             "lowrank_1m": lowrank_1m["launches"],
             "episode_1m": episode_1m["launches"],
             "episode_4m": episode_4m["launches"],
             "episode_4m_ens": episode_4m_ens["launches"],
             "episode_1m_long": episode_1m_long["launches"],
             **{tag: r["launches"] for tag, r in field_runs.items()},
             **{tag: r["launches"] for tag, r in greedy.items()},
             "chol_seed": chol.pop("launches"), **mesh, **tools, **quality}

    def entry(name, source, replaces, stats):
        by_path = {k: v[name] for k, v in paths.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, **stats}

    # the Gram launches of the composite template, by path (of launches_by_path)
    gram["composite_launches_by_path"] = {k: v["gram_composite"] for k, v in paths.items()}

    emit("total", seconds=time.perf_counter() - t_start, card=smi)
    print(json.dumps({"kernels": [
        entry("gram", "algp_tpu_torch/csrc/gram.cu", "algp_tpu/ops/gram.py:103", gram),
        entry("wtw_column", "algp_tpu_torch/csrc/wtw_column.cu",
              "algp_tpu/ops/updates.py:90", wtw),
        entry("cholesky", "algp_tpu_torch/csrc/chol.cu",
              "algp_tpu/ops/pallas_chol.py:310", chol),
    ], "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
