#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (algp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one output line each, in order; any failure raises, so the
script exits non-zero and never prints the final line:

  1. device   — CUDA present; torch, CUDA, nvcc versions; card name and
                power limit (nvidia-smi)
  2. build    — nvcc builds csrc/*.cu from the checkout (seconds, ptxas)
  3. gram     — the Gram kernel vs its plain PyTorch version on the card,
                every kind + a composite at a ragged shape and RBF at the
                main path's 10 240²; times at 10 240²
  4. wtw      — the precision-column kernel vs W[:, j] @ W at N = 10 240
                and a ragged N; bitwise repeatability; times per call
  5. fidelity — 50-round greedy entropy / MI selections on the card equal
                the f64 oracle (tests/oracle.py) index for index
  6. main     — bench.py's workload through the port: a 100×100 field,
                32 pilots, a 4 × 100 Adam fit and 50 Krause-MI rounds via
                fit_and_select; launch counts, checks, median / min ms
  7. layers   — the main path's layers timed one by one
  8. profile  — one episode under torch.profiler: device busy share and
                the kernels by device time
  9. kernels  — one JSON line for all kernels
Last line: {"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPS = 5
GRID = 100  # the main path's field is GRID × GRID (bench.py: 100 × 100)


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


def phase_build() -> None:
    from algp_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    secs = time.perf_counter() - t0
    ptxas = [l.split("ptxas info    : ")[-1] for l in _cuda.build_log().splitlines()
             if "registers" in l or "spill" in l]
    emit("build", seconds=round(secs, 3), ptxas=ptxas)


def main_grid(dev):
    """The main path's candidate set: the 100×100 grid, 512-aligned."""
    from algp_tpu_torch.acquisition import pad_candidates

    r, c = np.divmod(np.arange(GRID * GRID), GRID)
    x = torch.tensor(np.stack([c, r], 1), dtype=torch.float32, device=dev)
    x_pad, _ = pad_candidates(x, torch.ones(GRID * GRID, device=dev))
    return x_pad


def phase_gram(dev) -> dict:
    from algp_tpu_torch.ops import gram as G
    from algp_tpu_torch.ops.kernels import KernelSpec

    rng = np.random.default_rng(0)
    cases = [
        (KernelSpec("rbf", ds=2), 997, 1283),
        (KernelSpec("matern32", ds=2), 997, 1283),
        (KernelSpec("matern52", ds=2), 997, 1283),
        (KernelSpec("matern52", "rbf", ds=2, df=3), 997, 1283),
    ]
    worst = 0.0
    results = []
    for spec, n1, n2 in cases:
        p = spec.init_params(ls_spatial=2.5, ls_feature=1.3, outputscale=1.7,
                             device=dev)

        def rand(n):
            xs = rng.uniform(0, 20, (n, spec.ds))
            xf = rng.standard_normal((n, spec.df))
            return torch.tensor(np.concatenate([xs, xf], 1),
                                dtype=torch.float32, device=dev)

        x1, x2 = rand(n1), rand(n2)
        err = float((G.gram_kernel(spec, p, x1, x2)
                     - G.gram_reference(spec, p, x1, x2)).abs().max())
        tol = 2e-6 * 1.7
        results.append({"spec": f"{spec.spatial_kind}x{spec.feature_kind if spec.df else '-'}",
                        "shape": [n1, n2], "max_abs_err": err})
        if not err <= tol:
            raise AssertionError(f"gram kernel vs plain: {err} > {tol} ({spec})")
        worst = max(worst, err)

    spec = KernelSpec("rbf", ds=2)
    p = spec.init_params(ls_spatial=8.0, outputscale=1.0, device=dev)
    x = main_grid(dev)
    err = float((G.gram_kernel(spec, p, x, x)
                 - G.gram_reference(spec, p, x, x)).abs().max())
    if not err <= 2e-6:
        raise AssertionError(f"gram kernel vs plain at 10240²: {err}")
    worst = max(worst, err)
    ms = cuda_ms(lambda: G.gram_kernel(spec, p, x, x))
    plain_ms = cuda_ms(lambda: G.gram_reference(spec, p, x, x), reps=5)
    gbps = x.shape[0] ** 2 * 4 / (ms * 1e-3) / 1e9
    results.append({"spec": "rbf", "shape": [x.shape[0]] * 2, "max_abs_err": err})
    emit("gram", cases=results, tol="2e-6*s2", ms=ms, plain_ms=plain_ms,
         write_GBps=round(gbps, 1))
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_wtw(dev) -> dict:
    from algp_tpu_torch.ops import updates as U

    gen = torch.Generator(device=dev).manual_seed(0)
    worst_abs, worst_rel, out = 0.0, 0.0, {}
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
            for j in (0, 5000):
                jt = torch.tensor(j, device=dev)
                out[j] = (cuda_ms(lambda: U.wtw_column(W, jt), 50),
                          cuda_ms(lambda: U.wtw_column_reference(W, jt), 50))
        del W
    # bytes the kernel must read at j: the lower triangle from row j on
    gb_read = lambda j: ((10240 - j) * (10240 + j + 1) / 2) * 4 / 1e9
    emit("wtw", max_abs_err=worst_abs, max_rel_err=worst_rel, tol="1e-4*max|u|",
         us_per_call={f"j={j}": {"kernel": k * 1e3, "plain": p * 1e3,
                                 "kernel_GBps": round(gb_read(j) / (k * 1e-3), 1)}
                      for j, (k, p) in out.items()})
    k0, p0 = out[0]
    return {"max_abs_err": worst_abs, "ms": k0, "plain_ms": p0}


def load_oracle():
    spec = importlib.util.spec_from_file_location("oracle", ROOT / "tests" / "oracle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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

    G.LAUNCHES = U.LAUNCHES = 0
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
        g0, u0 = G.LAUNCHES, U.LAUNCHES
        t0 = time.perf_counter()
        fit_res, nll, sel = episode(rep)
        dt = (time.perf_counter() - t0) * 1e3
        per_episode.append((G.LAUNCHES - g0, U.LAUNCHES - u0))
        if rep:  # rep 0 is the warm-up
            times.append(dt)
        if not np.isfinite(nll):
            raise AssertionError(f"non-finite NLL {nll}")
        if len(np.unique(sel)) != rounds or not (sel < n).all() or (sel < 0).any():
            raise AssertionError(f"bad selection {sel}")
    launches = {"gram": G.LAUNCHES, "wtw_column": U.LAUNCHES}
    for g, u in per_episode:
        if g < 1 or u != rounds:
            raise AssertionError(f"episode launches gram {g}, wtw {u}")

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
            "pilot_j": pilot_j, "launches": launches, "params": p,
            "episode": episode}


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
    out["cholesky_ms"] = cuda_ms(lambda: la.cholesky(K), 3)
    L = la.cholesky(K)
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


def main() -> None:
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    gram = phase_gram(dev)
    wtw = phase_wtw(dev)
    oracle = load_oracle()
    phase_fidelity(dev, oracle)
    main_run = phase_main(dev, oracle, smi)
    phase_layers(dev, main_run)
    phase_profile(main_run)
    counts = main_run["launches"]
    print(json.dumps({"kernels": [
        {"name": "gram", "route": "cuda", "source": "algp_tpu_torch/csrc/gram.cu",
         "replaces": "algp_tpu/ops/gram.py:70", "launches": counts["gram"], **gram},
        {"name": "wtw_column", "route": "cuda",
         "source": "algp_tpu_torch/csrc/wtw_column.cu",
         "replaces": "algp_tpu/ops/updates.py:129",
         "launches": counts["wtw_column"], **wtw},
    ], "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
