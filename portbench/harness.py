"""Runs one cell of `BENCHMARK.json` once: set-up, warm-up, the measured
window, the traced sub-window when asked, the check against the plain
reference, and the result's one JSON line.

Everything that belongs to one cell, configuration, traffic mix or
metric is found by its name:

- `BENCHMARK.json`'s cell names its configuration (`configs[].file`) and
  its traffic mix (`portbench/traffic/<traffic>.json`), which names its
  driver (`portbench/drivers/<driver>.py`);
- `portbench/limits/<cell>.json` holds the limit of each number the check
  compares;
- every metric, end-to-end or per-layer, is read by
  `portbench/metrics/<metric>.py` (`read(ctx)` → a number, or None where
  there is nothing to read), with its work count and name list beside it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
import types
from pathlib import Path

import numpy as np

from portbench import trace as trace_mod
from portbench import work

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "algp_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str) -> dict:
    return json.loads((PKG / "limits" / f"{cell_name}.json").read_text())


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str):
    """The reader module of metric `name` (file names may hold dots)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_names(path: Path) -> list:
    """A name list: one pattern a line, '#' comments."""
    return [ln.strip() for ln in path.read_text().splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")]


def metrics_of(manifest: dict, cell_name: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries that this cell reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`algp_tpu_torch` is not `algp_tpu`)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def quantile(values, q: float) -> float:
    """The q-quantile over all samples (linear between order statistics)."""
    return float(np.quantile(np.asarray(values, dtype=float), q))


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict:
    from algp_tpu_torch.ops import chol, gram, updates

    return {"gram": gram.LAUNCHES, "gram_composite": gram.COMPOSITE_LAUNCHES,
            "wtw_column": updates.LAUNCHES, "cholesky": chol.LAUNCHES}


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(manifest: dict, cell_name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, cfg_override: dict | None = None,
             details: list | None = None) -> dict:
    """One run of the cell; returns the result object (the last line).
    `details` collects each checked call's numbers (the readings)."""
    import torch

    dev = torch.device(device)
    w = cell(manifest, cell_name)
    cfg = config(manifest, w["config"])
    cfg.update(cfg_override or {})
    tr = traffic(w["traffic"])
    lim = limits(cell_name)
    drv = driver(tr["driver"]).make(cfg, tr, seed, dev)

    t_setup = time.perf_counter()
    drv.setup()
    t_warm = time.perf_counter()
    drv.warm(float(tr.get("warm_seconds", 0.0)))
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s} (imports and card {t_setup - t_start}, inputs "
        f"{t_warm - t_setup}, warm-up {time.perf_counter() - t_warm})")

    i, tr_sum = 0, None
    if traced:
        # the traced sub-window comes first: late in a long process the
        # profiler has been seen to lose a short region's device records
        c0 = _launches()
        n_prof = int(tr["trace_calls"])
        tr_sum = trace_mod.profile(drv.call, 0, n_prof, lambda: _sync(dev))
        i = n_prof
        per_call = {k: (v - c0[k]) / n_prof for k, v in _launches().items()}
        log(f"launches_per_call {json.dumps(per_call)}")
        log("top_device_ops " + json.dumps(tr_sum.top_ops()))
    c0 = _launches()
    first, calls = i, 0
    load0 = os.getloadavg()
    t0 = time.perf_counter()
    while True:
        units = drv.call(i)  # a call, or an episode of `units` plan steps
        calls += 1 if units is None else units
        i += 1
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
    window_s = now - t0
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window_s {window_s} calls {calls} launches {json.dumps({k: v - c0[k] for k, v in _launches().items()})}")
    log(f"host loadavg {load0} -> {os.getloadavg()} cpus {len(os.sched_getaffinity(0))}")
    if hasattr(drv, "summary"):
        log("units " + json.dumps([drv.summary(drv.answers[k]) for k in range(first, i)]))
    if tr_sum is not None:
        log(f"tracing_overhead traced_ms_per_call {1e3 * tr_sum.wall_s / tr_sum.calls} "
            f"untraced_ms_per_call {1e3 * window_s / calls} "
            f"busy_s {tr_sum.busy_s} window_s {tr_sum.window_s}")

    ctx = types.SimpleNamespace(
        cell=cell_name, config=cfg, traffic=tr, setup_s=setup_s, window_s=window_s,
        calls=calls, answers={k: drv.answers[k] for k in range(first, i)},
        traced={k: drv.answers[k] for k in range(first - (tr_sum.runs if tr_sum else 0), first)},
        trace=tr_sum, work=work, names=metric_names,
        metrics_dir=PKG / "metrics", quantile=quantile)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in metrics_of(manifest, cell_name, kind):
        v = metric_reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the check, once the window has closed and the program's state is freed
    done = sorted(drv.answers)
    invalid = sum(not drv.validity(drv.answers[k]) for k in done)
    rng = np.random.default_rng(seed)
    sample = sorted(rng.choice(len(done), size=min(int(tr["check_calls"]), len(done)),
                               replace=False).tolist())
    answers = {done[k]: drv.answers[done[k]] for k in sample}
    drv.answers.clear()
    drv.free()
    t_check = time.perf_counter()
    worst: dict = {}
    for k, a in answers.items():
        got = drv.check(k, a)
        for name, v in got.items():
            worst[name] = max(worst.get(name, -math.inf), v)
        if details is not None:
            details.append({"call": k, **got, **drv.describe(a)})
    log(f"check_s {time.perf_counter() - t_check} calls_checked {sorted(answers)}")
    checks = {"invalid_answers": {"value": invalid, "limit": 0}}
    for name, limit in lim.items():
        checks[name] = {"value": worst.get(name, math.inf), "limit": limit}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
               "count": 1, "memory_peak_bytes": int(peak)}
    # requests are the driver's calls (an episode is one), failed or not
    result = {"correct": correct, "attempted": len(done), "failed": invalid,
              "metrics": metrics, "device": devinfo}
    if tr_sum is not None:
        devinfo.update(busy_s=tr_sum.busy_s, window_s=tr_sum.window_s)
        result["breakdown"] = {"device_ops": tr_sum.top_ops(), "idle_gaps": tr_sum.idle_gaps()}
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"]) else "inf",
                            "limit": v["limit"]} for k, v in checks.items()}
    for name, c in checks.items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        log(f"check {name} {c['value']} limit {c['limit']} {'ok' if ok else 'FAIL'}")
    return result
