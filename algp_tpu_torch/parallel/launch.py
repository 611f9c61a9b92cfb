"""Start a `torch.distributed` world of ranks, each running one function.

    from algp_tpu_torch.parallel import launch
    outs = launch.run("package.module:function", 4, backend="gloo",
                      device="cpu", kwargs={...}, timeout=90)

Every rank is a subprocess `python -m algp_tpu_torch.parallel.launch`
(so a rank imports only what its function needs), joins the world through
a `FileStore` in a temporary directory (no ports), creates its process
groups with `sharded.TIMEOUT`, calls `function(**kwargs)` and writes the
dict of arrays it returns to an `.npz` file; `run` returns those dicts in
rank order.  The function is "module:name" or "path/to/file.py:name".
The parent joins the ranks with a deadline: when one fails or the deadline
passes, it kills the others and raises `RankError` with the failing
rank's output.

backend: "gloo" or "nccl"; device: "cpu" or "cuda", the card unless the
caller asks for the CPU (`device.resolve_device`).  CPU ranks run with
OMP_NUM_THREADS=1.  CUDA ranks use card 0 when there is one card (ranks
sharing a card need gloo: NCCL takes one rank a card) and card `rank`
otherwise; the parent builds the CUDA kernels before the ranks start, so
that they load one library instead of each compiling it.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from algp_tpu_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]


class RankError(RuntimeError):
    """A rank failed or the world outlived its deadline."""


def _tail(path: Path, n: int = 6000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-n:]


def run(fn: str, world: int, *, backend: str = "gloo", device=None,
        kwargs: dict | None = None, timeout: float = 90.0) -> list[dict]:
    """Run `fn(**kwargs)` on `world` ranks; returns each rank's dict of
    numpy arrays, in rank order."""
    device = resolve_device(device).type
    if backend not in ("gloo", "nccl") or device not in ("cpu", "cuda"):
        raise ValueError(f"backend {backend!r} / device {device!r}")
    if device == "cuda":
        from algp_tpu_torch.ops import _cuda

        _cuda.library()
    with tempfile.TemporaryDirectory(prefix="algp_mesh_") as tmp:
        tmp = Path(tmp)
        with open(tmp / "job.pkl", "wb") as f:
            pickle.dump({"fn": fn, "kwargs": kwargs or {}}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs, logs = [], []
        try:
            for r in range(world):
                log = open(tmp / f"rank{r}.log", "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "algp_tpu_torch.parallel.launch",
                     "--rank", str(r), "--world", str(world), "--dir", str(tmp),
                     "--backend", backend, "--device", device],
                    cwd=tmp, env=env, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    r = bad[0]
                    raise RankError(f"rank {r} of {world} exited with {codes[r]}:\n"
                                    f"{_tail(tmp / f'rank{r}.log')}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    waiting = [r for r, c in enumerate(codes) if c is None]
                    raise RankError(
                        f"ranks {waiting} of {world} still running after {timeout} s:\n"
                        f"{_tail(tmp / f'rank{waiting[0]}.log')}")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
        outs = []
        for r in range(world):
            with np.load(tmp / f"rank{r}.npz") as z:
                outs.append({k: z[k] for k in z.files})
        return outs


def _resolve(fn: str):
    where, name = fn.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem, where)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(where)
    return getattr(mod, name)


def _rank_main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", type=Path, required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--device", required=True)
    a = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from algp_tpu_torch.parallel.sharded import TIMEOUT

    kw = {}
    if a.device == "cuda":
        torch.cuda.set_device(0 if torch.cuda.device_count() == 1 else a.rank)
        if a.backend == "nccl":
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    store = dist.FileStore(str(a.dir / "store"), a.world)
    dist.init_process_group(a.backend, store=store, rank=a.rank, world_size=a.world,
                            timeout=TIMEOUT, **kw)
    try:
        with open(a.dir / "job.pkl", "rb") as f:
            job = pickle.load(f)  # written by `run` in this run's directory
        out = _resolve(job["fn"])(**job["kwargs"])
        part = a.dir / f"rank{a.rank}.part.npz"
        np.savez(part, **{k: np.asarray(v) for k, v in out.items()})
        os.replace(part, a.dir / f"rank{a.rank}.npz")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main()
