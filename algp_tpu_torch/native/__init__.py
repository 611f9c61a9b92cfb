"""Native (C) host code of the port: `pathenum.c`, the budgeted path
enumerator behind `planning.enumerate_paths` / `enumerate_batch`.

The port's own copy of the reference's `algp_tpu/native` (same C source,
same ctypes interface).  Built at first use with the system C compiler
(`cc`, the host compiler nvcc also uses) into the git-ignored
`build/algp_tpu_torch/native/<hash>/` at the repository root, keyed by a
hash of the source and the flags, and loaded with ctypes.  A missing
compiler or a failed build raises with the compiler's output; the plain
Python enumerator (`planning._enumerate_paths_python`) is what the tests
hold this one equal to, never a quiet fallback.  Nothing here runs at
import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "pathenum.c"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "algp_tpu_torch" / "native"
CC_FLAGS = ("-O3", "-shared", "-fPIC")

_I32P = ctypes.POINTER(ctypes.c_int32)


class BuildError(RuntimeError):
    """The C compiler is missing or refused the source; carries its output."""


def _build() -> Path:
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src + " ".join(CC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    lib = out_dir / "libpathenum.so"
    if lib.exists():
        return lib
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise BuildError("no C compiler (cc / gcc) on PATH to build pathenum.c")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".libpathenum.so.{os.getpid()}.tmp"
    cmd = [cc, *CC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(
            f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded enumerator (built on first call)."""
    lib = ctypes.CDLL(str(_build()))
    fn = lib.algp_enumerate_paths
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), _I32P, _I32P,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, _I32P, _I32P, _I32P,
    ]
    return lib


def enumerate_paths_raw(
    num_rows: int, num_cols: int, col_spacing: float, row_spacing: float,
    start: int, budget: float, max_paths: int, max_turns: int,
    min_cost_frac: float, k_max: int = 0, goal: int = -1,
):
    """C path enumeration, array form: (nodes, offs, lens, costs, n) with
    path k's node sequence at nodes[offs[k]:offs[k]+lens[k]]; with
    k_max > 0 also the thinned batch (sets (max_paths, k_max), sizes,
    ends).  Raises if the enumerator reports a failure."""
    costs = np.zeros(max_paths, np.float64)
    lens = np.zeros(max_paths, np.int32)
    offs = np.zeros(max_paths, np.int64)
    # worst-case nodes per selected path ≈ budget / min(spacing) + turns
    per = int(budget / max(1e-9, min(col_spacing, row_spacing))) + 4
    nodes = np.empty(max_paths * per, np.int32)
    if k_max > 0:
        sets = np.empty((max_paths, k_max), np.int32)
        sizes = np.empty(max_paths, np.int32)
        ends = np.empty(max_paths, np.int32)
        pset, psiz, pend = (a.ctypes.data_as(_I32P) for a in (sets, sizes, ends))
    else:
        pset = psiz = pend = None
    n = library().algp_enumerate_paths(
        num_rows, num_cols, col_spacing, row_spacing, start, goal, budget,
        max_paths, max_turns, min_cost_frac,
        costs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        lens.ctypes.data_as(_I32P), nodes.ctypes.data_as(_I32P),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nodes.shape[0],
        k_max, pset, psiz, pend,
    )
    if n < 0:
        raise RuntimeError(f"native path enumeration failed (code {n})")
    if k_max > 0:
        return nodes, offs, lens, costs, n, sets, sizes, ends
    return nodes, offs, lens, costs, n


def enumerate_paths_native(
    num_rows: int, num_cols: int, col_spacing: float, row_spacing: float,
    start: int, budget: float, max_paths: int, max_turns: int,
    min_cost_frac: float, goal: int = -1,
) -> list[tuple[list[int], float]]:
    """C path enumeration as [(node_seq, cost)], exactly as planning's
    Python enumerator lists them.  Raises where the build or the
    enumerator fails."""
    nodes, offs, lens, costs, n = enumerate_paths_raw(
        num_rows, num_cols, col_spacing, row_spacing, start, budget,
        max_paths, max_turns, min_cost_frac, goal=goal,
    )
    return [(nodes[offs[k]: offs[k] + lens[k]].tolist(), float(costs[k]))
            for k in range(n)]
