"""Build and load the hand-written CUDA kernels of `algp_tpu_torch/csrc`.

All `csrc/*.cu` files are compiled at first use by nvcc, one process
per source, all started together, and linked into one shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v --split-compile=0 \
         -c -o <obj> csrc/<kernel>.cu                                 # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> <objs>

The library goes to `build/algp_tpu_torch/<hash>/` at the repository
root (git-ignored), keyed by a hash of the sources and the flags, so an
edited kernel rebuilds and an unchanged one loads in milliseconds.  A
missing nvcc or a failed build raises with the compiler's output: there
is no fallback on the CUDA path.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "algp_tpu_torch"
LIB_NAME = "libalgp_tpu_kernels.so"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # register / shared-memory / spill report, kept in build.log
    "-Xptxas", "-v",
    # the optimizer's passes on all the host's cores (the Gram kernel's
    # composite sources hold ≈ 90 template instances each); the SASS is
    # the same
    "--split-compile=0",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signature of every exported function: (restype, argtypes)
_SIGNATURES = {
    # x1, x2, inv (composite) or null, scale, out, n1, n2, ds, df, sk, fk, stream
    "algp_gram": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    # W (a row strip), j (int64), out, n, row0, rows, stream
    "algp_wtw_column": (_I, [_P, _P, _P, _I, _I, _I, _P]),
    # its launch shape with an empty kernel: W, n, row0, rows, stream
    "algp_wtw_empty": (_I, [_P, _I, _I, _I, _P]),
    # A (in place, N × N), transposed-panel scratch, inverse scratch, N, stream
    "algp_cholesky": (_I, [_P, _P, _P, _I, _P]),
    "algp_chol_tile": (_I, []),
    "algp_chol_lt_floats": (ctypes.c_longlong, [_I]),
    "algp_chol_w_floats": (_I, []),
    "algp_error_string": (ctypes.c_char_p, [_I]),
}


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources; carries its output."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise BuildError(
        "nvcc not found (neither on PATH nor under CUDA_HOME); the CUDA "
        "kernels of algp_tpu_torch are compiled at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet;
    returns the library's path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):  # one nvcc per source, in parallel
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(out_dir / f"{src.stem}.{tag}.o"),
               str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = [], False
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n# exit {proc.returncode}\n{out}")
        failed |= proc.returncode != 0
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *(c[-2] for c, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n# exit {proc.returncode}\n"
                   f"{proc.stdout}{proc.stderr}")
        failed = proc.returncode != 0
    for cmd, _ in jobs:
        Path(cmd[-2]).unlink(missing_ok=True)
    log = f"# {time.perf_counter() - t0:.2f} s\n" + "\n".join(log)
    (out_dir / "build.log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"nvcc failed building algp_tpu_torch kernels:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def build_log() -> str:
    """The compiler output of the current sources' build."""
    return (BUILD_ROOT / _digest() / "build.log").read_text()


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if code != 0:
        msg = library().algp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device: torch.device) -> int:
    """The handle of PyTorch's current CUDA stream on `device` (a CUDA
    tensor's device, which names its index), read without building a
    `torch.cuda.Stream`.  Read at every launch, never cached: a stream
    context or a CUDA graph capture changes it."""
    return torch._C._cuda_getCurrentRawStream(device.index)
