#!/usr/bin/env python3
"""Time the Gram kernel (`algp_tpu_torch/csrc/gram.cu`) against its design
variants (`tools/gram_variants.cu`) on one NVIDIA GPU, and count the SASS
instructions and global loads each spends per output.

    python3 tools/gram_profile.py [--out FILE]

At the shapes the paths give the kernel (the main path's 10 240² RBF seed,
the low-rank seed's 1 024 × 102 400, the million-point seeds' 512 × 2²⁰
and 512 × 2²², the conditioning pass's 352 × 2²⁰, 640 × 2²⁰ and
224 × 2²², Matérn 3/2) it prints one JSON line a shape:

- every variant's output against the kernel's, bit for bit (and the
  kernel's against the plain PyTorch version on sampled columns);
- times by CUDA events, warm, the variants in turns (forward, then
  backward; each the mean of `reps` launches): the kernel at the tile
  heights it can take and on a persistent grid, the shared-tile design, TMA bulk
  stores, the arithmetic alone, the stores alone, and `torch.Tensor.fill_`
  of the same output (the card's write stream with no arithmetic);
- the bytes bound (each output written once, inputs read once).

Then the composite template (Matérn 5/2 × RBF) at the feature paths' 10 240²
(greedy c2's seed, d = 2 + 3; the deep kernel's, d = 2 + 4) and 1 000² (the
truths, d = 2 + 3): the kernel through its wrapper, at tile heights 8, 16
and 32, and the earlier composite design (prescaled segments, every
coordinate read per output), launched alone and wrapped as its wrapper was
(slices, scaling, launch); every variant bitwise against the kernel.

Then one `sass` line: per kernel instance, the instructions of its hot
loop (the innermost loop that stores) over the outputs one trip writes,
and its global loads over the same outputs, from `cuobjdump -sass`.
`chip_smoke.py` loads `sass_per_output` from this file.  The variants'
library builds under `build/gram_profile/<hash>/`, with the SASS of the
kernels counted in `gram_variants.sass` beside it.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from algp_tpu_torch.ops import _cuda  # noqa: E402
from algp_tpu_torch.ops import gram as G  # noqa: E402
from algp_tpu_torch.ops.kernels import KERNEL_KINDS, KernelSpec  # noqa: E402

SRC = ROOT / "tools" / "gram_variants.cu"
HBM_BPS = 3.35e12  # H100 SXM data sheet, at 700 W

# (name, kind, n1, side of the integer grid for n2 = side², lengthscale)
SHAPES = (
    ("main_seed_10240", "rbf", 10240, None, 8.0),
    ("lowrank_seed_1024x102400", "matern32", 1024, 320, 25.0),
    ("seed_512x2^20", "matern32", 512, 1024, 80.0),
    ("seed_512x2^22", "matern32", 512, 2048, 160.0),
    ("cond_352x2^20", "matern32", 352, 1024, 80.0),
    ("cond_640x2^20", "matern32", 640, 1024, 80.0),
    ("cond_224x2^22", "matern32", 224, 2048, 160.0),
)


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


def _cuobjdump() -> str:
    return str(Path(_cuda._nvcc()).parent / "cuobjdump")


def build() -> Path:
    """The variants' library (built once per source hash)."""
    h = hashlib.sha256(" ".join(_cuda.NVCC_FLAGS).encode())
    for p in (SRC, *sorted(_cuda.CSRC.glob("*.cu*"))):
        h.update(p.read_bytes())
    out = ROOT / "build" / "gram_profile" / h.hexdigest()[:16]
    lib = out / "libgram_variants.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(lib), str(SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out / "build.log").write_text(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {SRC}:\n{proc.stdout}{proc.stderr}")
    return lib


def load(lib_path: Path) -> ctypes.CDLL:
    """The variants' library, loaded, with its C signature set."""
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gram_variant.restype = I
    lib.gram_variant.argtypes = [I, P, P, P, P, I, I, I, I, I, I, P]
    lib.gram_composite_variant.restype = I
    lib.gram_composite_variant.argtypes = [I, P, P, P, P, P, P, P, I, I, I, I, I, P]
    return lib


def launch(lib, variant: int, kind: str, x1s, x2s, scale, out, rows: int = 0,
           grid: int = 0) -> None:
    """One launch of a variant on inputs already scaled by the lengthscale."""
    code = lib.gram_variant(variant, x1s.data_ptr(), x2s.data_ptr(), scale.data_ptr(),
                            out.data_ptr(), x1s.shape[0], x2s.shape[0], x1s.shape[1],
                            KERNEL_KINDS.index(kind), rows, grid,
                            _cuda.stream_ptr(out.device))
    if code:
        raise RuntimeError(f"gram variant {variant} (rows {rows}, grid {grid}): "
                           f"CUDA error {code}")


def shared_tile(lib, spec: KernelSpec, params, x1, x2):
    """K(x1, x2) by the shared-tile design, wrapped as `ops.gram.gram_kernel`
    wraps the kernel (inputs scaled, output allocated, on each call)."""
    inv = torch.exp(-params.log_ls_spatial)
    out = torch.empty((x1.shape[0], x2.shape[0]), dtype=torch.float32, device=x1.device)
    launch(lib, 1, spec.spatial_kind, (x1 * inv).contiguous(), (x2 * inv).contiguous(),
           torch.exp(params.log_outputscale).reshape(1), out)
    return out


def composite_rows(lib, spec: KernelSpec, params, x1, x2, out, rows: int) -> None:
    """The composite kernel (Matérn 5/2 × RBF, ds = 2) at a tile height of
    `rows`, on unscaled rows, into `out`."""
    inv = torch.exp(-torch.cat((params.log_ls_spatial, params.log_ls_feature)))
    code = lib.gram_composite_variant(
        0, x1.data_ptr(), x2.data_ptr(), None, None, inv.data_ptr(),
        torch.exp(params.log_outputscale).reshape(1).data_ptr(), out.data_ptr(),
        x1.shape[0], x2.shape[0], spec.ds, spec.df, rows, _cuda.stream_ptr(out.device))
    if code:
        raise RuntimeError(f"composite kernel at {rows} rows: CUDA error {code}")


def old_composite(lib, spec: KernelSpec, params, x1, x2, out=None):
    """K(x1, x2) by the earlier composite design (Matérn 5/2 × RBF), wrapped
    as its wrapper was: the two segments sliced and scaled in torch, the
    output allocated (unless given), then the launch."""
    ds = spec.ds
    inv_s, inv_f = torch.exp(-params.log_ls_spatial), torch.exp(-params.log_ls_feature)
    x1s, x2s = (x1[:, :ds] * inv_s).contiguous(), (x2[:, :ds] * inv_s).contiguous()
    x1f, x2f = (x1[:, ds:] * inv_f).contiguous(), (x2[:, ds:] * inv_f).contiguous()
    if out is None:
        out = torch.empty((x1.shape[0], x2.shape[0]), dtype=torch.float32, device=x1.device)
    code = lib.gram_composite_variant(
        1, x1s.data_ptr(), x2s.data_ptr(), x1f.data_ptr(), x2f.data_ptr(), None,
        torch.exp(params.log_outputscale).reshape(1).data_ptr(), out.data_ptr(),
        x1.shape[0], x2.shape[0], ds, spec.df, 0, _cuda.stream_ptr(out.device))
    if code:
        raise RuntimeError(f"earlier composite design: CUDA error {code}")
    return out


def sass_functions(lib: Path) -> dict[str, list[tuple[int, str]]]:
    """Function name → its SASS instructions as (address, text), from
    cuobjdump."""
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?)\s*;", line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _target(ins: str):
    m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def hot_loop(instr: list[tuple[int, str]]) -> dict | None:
    """The innermost loop holding a global store: its instructions (NOPs
    left out), those a trip issues when every forward branch over a CALL
    is taken (the slow paths of IEEE sqrtf and ÷ for denormal, infinite or
    NaN operands, which r² ≥ 1e-20 never takes), the outputs one trip
    writes (a .128 store 4, a .64 store 2, else 1), and its global and
    shared loads.  None when no loop stores (the stores are straight-line
    code)."""
    index = {a: i for i, (a, _) in enumerate(instr)}
    best = None
    for end, (addr, ins) in enumerate(instr):
        tgt = _target(ins)
        if tgt is None or tgt > addr or tgt not in index:
            continue
        body = instr[index[tgt]:end + 1]
        stores = [i for _, i in body if re.search(r"\bSTG\b", i)]
        if not stores or (best is not None and len(body) >= best[0]):
            continue
        n = sum(not re.match(r"(@!?U?P\w+\s+)?NOP\b", i) for _, i in body)
        skipped = 0
        for k, (a, i) in enumerate(body):
            t = _target(i)
            if t is not None and a < t <= addr:
                over = [x for b, x in body[k + 1:] if b < t]
                if any("CALL" in x for x in over):
                    skipped += len(over)
        outs = sum(4 if ".128" in i else 2 if ".64" in i else 1 for i in stores)
        ldg = sum(bool(re.search(r"\bLDG\b", i)) for _, i in body)
        lds = sum(bool(re.search(r"\bLDS\b", i)) for _, i in body)
        best = (len(body), {"instructions": n, "issued": n - skipped, "outputs": outs,
                            "per_output": (n - skipped) / outs, "global_loads": ldg,
                            "global_loads_per_output": ldg / outs, "shared_loads": lds})
    return None if best is None else best[1]


def sass_per_output(lib: Path, patterns: dict[str, str]) -> dict:
    """{tag: hot_loop(...)} for the first function whose name holds each
    pattern (a piece of the mangled name)."""
    funcs = sass_functions(lib)
    out = {}
    for tag, pat in patterns.items():
        name = next((f for f in funcs if pat in f), None)
        out[tag] = None if name is None else {"function": name, **(hot_loop(funcs[name]) or {})}
    return out


# the mangled names (with their length prefix) of the kernel instances the
# paths run: gram_kernel<SK, DS = 2, VEC = true> and, Matérn 5/2 × RBF,
# composite_kernel<SK = 2, FK = 0, DS = 2, DF, VEC = true> at the feature
# widths of the warped truth (1), c2 and c10 (3) and the deep kernel (4)
KERNEL_PATTERNS = {
    "matern32": "11gram_kernelILi1ELi2ELb1E",
    "rbf": "11gram_kernelILi0ELi2ELb1E",
}
COMPOSITE_PATTERNS = {
    f"composite_matern52_rbf_d2+{df}": f"16composite_kernelILi2ELi0ELi2ELi{df}ELb1E"
    for df in (1, 3, 4)
}
# the earlier composite design (tools/gram_variants.cu), Matérn 5/2 × RBF
OLD_COMPOSITE_PATTERN = {"old_composite_matern52_rbf": "20old_composite_kernelILi2ELi0ELb1E"}
# (name, side of the square, feature width); x: a 128 × 80 or 25 × 40 grid
# beside N(0, 1) features
COMPOSITE_SHAPES = (
    ("c2_seed_10240_d2+3", 10240, 3),
    ("deep_seed_10240_d2+4", 10240, 4),
    ("c2_truth_1000_d2+3", 1000, 3),
)


def inputs(kind, n1, side, ls, dev):
    """x2: an integer side² grid (or the main path's 10 240 points of a
    100-column grid); x1: n1 of its points, evenly strided; scaled as the
    wrapper scales them."""
    n2 = side * side if side else n1
    r, c = np.divmod(np.arange(n2), side or 100)
    x2 = torch.tensor(np.stack([c, r], 1), dtype=torch.float32, device=dev)
    x1 = x2[:: max(1, n2 // n1)][:n1].contiguous()
    spec = KernelSpec(kind, ds=2)
    p = spec.init_params(ls_spatial=ls, outputscale=1.0, device=dev)
    inv = torch.exp(-p.log_ls_spatial)
    return spec, p, x1, x2, (x1 * inv).contiguous(), (x2 * inv).contiguous()


def composite_inputs(n: int, df: int, dev):
    """Matérn 5/2 × RBF at ls 4 (spatial) and 1 (features), s² = 1, and n
    points: a 25 × 40 (n = 1 000) or 128 × 80 grid beside N(0, 1) features
    from a seed."""
    cols = 40 if n == 1000 else 128
    r, c = np.divmod(np.arange(n), cols)
    f = np.random.default_rng(12).standard_normal((n, df))
    x = torch.tensor(np.concatenate([np.stack([c, r], 1), f], 1), dtype=torch.float32,
                     device=dev)
    spec = KernelSpec("matern52", "rbf", ds=2, df=df)
    return spec, spec.init_params(ls_spatial=4.0, ls_feature=1.0, outputscale=1.0,
                                  device=dev), x


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also append the JSON lines to this file")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    lib_path = build()
    lib = load(lib_path)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    for name, kind, n1, side, ls in SHAPES:
        spec, p, x1, x2, x1s, x2s = inputs(kind, n1, side, ls, dev)
        n2 = x2.shape[0]
        scale = torch.exp(p.log_outputscale).reshape(1)
        ref = G.gram_kernel(spec, p, x1, x2)
        cols = torch.cat([torch.randint(0, n2, (4096,), device=dev),
                          torch.arange(n2 - 64, n2, device=dev)])
        plain_err = float((ref.index_select(1, cols) - G.gram_reference(
            spec, p, x1, x2.index_select(0, cols))).abs().max())
        out = torch.empty_like(ref)

        def variant(v, rows=0, grid=0):
            return lambda: launch(lib, v, kind, x1s, x2s, scale, out, rows, grid)

        runs = {"kernel": lambda: G.gram_kernel(spec, p, x1, x2)}
        for rows in (8, 16, 32, 64):
            runs[f"rows_{rows}"] = variant(0, rows)
        for per_sm in (4, 8):
            runs[f"persistent_{per_sm}x{sms}_rows_8"] = variant(5, 8, per_sm * sms)
        runs["shared_tile"] = variant(1)
        runs["shared_tile_wrapped"] = lambda: shared_tile(lib, spec, p, x1, x2)
        runs["tma_bulk_store_rows_32"] = variant(2, 32)
        runs["arithmetic_alone"] = variant(3, 32)
        runs["stores_alone"] = variant(4, 32)
        runs["fill_"] = lambda: out.fill_(1.0)
        equal = {}
        for k, fn in runs.items():
            if k in ("kernel", "shared_tile_wrapped", "arithmetic_alone", "stores_alone",
                     "fill_"):
                continue
            out.fill_(float("nan"))
            fn()
            equal[k] = bool(torch.equal(out, ref))
        del ref
        ms = {k: [] for k in runs}
        order = list(runs)
        for turn in (order, order[::-1]):
            for k in turn:
                ms[k].append(cuda_ms(runs[k], args.reps))
        bound_ms = 4 * (n1 * n2 + 2 * (n1 + n2)) / HBM_BPS * 1e3
        emit({"shape": name, "kind": kind, "n1": n1, "n2": n2, "bound_ms": bound_ms,
              "kernel_vs_plain_max_abs_err": plain_err, "checked": "4160 sampled columns",
              "bitwise_equal_to_kernel": equal,
              "ms": {k: float(np.mean(v)) for k, v in ms.items()},
              "ms_turns": ms,
              "share_of_bound": {k: bound_ms / float(np.mean(v)) for k, v in ms.items()},
              "card": smi})
        del out, x1, x2, x1s, x2s
        torch.cuda.empty_cache()

    for name, n, df in COMPOSITE_SHAPES:
        spec, p, x = composite_inputs(n, df, dev)
        ref = G.gram_kernel(spec, p, x, x)
        plain_err = float((ref - G.gram_reference(spec, p, x, x)).abs().max())
        out = torch.empty_like(ref)
        runs = {"kernel": lambda: G.gram_kernel(spec, p, x, x)}
        for rows in (8, 16, 32):
            runs[f"rows_{rows}"] = lambda rows=rows: composite_rows(lib, spec, p, x, x, out, rows)
        runs["old_design"] = lambda: old_composite(lib, spec, p, x, x, out)
        runs["old_design_wrapped"] = lambda: old_composite(lib, spec, p, x, x)
        runs["fill_"] = lambda: out.fill_(1.0)
        equal = {}
        for k in ("rows_8", "rows_16", "rows_32", "old_design"):
            out.fill_(float("nan"))
            runs[k]()
            equal[k] = bool(torch.equal(out, ref))
        del ref
        ms = {k: [] for k in runs}
        order = list(runs)
        for turn in (order, order[::-1]):
            for k in turn:
                ms[k].append(cuda_ms(runs[k], args.reps if n > 1000 else 20))
        bound_ms = 4 * (n * n + 2 * spec.dim * n) / HBM_BPS * 1e3
        emit({"shape": name, "kind": "matern52 x rbf", "n1": n, "n2": n, "d": spec.dim,
              "bound_ms": bound_ms, "kernel_vs_plain_max_abs_err": plain_err,
              "tol": "2e-6*s2", "bitwise_equal_to_kernel": equal,
              "ms": {k: float(np.mean(v)) for k, v in ms.items()}, "ms_turns": ms,
              "share_of_bound": {k: bound_ms / float(np.mean(v)) for k, v in ms.items()},
              "card": smi})
        del out, x
        torch.cuda.empty_cache()

    patterns = {**KERNEL_PATTERNS, **COMPOSITE_PATTERNS, **OLD_COMPOSITE_PATTERN}
    patterns.update({f"shared_tile_{k}": f"shared_tile_kernelILi{i}E" for k, i in
                     (("matern32", 1), ("rbf", 0))})
    emit({"sass": sass_per_output(lib_path, patterns),
          "note": "hot loop = innermost loop holding a global store; issued = its "
                  "instructions less the slow paths of sqrtf and division; no loop: "
                  "the stores are straight-line code"})
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    funcs = sass_functions(lib_path)
    (lib_path.parent / "gram_variants.sass").write_text("\n\n".join(
        f"Function : {k}\n" + "\n".join(f"/*{a:04x}*/ {i} ;" for a, i in v)
        for k, v in funcs.items() if any(p in k for p in patterns.values())))


if __name__ == "__main__":
    main()
