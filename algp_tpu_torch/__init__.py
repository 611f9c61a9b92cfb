"""algp_tpu_torch — the PyTorch / CUDA port of algp_tpu.

The JAX package `algp_tpu` is the reference; this package mirrors its
module names (ops.kernels, ops.gram, ops.updates, ops.linalg, ops.chol,
models.gp, models.sparse_gp, models.multifit, models.coregional,
models.networks, acquisition, acquisition_lowrank, field, planning,
episode, cli, config, utils) with PyTorch idiom inside: plain
functions on tensors with an explicit device, `torch.Generator` in place
of `jax.random` keys, a written-out batch dimension in place of `vmap`
and Python loops in place of `lax.scan` / `fori_loop`.  The paths that
run: `acquisition.fit_and_select`, its low-rank counterpart
`acquisition_lowrank.fit_and_select_lowrank`, and the config-5 episode
(`episode.Agent`, `python -m algp_tpu_torch.cli`) with the exact or the
low-rank (FITC) planner, exact or SGPR refits and the z-ensemble, up to
the 2048 × 2048 field of the `c5_4m` preset, on fields with features,
several traits (independent or ICM fits) or the phenotype table, with the
stationary or the deep feature kernel.  The entry points run on the CUDA
card unless the caller asks for the CPU.

The reference's Pallas kernels are CUDA C++ kernels written for Hopper
(`csrc/gram.cu`, `csrc/wtw_column.cu`, `csrc/chol.cu`), built with nvcc
at first use (`ops/_cuda.py`).  A wrapper runs its plain PyTorch version
for a CPU tensor; for a CUDA tensor it launches its kernel or raises.

What is not ported yet (the mesh paths, the tools) is listed in
ROADMAP.md.  This package never imports JAX.
"""

__version__ = "0.1.0"

import torch as _torch

# The twin of algp_tpu's "highest" default matmul precision: the
# selection-fidelity contract (greedy selections equal a f64 oracle
# index for index) needs true f32 accumulation, and TF32 keeps only ~3
# decimal digits.  cuBLAS and cuDNN each have their own switch.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from algp_tpu_torch import config as config  # noqa: E402,F401
