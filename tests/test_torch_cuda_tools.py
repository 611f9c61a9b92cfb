"""The tools slice on the card: `utils.debug` on CUDA tensors, a
`utils.profiling.trace` that records the hand Gram kernel by name, and
`acquisition.complement_precision` against its plain version.

These need an NVIDIA GPU and nvcc and skip without one.  They import no
JAX, so run them on the card without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_tools.py -q
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from algp_tpu_torch import acquisition as acq
from algp_tpu_torch.ops import gram as G
from algp_tpu_torch.ops.kernels import KernelSpec
from algp_tpu_torch.utils import debug, profiling

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _field(dev, n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(0, 30, (n, 2)), dtype=torch.float32, device=dev)
    spec = KernelSpec("matern32", ds=2)
    return spec, spec.init_params(ls_spatial=4.0, outputscale=1.3, noise=0.1, device=dev), x


def test_checked_names_a_cuda_op_and_passes_the_gram_kernel(dev):
    def f(x):
        y = torch.sqrt(x - 3.0)  # NaN below 3, mid-way
        return (y * 2.0).sum()

    err, out = debug.checked(f)(torch.arange(8.0, device=dev))
    assert err.op == "aten.sqrt.default"
    with pytest.raises(FloatingPointError, match="sqrt"):
        err.throw()
    spec, p, x = _field(dev, 1000)
    before = G.LAUNCHES
    err, K = debug.checked(G.gram_kernel_with_noise)(spec, p, x)
    assert G.LAUNCHES == before + 1
    err.throw()
    assert K.device.type == "cuda" and torch.isfinite(K).all()


def test_assert_finite_tree_on_cuda_tensors(dev):
    spec, p, x = _field(dev, 64)
    debug.assert_finite_tree({"params": p, "x": [x]}, "state")
    bad = x.clone()
    bad[3, 1] = torch.inf
    with pytest.raises(FloatingPointError, match=r"state/\['x'\]/\[0\]: 1 non-finite of 128"):
        debug.assert_finite_tree({"params": p, "x": [bad]}, "state")


_TRACE_JOB = """
import json, sys
from pathlib import Path
import numpy as np, torch
from algp_tpu_torch.ops import gram as G
from algp_tpu_torch.ops.kernels import KernelSpec
from algp_tpu_torch.utils import profiling

dev = torch.device("cuda", 0)
x = torch.tensor(np.random.default_rng(0).uniform(0, 30, (2048, 2)),
                 dtype=torch.float32, device=dev)
spec = KernelSpec("matern32", ds=2)
p = spec.init_params(ls_spatial=4.0, device=dev)
G.gram_kernel(spec, p, x, x)  # built and warm
torch.cuda.synchronize()
with profiling.trace(sys.argv[1]):
    with profiling.annotate("gram-region"):
        for _ in range(3):
            G.gram_kernel(spec, p, x, x)
    torch.cuda.synchronize()
(path,) = Path(sys.argv[1]).glob("*.pt.trace.json")
events = json.loads(path.read_text())["traceEvents"]
print(json.dumps({"kernels": [e["name"] for e in events if e.get("cat") == "kernel"],
                  "region": any(e.get("name") == "gram-region" for e in events)}))
"""


def test_trace_records_the_hand_gram_kernel(dev, tmp_path):
    """A trace taken in a fresh process, as `--profile-dir` takes it early
    in the CLI's, holds one `gram_kernel` event for each launch in the
    traced region: CUPTI records the kernels launched through the ctypes
    library.  (Late in a long-lived process the profiler has dropped
    device records of a short region as outside its window: PERF.md.)"""
    proc = subprocess.run([sys.executable, "-c", _TRACE_JOB, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    grams = [k for k in out["kernels"] if "gram_kernel" in k]
    assert len(grams) == 3, out["kernels"]
    assert out["region"]


def test_complement_precision_matches_plain_version(dev):
    spec, p, x = _field(dev, 2000, seed=1)
    nv = torch.full((2000,), 0.01, device=dev)
    before = G.LAUNCHES
    P = acq.complement_precision(spec, p, x, nv)
    assert G.LAUNCHES == before + 1
    # the plain version: the same function through the plain Gram, on the card
    K = G.gram_reference(spec, p, x, x) + torch.diag(nv)
    want = torch.cholesky_inverse(torch.linalg.cholesky(K))
    assert (P - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.allclose(P, P.mT, rtol=0, atol=1e-4 * want.abs().max().item())
