"""algp_tpu_torch stands alone: it never imports JAX, networkx or pandas
at import (the machine with the card has neither JAX nor networkx, and
pandas is not known to be there), nor Triton or matplotlib, and it keeps
out of the paths that would not be a port of the reference's kernels."""

import io
import subprocess
import sys
import tokenize
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "algp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import algp_tpu_torch, algp_tpu_torch.acquisition, algp_tpu_torch.field\n"
        "import algp_tpu_torch.convert, algp_tpu_torch.ops, algp_tpu_torch.ops.chol\n"
        "import algp_tpu_torch.cli, algp_tpu_torch.episode, algp_tpu_torch.planning\n"
        "import algp_tpu_torch.native, algp_tpu_torch.utils.checkpoint\n"
        "import algp_tpu_torch.acquisition_lowrank, algp_tpu_torch.models.sparse_gp\n"
        "import algp_tpu_torch.utils.metrics, algp_tpu_torch.models.multifit\n"
        "import algp_tpu_torch.models.coregional, algp_tpu_torch.models.networks\n"
        "import algp_tpu_torch.parallel, algp_tpu_torch.parallel.launch\n"
        "import algp_tpu_torch.parallel.dryrun\n"
        "import algp_tpu_torch.utils.debug, algp_tpu_torch.utils.profiling\n"
        "import algp_tpu_torch.utils.plotting\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'optax', 'algp_tpu', 'triton', 'networkx', 'pandas', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _code_names(path: Path) -> list[str]:
    """The NAME tokens of a file: identifiers and keywords, no comments,
    no strings."""
    toks = tokenize.generate_tokens(io.StringIO(path.read_text()).readline)
    return [t.string for t in toks if t.type == tokenize.NAME]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_library_kernels_or_silent_fallbacks(path):
    names = _code_names(path)
    for banned in ("cdist", "scaled_dot_product_attention", "optim", "jax", "pandas"):
        assert banned not in names, f"{path.name} uses {banned}"
    for a, b in zip(names, names[1:]):
        assert (a, b) != ("torch", "compile"), f"{path.name} uses torch.compile"
    if path.parent.name == "ops":
        # a kernel that fails to build or launch raises; nothing catches it
        assert "except" not in names, f"{path.name} catches an exception"
