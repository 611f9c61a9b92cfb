"""algp_tpu_torch.utils.profiling on the CPU: the twin of
tests/test_utils.py's profiling case, and a trace written by `trace` that
holds an `annotate` region."""

import json

import numpy as np
import torch

from algp_tpu_torch.utils import profiling


def test_profiling_helpers():
    with profiling.annotate("test-region"):
        torch.sum(torch.ones(16))
    with profiling.trace(None):  # no-op path
        pass
    sw = profiling.Stopwatch().start()
    y = torch.sum(torch.ones(8))
    dt = sw.stop(wait_on=y)
    assert dt >= 0
    assert profiling.Stopwatch().start().stop(wait_on={"a": [y], "b": None}) >= 0
    med, result = profiling.timed(lambda a: a * 2, torch.ones(4), warmup=1, iters=3)
    assert med >= 0
    np.testing.assert_array_equal(result.numpy(), 2 * np.ones(4))


def test_trace_writes_the_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("algp-test-region"):
            torch.linalg.cholesky(torch.eye(8) * 2.0)
    files = sorted(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "algp-test-region" in names
    assert any(n and n.startswith("aten::linalg_cholesky") for n in names)
