"""Smoke test for examples/quickstart_torch.py, the twin of
tests/test_quickstart.py: the port's quickstart runs on the CPU in its own
process (section 9 starts a world of 2 gloo ranks), every numbered
section reaches its print, the resume walkthrough reports exactness and
the mesh episode samples the single-rank episode's sites."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart_runs_all_sections():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "quickstart_torch.py"),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    # every numbered milestone prints at line start; sections 3 and 4 share
    # one loop and print as "3/4."
    for label in [str(i) for i in range(1, 17) if i not in (3, 4)] + ["3/4"]:
        assert re.search(rf"^{re.escape(label)}\. ", out, re.M), (
            f"quickstart section {label} never printed"
        )
    assert "interrupted@3 + resume ≡ uninterrupted: True" in out
    assert "on a world of 2 ranks (paths ≡ single-device: True)" in out
