"""With the timed path broken underneath, a run comes out not correct:
once for each fault that a cell's traffic can have, planted in the
program at a small size on the CPU.  Each driver lists its own faults
(`faults(traffic)`: a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced, and where the
traffic fits, a fit whose steps leave it where it started).  The cells
run on one card, so no exchange between cards can be left out."""

import time

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import small

M = harness.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def _faults(cell: str) -> dict:
    tr = harness.traffic(harness.cell(M, cell)["traffic"])
    return harness.driver(tr["driver"]).faults(tr)


CASES = [(cell, fault) for cell in CELLS for fault in sorted(_faults(cell))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_comes_out_not_correct(cell, fault, monkeypatch, one_thread):
    _faults(cell)[fault](monkeypatch)
    r = harness.run_cell(M, cell, 2 ** 35 + 11, 0.3, False, "cpu", time.perf_counter(),
                         small(M, cell))
    assert not r["correct"], r["checks"]


def test_sound_run_is_correct(one_thread):
    r = harness.run_cell(M, CELLS[0], 2 ** 35 + 11, 0.3, False, "cpu", time.perf_counter(),
                         small(M, CELLS[0]))
    assert r["correct"], r["checks"]
    assert torch.get_num_threads() == 1
