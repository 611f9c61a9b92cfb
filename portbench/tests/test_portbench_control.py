"""On the card: each cell's control (its driver's `control_answer`,
computed with TF32 matmuls) fails the cell's check at the cell's own
size.  Skips without a card."""

import math

import pytest

from portbench import harness

M = harness.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails_the_check(cell, card):
    w = harness.cell(M, cell)
    cfg, tr = harness.config(M, w["config"]), harness.traffic(w["traffic"])
    lim = harness.limits(cell)
    drv = harness.driver(tr["driver"]).make(cfg, tr, 2 ** 34 + 5, card)
    drv.setup()
    worst = {}
    for i in range(2):
        for k, v in drv.check(i, drv.control_answer(i)).items():
            worst[k] = max(worst.get(k, -math.inf), v)
    assert any(v > lim[k] for k, v in worst.items()), worst
