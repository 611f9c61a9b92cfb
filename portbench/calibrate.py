"""The readings that a cell's limits are set from, in one process: the
check's numbers of sound runs of the program over many seeds, of the
control (the driver's `control_answer`, computed with TF32 matmuls: the
plain reference in float32 put in the program's place, or the port
itself where the reference cannot factor in that precision) over a few,
and of a fault the driver lists (`faults(traffic)`) planted in the
program over a few.

    python3 -m portbench.calibrate --workload main10k.select \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3 \\
        --fault state_unchanged --fault-seeds 31,32,33

Prints one JSON line a seed ({"side": "program" | "control" | the fault,
"seed", the worst value of each number}) and writes them to
chiprun_out/calibrate_<workload>.jsonl.  A control that fails to give a
number has failed; it sets no upper reading.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        harness.log("portbench.calibrate needs a CUDA card")
        return 2
    dev = torch.device("cuda", 0)
    manifest = harness.load_manifest()
    out_path = harness.ROOT / "chiprun_out" / f"calibrate_{args.workload}.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faulted = [int(s) for s in args.fault_seeds.split(",") if s]
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        calls: list = []
        r = harness.run_cell(manifest, args.workload, seed, args.seconds, False, dev, t0,
                             details=calls)
        rows.append({"side": "program", "seed": seed, "correct": r["correct"],
                     **{k: v["value"] for k, v in r["checks"].items()},
                     **{k: v["value"] for k, v in r["metrics"].items()}, "calls": calls})
        _emit(rows[-1], out_path)
    w = harness.cell(manifest, args.workload)
    cfg = harness.config(manifest, w["config"])
    tr = harness.traffic(w["traffic"])
    drv_mod = harness.driver(tr["driver"])
    for side, seed in [("control", s) for s in controls] + [(args.fault, s) for s in faulted]:
        drv = drv_mod.make(cfg, tr, seed, dev)
        drv.setup()
        worst: dict = {}
        calls = []
        for i in range(int(tr["check_calls"])):
            try:
                a = drv.control_answer(i) if side == "control" else _faulted(drv_mod, tr, side, drv, i)
                got = {**drv.check(i, a), **drv.describe(a)}
            except Exception as exc:  # noqa: BLE001 - a crashed control has failed
                harness.log(f"{side} seed {seed} call {i}: {exc!r}")
                got = {"crashed": math.inf}
            calls.append({"call": i, **got})
            for k, v in got.items():
                if isinstance(v, float):
                    worst[k] = max(worst.get(k, -math.inf), v)
        rows.append({"side": side, "seed": seed,
                     **{k: (v if math.isfinite(v) else "inf") for k, v in worst.items()},
                     "calls": calls})
        _emit(rows[-1], out_path)
        del drv
        torch.cuda.empty_cache()
    return 0


def _faulted(drv_mod, traffic: dict, fault: str, drv, i: int):
    """Call i of the program with `fault` planted."""
    import pytest

    with pytest.MonkeyPatch.context() as mp:
        drv_mod.faults(traffic)[fault](mp)
        drv.call(i)
    return drv.answers.pop(i)


def _emit(row: dict, path: Path) -> None:
    line = json.dumps(row, default=str)
    print(line, flush=True)
    with path.open("a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    sys.exit(main())
