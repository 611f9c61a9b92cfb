"""Run one benchmark cell once and print its result as the last line.

    python3 -m portbench.run --workload main10k.fit_select --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout that holds the port (`algp_tpu_torch`).
Needs as many CUDA cards as the cell asks for; without them it exits
with code 2 and prints no result.  Set-up (`setup_s`) is counted from
this module's first line to the first timed call.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    manifest = harness.load_manifest()
    w = harness.cell(manifest, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        harness.log(f"portbench: cell {args.workload} needs {w['chips']} CUDA "
                    f"card(s); torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}, device_count "
                    f"{torch.cuda.device_count()}")
        return 2
    result = harness.run_cell(manifest, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"portbench: the run loaded {found}; nothing it runs may "
                    "import JAX or the JAX package")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
