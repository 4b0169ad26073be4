"""The control of ``correct``, run on the card at a cell's own size:

    python3 perfbench/control.py --workload CELL --seconds S --seeds N [N ...]

For each seed it runs the cell as ``run.py`` does, with the program asked
for one guide diff fewer than the traffic states (the step a later change
might take to make the screen cheaper), and holds the tables to the
traffic's own limits.  Each seed prints one JSON line with the numbers
compared; the control has to come out not correct on every seed.  The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import device, procs, session, spec

    cell = spec.load_cell(args.workload, False)
    device.block_on_sync()
    if not torch.cuda.is_available():
        print("perfbench control: needs a CUDA device", file=sys.stderr)
        return 2
    control = dict(cell.traffic["search"])
    control["max_guide_diffs"] -= 1
    try:
        for seed in args.seeds:
            r = session.run(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                            search=control)
            print(json.dumps({"workload": cell.name, "seed": seed, "control": control,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "checks": r["checks"]}), flush=True)
    finally:
        procs.stop_processes()
    return 0


if __name__ == "__main__":
    sys.exit(main())
