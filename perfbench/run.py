"""The benchmark's one command:

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  ``CELL`` is a workload of ``BENCHMARK.json``.
With ``--trace 0`` the last line of standard output is the result with the
cell's end-to-end metrics; with ``--trace 1`` a ``torch.profiler`` trace of
the window gives its per-layer metrics, the device's busy and window seconds
and a breakdown.  The numbers compared for ``correct`` come last in the line
(``checks``) and as the last lines of standard error.  Without as many CUDA
cards as the cell asks for, or with JAX or the JAX package loaded, it exits
with a code other than 0 and prints no result.

Only the standard library is imported at the top: the program's finish pool
spawns workers that import this file again.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import device, procs, session, spec

    cell = spec.load_cell(args.workload, bool(args.trace))
    device.block_on_sync()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    try:
        result = session.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    finally:
        left = procs.stop_processes()
        if left:
            print(f"# stopped processes the run left: {left}", file=sys.stderr)
    found = session.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
