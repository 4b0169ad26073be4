"""One traced run of a cell, as ``run.py --trace 1`` makes it, that also
reads the program's own spans:

    python3 perfbench/trace_spans.py --workload CELL --seed N --seconds S --spans 0|1

With ``--spans 1`` the program records its spans (``calitas_tpu_torch/
spans.py``) from before set-up, so they sit in the window's trace beside
the device's work.  The last line of standard output is the result line of
``run.py --trace 1`` with ``spans`` added: the device's idle time split by
what the searching thread was doing (``idle_<class>_pct``, % of the window,
:func:`perfbench.harness.program_spans.idle_by_class`; the classes sum to
``device_idle_pct``) and by the span it was in (``idle_pct_by_span``), the
spans recorded per request of the window, and each span's count and self
seconds per request.  With ``--spans 0`` it is
the same traced run with the spans off: the pair gives their cost.  The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def run_traced(cell, seed: int, seconds: float, spans_on: bool, device: str,
               t_start: float) -> dict:
    """``session.run`` of a traced run, with the program's spans on or off
    from before set-up; the result with ``spans`` added."""
    from calitas_tpu_torch import spans

    from perfbench.harness import program_spans, session, trace

    captured = {}

    def events_of(profiler):
        captured["events"] = program_spans.events_of(profiler)
        return trace.events_of(profiler)

    real = session.events_of
    session.events_of = events_of
    if spans_on:
        spans.enable()
    try:
        result = session.run(cell, seed, seconds, True, device, t_start)
    finally:
        session.events_of = real
        spans.disable()
    records = spans.drain()
    window = spans.requests()[-result["attempted"]:]  # set-up's searches come first
    ids = {p.id for p in window}
    mine = [r for r in records if r.request in ids]
    own = spans.self_ns(mine)
    by_name: dict = {}
    for r in mine:
        n, s = by_name.get(r.name, (0, 0.0))
        by_name[r.name] = (n + 1, s + own[r.id] / 1e9)
    n_req = max(len(window), 1)
    by_span = program_spans.idle_by_span(captured["events"])
    split = program_spans.idle_by_class(by_span)
    window_s = result["device"]["window_s"]
    result["spans"] = {
        "on": spans_on,
        "requests": len(window),
        "per_request": len(mine) / n_req,
        "by_name": {k: {"count": n / n_req, "self_s": s / n_req}
                    for k, (n, s) in sorted(by_name.items())},
        **({f"idle_{c}_pct": 100.0 * s / window_s for c, s in split.items()}
           if split else {}),
        "idle_pct_by_span": ({k or "(none)": 100.0 * s / window_s
                              for k, s in sorted(by_span.items(), key=lambda x: -x[1])}
                             if by_span else {}),
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/trace_spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import device, procs, spec

    cell = spec.load_cell(args.workload, True)
    device.block_on_sync()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench trace_spans: {args.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    try:
        result = run_traced(cell, args.seed, args.seconds, bool(args.spans), "cuda", T_START)
    finally:
        procs.stop_processes()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
