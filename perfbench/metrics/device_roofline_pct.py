"""The least time of the window's searches on the card
(``perfbench/harness/work.py``: DP cells from the grids' shapes at 2 int32
operations each over the frozen int32 rate, or the genome read once at the
memory rate, whichever is longer) over the device's busy time, in %."""


def read(w):
    if w.trace is None or not w.trace.busy_s:
        return None
    return 100.0 * sum(r.least_s for r in w.done) / w.trace.busy_s
