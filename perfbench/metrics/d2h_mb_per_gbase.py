"""Megabytes the screen's readbacks brought to the host over the window's
searches (the program's ``d2h_bytes`` counter, counted per segment in
``ops/dp_cuda.py::readback``: packed flags and coarse ranges of every
window) per 1e9 genome bases x guides searched."""

from perfbench.harness.program_spans import window_counts


def read(w):
    c = window_counts(w)
    gbases = sum(r.gbases for r in w.done)
    if not c or not c.get("d2h_bytes") or not gbases:
        return None
    return c["d2h_bytes"] / 1e6 / gbases
