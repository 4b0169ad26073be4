"""The least time the card could take for a search, frozen here so that a
change to the program cannot move the yardstick.

The arithmetic is a copy of the port's ``ops/probes.py::grid_work`` and
``bound_ms``: a window grid's DP cells are both chains x the DP query's
length x every window's columns; each cell is 2 int32 operations (an add and
a max); the bytes are the genome span the windows cover, read once, the query
masks and thresholds, and the flags and ranges written once.  The least time
is the larger of the operations over the int32 rate and the bytes over the
memory rate.
"""

from __future__ import annotations

#: int32 add+max operations per second of one NVIDIA H100 80GB HBM3 at a
#: 700 W power limit: the port's peak probe (``csrc/probes.cu::peak_kernel``)
#: on a card-filling shape
INT32_OPS_PER_S = 3.18562e13
#: device memory bytes per second of the H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12


def n_windows(contig_length: int, step: int) -> int:
    """Upstream's window starts ``range(0, length - 1, step)``."""
    return len(range(0, max(contig_length - 1, 0), step))


def grid_work(contig_length: int, step: int, window: int, q_len: int,
              guides: int = 1) -> tuple:
    """``(int32 ops, bytes)`` of one contig's screen (both chains, every
    guide, ranges on)."""
    n = n_windows(contig_length, step)
    cells = guides * 2 * q_len * n * window
    span = min(contig_length, (n - 1) * step + window) if n else 0
    out = guides * 2 * n * 4 * 3
    return 2 * cells, span + guides * (2 * q_len * 4 + 4) + out


def least_seconds(contig_lengths, step: int, window: int, q_len: int,
                  guides: int = 1) -> float:
    """The least time of one search over every contig: the larger of its
    operations over :data:`INT32_OPS_PER_S` and its bytes over
    :data:`HBM_BYTES_PER_S`."""
    ops = nbytes = 0
    for length in contig_lengths:
        o, b = grid_work(length, step, window, q_len, guides)
        ops, nbytes = ops + o, nbytes + b
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
