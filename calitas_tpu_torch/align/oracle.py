"""Exact glocal DP with multi-end traceback — the correctness oracle.

Reimplements the observable contract of the fgbio ``Aligner`` in Glocal
mode with linear gap costs (SURVEY.md §2.9.1): the query is aligned
globally, the target locally, and ``align(query, target, min_score)``
returns one alignment for **every** valid alignment *end* column whose
best score is >= min_score — the completeness guarantee the sequential
search relies on (SequentialGuideAligner.scala:255-259).

Formulation: a single (Q+1, T+1) int32 score matrix

    S[0, j] = 0                      (alignment may start at any target pos)
    S[i, 0] = i * target_gap         (consume query with gaps in target)
    S[i, j] = max( S[i-1, j-1] + pair(q[i-1], t[j-1]),
                   S[i-1, j  ] + target_gap,    # 'I': gap in target
                   S[i,   j-1] + query_gap )    # 'D': gap in query

With linear gaps this is equivalent to the affine (Gotoh) formulation with
open == extend.  The row fill is fully vectorized: the in-row left-move
recurrence max_k<=j (tmp[k] + (j-k)*qgap) is computed as
``np.maximum.accumulate(tmp - j*qgap) + j*qgap``.

Traceback tie-break preference (which move wins when several predecessors
achieve the cell score) is Diagonal > Left(D) > Up(I), which reproduces
the gap placements pinned by the reference's test suite
(SequentialGuideAlignerTest.scala:339-349 among others).

The empty-target-span end column j == 0 (the whole query as one gap) is
never reported.
"""

from __future__ import annotations

import numpy as np

from calitas_tpu_torch.core.cigar import Cigar, CigarElem
from calitas_tpu_torch.core.scoring import Scorer
from calitas_tpu_torch.align.alignment import Alignment

NEG_INF = np.int32(-(2**30))


def dp_matrix(
    qmask: np.ndarray,  # uint8 [Q] query IUPAC masks (uppercase guide)
    tmask: np.ndarray,  # uint8 [T] target masks (N -> 0)
    scorer: Scorer,
) -> np.ndarray:
    """Fill the full (Q+1, T+1) int32 glocal score matrix."""
    Q, T = len(qmask), len(tmask)
    m = np.int32(scorer.match_score)
    mm = np.int32(scorer.mismatch_score)
    qg = np.int32(scorer.query_gap_score)
    tg = np.int32(scorer.target_gap_score)

    # pair[i, j] = score of query i vs target j
    compat = (qmask[:, None] & tmask[None, :]) != 0
    pair = np.where(compat, m, mm).astype(np.int32)

    S = np.zeros((Q + 1, T + 1), dtype=np.int32)
    jdec = (np.arange(T + 1, dtype=np.int64) * int(qg)).astype(np.int64)
    for i in range(1, Q + 1):
        prev = S[i - 1]
        tmp = np.empty(T + 1, dtype=np.int64)
        tmp[0] = int(prev[0]) + int(tg)
        np.maximum(prev[:-1].astype(np.int64) + pair[i - 1], prev[1:] + int(tg), out=tmp[1:])
        # left-move closure: S[i, j] = max_{k<=j} tmp[k] + (j-k)*qg
        S[i] = (np.maximum.accumulate(tmp - jdec) + jdec).astype(np.int32)
    return S


def traceback(
    S: np.ndarray,
    qmask: np.ndarray,
    tmask: np.ndarray,
    scorer: Scorer,
    end_col: int,
) -> tuple[int, Cigar]:
    """Trace one alignment ending at target column ``end_col`` (1-based
    inclusive of consumed target).  Returns (target_start_1based, cigar)."""
    m = scorer.match_score
    mm = scorer.mismatch_score
    qg = scorer.query_gap_score
    tg = scorer.target_gap_score

    i = len(qmask)
    j = end_col
    ops: list[str] = []
    while i > 0:
        s = int(S[i, j])
        if j > 0:
            compat = bool(qmask[i - 1] & tmask[j - 1])
            if s == int(S[i - 1, j - 1]) + (m if compat else mm):
                ops.append("=" if compat else "X")
                i -= 1
                j -= 1
                continue
            if s == int(S[i, j - 1]) + qg:
                ops.append("D")
                j -= 1
                continue
        if s == int(S[i - 1, j]) + tg:
            ops.append("I")
            i -= 1
            continue
        raise AssertionError("traceback: no predecessor reproduces cell score")
    ops.reverse()
    cigar = Cigar(tuple(CigarElem(op, 1) for op in ops)).coalesce()
    return j + 1, cigar


def glocal_align_multi(
    query: bytes,
    target: bytes,
    qmask: np.ndarray,
    tmask: np.ndarray,
    scorer: Scorer,
    min_score: int,
) -> list[Alignment]:
    """All alignments, one per end column with score >= min_score, in
    ascending end-column order (fgbio ``align(query, target, minScore)``).

    Uses the native C++ engine when available (identical algorithm and
    tie-breaks); falls back to the vectorized NumPy DP."""
    if len(qmask) == 0 or len(tmask) == 0:
        return []
    native = _native_align_multi(query, target, qmask, tmask, scorer, min_score)
    if native is not None:
        return native
    S = dp_matrix(qmask, tmask, scorer)
    final = S[len(qmask)]
    out: list[Alignment] = []
    for j in np.nonzero(final[1:] >= min_score)[0] + 1:
        j = int(j)
        tstart, cigar = traceback(S, qmask, tmask, scorer, j)
        out.append(
            Alignment(
                query=query,
                target=target,
                query_start=1,
                target_start=tstart,
                cigar=cigar,
                score=int(final[j]),
            )
        )
    return out


def _native_align_multi(
    query: bytes,
    target: bytes,
    qmask: np.ndarray,
    tmask: np.ndarray,
    scorer: Scorer,
    min_score: int,
) -> list[Alignment] | None:
    """C++ fast path; returns None when the native library is unavailable."""
    import ctypes

    from calitas_tpu_torch import native

    lib = native.get_lib()
    if lib is None:
        return None
    Q, T = len(qmask), len(tmask)
    qm = np.ascontiguousarray(qmask, dtype=np.uint8)
    tm = np.ascontiguousarray(tmask, dtype=np.uint8)
    max_hits = 64
    while True:
        scores = np.empty(max_hits, np.int32)
        ends = np.empty(max_hits, np.int32)
        starts = np.empty(max_hits, np.int32)
        ops_cap = max_hits * (Q + 64)
        ops = ctypes.create_string_buffer(ops_cap)
        ops_off = np.empty(max_hits, np.int32)
        ops_len = np.empty(max_hits, np.int32)
        n = lib.dp_align_multi(
            qm, Q, tm, T,
            scorer.match_score, scorer.mismatch_score,
            scorer.query_gap_score, scorer.target_gap_score,
            int(min_score), max_hits,
            scores, ends, starts, ops, ops_cap, ops_off, ops_len,
        )
        if n == -1:  # not enough space; grow and retry
            max_hits *= 4
            continue
        if n < 0:
            raise AssertionError(f"native aligner error: {n}")
        break
    from itertools import groupby

    out: list[Alignment] = []
    raw = ops.raw
    for k in range(n):
        op_str = raw[ops_off[k] : ops_off[k] + ops_len[k]].decode("ascii")
        cigar = Cigar(
            tuple(
                CigarElem(op, sum(1 for _ in grp))
                for op, grp in groupby(op_str)
            )
        )
        out.append(
            Alignment(
                query=query,
                target=target,
                query_start=1,
                target_start=int(starts[k]),
                cigar=cigar,
                score=int(scores[k]),
            )
        )
    return out
