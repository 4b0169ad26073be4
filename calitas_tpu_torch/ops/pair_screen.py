"""Pair-batched glocal-DP screening: a query AND a target per row.

Port of ``calitas_tpu/ops/pair_screen.py``.  PairwiseAlignSequences and
AlignToReference align a different query against each target, so one
screen computes, exactly in int32, both chains' best final-row DP scores
(and, on request, each chain's qualifying end-column range) for
thousands of (query, target) rows at once: chain A = DP(query, target),
chain B = DP(revcomp(query), target), score-equivalent to the engine's
other strand pass.

Rows are bucketed by (query length, target slot), as the reference does;
each bucket is cut into chunks of ``batch_rows`` rows, and each chunk is
one per-row-query launch of the CUDA row screen
(``ops/dp_cuda.py::screen_rows``), or its plain PyTorch version on the
CPU and, on CUDA, for queries longer than the kernel takes.  Every chunk
launches before any resolves, each with one pinned non-blocking
readback.  The reference pads each chunk to a power of two for XLA's
per-shape compiles; the port needs no padding.  Each chunk's shape (rows,
slot, Q, ranges, route) is logged at DEBUG on the
``calitas_tpu_torch.screen`` logger.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from calitas_tpu_torch.align.engine import NO_SCREEN
from calitas_tpu_torch.core.scoring import Scorer
from calitas_tpu_torch.core.sequence import TARGET_MASK_TABLE, encode_query, revcomp
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops.dp_screen import screen_rows_reference


class PairScreen:
    """Batched exact DP maxima for heterogeneous (query, target) pairs on
    ``device``.

    ``chain_maxima(queries, targets)`` returns two int64 arrays [N]: the
    chain A (query vs target) and chain B (revcomp(query) vs target)
    final-row DP maxima for every pair, in input order."""

    MIN_SLOT = 64
    MAX_SLOT = 8192  # longer targets are reported as unscreened
    NO_SCREEN = NO_SCREEN  # sentinel: caller must run the pass unaided

    def __init__(self, scorer: Scorer, device, batch_rows: int = 1 << 15):
        if batch_rows < 1:
            raise ValueError("batch_rows must be >= 1")
        self.scorer = scorer
        self.device = torch.device(device)
        self.batch_rows = batch_rows

    def chain_maxima(
        self, queries: list[str], targets: list
    ) -> tuple[np.ndarray, np.ndarray]:
        return self.chain_maxima_ranges(queries, targets, None)[:2]

    def buckets(self, queries: list[str], targets: list):
        """``({(query length, slot): [row, ...]}, target bytes per row)``:
        the screenable rows by bucket, in input order.  Unscreenable rows
        (empty query or target, target longer than MAX_SLOT) are in no
        bucket; the slot is the smallest power of two >= MIN_SLOT that
        holds the target."""
        buckets: dict[tuple[int, int], list[int]] = {}
        tbytes: list[bytes] = []
        for i, (q, t) in enumerate(zip(queries, targets)):
            tb = t if isinstance(t, (bytes, bytearray)) else str(t).encode("ascii")
            tbytes.append(bytes(tb))
            if not q or not tb or len(tb) > self.MAX_SLOT:
                continue
            slot = self.MIN_SLOT
            while slot < len(tb):
                slot *= 2
            buckets.setdefault((len(q), slot), []).append(i)
        return buckets, tbytes

    def chain_maxima_ranges(
        self,
        queries: list[str],
        targets: list,
        min_scores: Optional[list] = None,
    ) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Chain maxima plus, when ``min_scores`` is given (one qualifying
        threshold per pair), the per-chain qualifying end-column ranges.

        Returns ``(best_a, best_b, ranges)`` with ranges int32 [N, 4] =
        (loA, hiA, loB, hiB): 1-based inclusive end columns of the pair's
        target whose chain final-row DP score reaches the pair's
        threshold (lo > hi when none).  Unscreenable pairs keep the
        NO_SCREEN sentinel in best_* and -1s in ranges.  With
        ``min_scores=None``, ranges is None."""
        n = len(queries)
        best_a = np.full(n, self.NO_SCREEN, dtype=np.int64)
        best_b = np.full(n, self.NO_SCREEN, dtype=np.int64)
        out_ranges = (
            np.full((n, 4), -1, dtype=np.int32) if min_scores is not None else None
        )
        buckets, tbytes = self.buckets(queries, targets)
        s = self.scorer
        skw = dict(match=s.match_score, mismatch=s.mismatch_score,
                   qgap=s.query_gap_score, tgap=s.target_gap_score)
        dev = self.device
        qcache: dict[str, np.ndarray] = {}
        routes: dict[int, bool] = {}
        launched = []  # (rows, resolve)
        for (Q, slot), idxs in buckets.items():
            if Q not in routes:
                routes[Q] = dp_cuda.log_route("Pair screen", Q, self.device)
            kernel = routes[Q]
            screen = dp_cuda.screen_rows if kernel else screen_rows_reference
            for c0 in range(0, len(idxs), self.batch_rows):
                rows = np.asarray(idxs[c0 : c0 + self.batch_rows], dtype=np.int64)
                B = len(rows)
                qv = np.empty((2, B, Q), dtype=np.uint8)
                tm = np.zeros((B, slot), dtype=np.uint8)
                ln = np.empty(B, dtype=np.int32)
                for r, i in enumerate(rows.tolist()):
                    q = queries[i]
                    if q not in qcache:
                        qcache[q] = np.stack(
                            [encode_query(q), encode_query(revcomp(q))]
                        )
                    qv[:, r] = qcache[q]
                    t = np.frombuffer(tbytes[i], dtype=np.uint8)
                    tm[r, : len(t)] = TARGET_MASK_TABLE[t]
                    ln[r] = len(t)
                ms = None
                if min_scores is not None:
                    ms = dp_cuda.to_device(
                        np.asarray([int(min_scores[i]) for i in rows.tolist()],
                                   dtype=np.int32), dev,
                    )
                dp_cuda.logger.debug(
                    "Pair screen chunk: %d rows, slot %d, Q %d, ranges %s, %s", B, slot,
                    Q, ms is not None, "CUDA kernel" if kernel else "plain screen",
                )
                best, ranges = screen(
                    dp_cuda.to_device(qv, dev), dp_cuda.to_device(tm, dev),
                    dp_cuda.to_device(ln, dev), ms, **skw,
                )
                out = (best,) if ranges is None else (best, ranges)
                launched.append((rows, dp_cuda.readback(out, lambda *a: a)))
        for rows, resolve in launched:
            res = resolve()
            best_a[rows] = res[0][0]
            best_b[rows] = res[0][1]
            if out_ranges is not None:
                r = res[1]  # [chain, (min, max), row]
                out_ranges[rows] = np.stack([r[0, 0], r[0, 1], r[1, 0], r[1, 1]], axis=1)
        return best_a, best_b, out_ranges


def pass_bounds_for(guide, chain_a: int, chain_b: int) -> dict:
    """Map the two chain maxima onto the engine's strand passes.

    Chain A (the DP-orientation query over the forward target) IS the
    engine's rev pass for 5'-PAM guides and the fwd pass otherwise;
    chain B is the score-equivalent of the other pass.  ``NO_SCREEN``
    chain values map to an unbounded pass (the caller must run it)."""
    if guide.pam_is_5prime:
        return {"rev": chain_a, "fwd": chain_b}
    return {"fwd": chain_a, "rev": chain_b}
