"""The genome search on the device screen plus the native host finish.

Port of ``calitas_tpu/parallel/screen_runner.py``'s production path:
each contig is staged once; every guide's segmented screen is launched
before any finishing starts, so the device works through all guides'
segments back to back while the host worker pool finishes earlier
segments' candidate windows with the batched native aligner
(``calitas_tpu.parallel.host_pool``).  Only flagged windows are
materialized, with the reference's exact window semantics, so the output
equals the host-only engine's row for row.

Guides of one shape (DP-query length, window step and PAM spec) form a
group: a group of two or more runs the multi-guide kernel, one launch
per segment for the whole group, and a single guide runs the dual-chain
kernel.  Each segment's readback resolves once; every guide of the group
reads its own slice of that one result.  A group whose DP query is longer
than the kernels take runs the plain PyTorch screen on the same device;
the route is chosen and logged once per group, before any launch.

Device, build and launch errors propagate: nothing here degrades to the
host engine.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from calitas_tpu.align.engine import SequentialAligner
from calitas_tpu.core.guide import Guide
from calitas_tpu.core.sequence import revcomp
from calitas_tpu.io.fasta import IndexedFasta
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops.genome_screen import GenomeScreen, range_block

logger = logging.getLogger("calitas_tpu_torch.SearchReference")

#: candidates per array-batch item shipped to the finish workers (one
#: columnar RenderedBlock comes back per item)
_CAND_BATCH = 1024

#: threads that wait on segment readbacks ahead of the candidate stream
_RESOLVERS = 4


@dataclass(frozen=True)
class GuideTask:
    """One guide's search parameters within a (possibly multi-guide) run."""

    guide_id: str
    guide: Guide
    guide_length: int  # raw guide-string length (window length filter)
    step_size: int  # window step for this guide's overlap math


def screened_search(
    fasta: IndexedFasta,
    chrom: Optional[str],
    tasks: Sequence[GuideTask],
    aligner: SequentialAligner,
    *,
    screen: GenomeScreen,
    window_size: int,
    hit_spec: dict,
    threads: int = 1,
    swallow_errors: bool = False,
    **align_kwargs,
) -> Iterator[tuple]:
    """Search every contig with the device screen + batched native
    finish; yields ``(task, chrom, start, rows)`` where rows is a
    RenderedBlock of finished 34-column rows.  ``hit_spec`` carries the
    run-scoped row fields (ref_path, aligner_id, arguments, vcf_id,
    timestamp, aligner_version).  Contigs outer (staged once), guides
    inner."""
    names = [chrom] if chrom is not None else fasta.names
    groups = _guide_groups(tasks, align_kwargs)
    for (q_len, _step, _pspec), group in groups.items():
        dp_cuda.log_route(
            "Screen of guides " + ",".join(t.guide_id for _ti, t, _dq in group),
            q_len, screen.device,
        )

    # A one-slot staging thread reads and uploads contig N+1 while contig
    # N is screened and finished (at most two staged contigs live on the
    # device at once).
    def stage_contig(name: str):
        contig_len = fasta.sequence_length(name) or 0
        if contig_len < 2:
            return name, contig_len, None  # too short to search
        return name, contig_len, screen.stage(fasta.get_bases(name))

    stager = ThreadPoolExecutor(max_workers=1, thread_name_prefix="calitas-stage")
    try:
        nxt = stager.submit(stage_contig, names[0]) if names else None
        for idx in range(len(names)):
            name, contig_len, genome = nxt.result()
            nxt = (
                stager.submit(stage_contig, names[idx + 1])
                if idx + 1 < len(names)
                else None
            )
            if genome is None:
                continue
            yield from _search_contig(
                fasta, name, contig_len, genome, tasks, groups, aligner,
                screen, window_size, threads, swallow_errors, hit_spec,
                align_kwargs,
            )
    finally:
        stager.shutdown(wait=True, cancel_futures=True)


def _dp_query_and_pam_spec(guide: Guide, align_kwargs: dict):
    """The DP-orientation query and PAM-gate spec of a guide: for 5'-PAM
    guides the DP query is the revcomp'd guide and its PAMs in DP space
    are the revcomp'd PAMs."""
    dq = guide.guide_rc if guide.pam_is_5prime else guide.guide_fw
    dp_pams = guide.pams_rc if guide.pam_is_5prime else guide.pams_fw
    pspec = (
        (
            tuple(dp_pams),
            align_kwargs["max_pam_diffs"],
            align_kwargs["max_gaps_between_guide_and_pam"],
        )
        if dp_pams
        else None
    )
    return dq, pspec


def _guide_groups(tasks, align_kwargs) -> dict:
    """Tasks grouped by screen shape: ``{(dp-query length, step, PAM
    spec): [(task index, task, dp query), ...]}``."""
    groups: dict[tuple, list] = {}
    for ti, task in enumerate(tasks):
        dq, pspec = _dp_query_and_pam_spec(task.guide, align_kwargs)
        groups.setdefault((len(dq), task.step_size, pspec), []).append(
            (ti, task, dq)
        )
    return groups


class _GuideSlice:
    """Guide ``gi``'s view of a group segment's readback: the group's
    Future resolves once, and each guide reads its own ``[gi]``."""

    def __init__(self, fut, gi: int):
        self._fut = fut
        self._gi = gi

    def result(self):
        chain_flags, ranges = self._fut.result()
        return chain_flags[self._gi], ranges[self._gi]


def _search_contig(
    fasta, name, contig_len, genome, tasks, groups, aligner, screen,
    window_size, threads, swallow_errors, hit_spec, align_kwargs,
):
    # Launch every group's segmented screen before finishing any: the
    # device runs all segments back to back while the host pool finishes
    # earlier ones.  Each segment's readback is submitted once to the
    # ordered resolver pool; its Future is the one shared result.
    resolver = ThreadPoolExecutor(
        max_workers=_RESOLVERS, thread_name_prefix="calitas-resolve"
    )
    try:
        seg_futs: dict[int, list] = {}  # task index -> [(i0, n_seg, fut)]
        for (_q, step, pspec), group in groups.items():
            mss = [
                aligner.min_guide_score(t.guide, align_kwargs["max_guide_diffs"])
                for _ti, t, _dq in group
            ]
            if len(group) >= 2:
                segs = screen.screen_contig_multi_async(
                    genome, contig_len, step,
                    [(dq, revcomp(dq)) for _ti, _t, dq in group], mss,
                    pam_spec=pspec,
                )
                futs = [(i0, n, resolver.submit(res)) for i0, n, res in segs]
                for gi, (ti, _t, _dq) in enumerate(group):
                    seg_futs[ti] = [(i0, n, _GuideSlice(f, gi)) for i0, n, f in futs]
            else:
                [(ti, _t, dq)] = group
                segs = screen.screen_contig_async(
                    genome, contig_len, step, dq, revcomp(dq), mss[0],
                    pam_spec=pspec,
                )
                seg_futs[ti] = [(i0, n, resolver.submit(res)) for i0, n, res in segs]
        for ti, task in enumerate(tasks):
            starts = screen.window_starts(contig_len, task.step_size)
            yield from _finish_segments(
                seg_futs[ti], starts, name, task, aligner, window_size,
                threads, swallow_errors, hit_spec, align_kwargs,
            )
    finally:
        resolver.shutdown(wait=False, cancel_futures=True)


def _finish_segments(
    seg_futs, starts, name, task, aligner, window_size, threads,
    swallow_errors, hit_spec, align_kwargs,
):
    """Consume a segmented contig screen: the candidate stream takes each
    segment's ``(chain_flags [2, n_seg], ranges [2, n_seg, 2])`` from its
    Future in window order, so the worker pool finishes segment N while
    the device screens segment N+1."""
    from calitas_tpu.parallel.host_pool import (
        _mp_finish_chunk,
        make_finish_spec,
        map_items_mp,
    )

    stats = {"cand": 0}
    rb = range_block(window_size)

    def cand_stream():
        for i0, _n_seg, fut in seg_futs:
            chain_flags, cranges = fut.result()
            hit_idx = np.nonzero(chain_flags.any(axis=0))[0]
            n_cand = len(hit_idx)
            stats["cand"] += n_cand
            if not n_cand:
                continue
            cstarts = starts[i0 + hit_idx]
            sel = (
                chain_flags[0, hit_idx].astype(np.uint8)
                + 2 * chain_flags[1, hit_idx].astype(np.uint8)
            )
            # Widen the coarse range blocks back to 1-based column bounds
            # (the worker trim-shifts, mirrors chain B and clips:
            # calitas_tpu/align/batch.py::chain_ranges_to_pass).
            cr = cranges[:, hit_idx, :].astype(np.int32) * rb
            cr4 = np.stack(
                [cr[0, :, 0] + 1, cr[0, :, 1] + rb,
                 cr[1, :, 0] + 1, cr[1, :, 1] + rb], axis=1
            )
            for c0 in range(0, n_cand, _CAND_BATCH):
                c1 = c0 + _CAND_BATCH
                yield ("__batch__", name, cstarts[c0:c1], sel[c0:c1],
                       cr4[c0:c1])

    spec = make_finish_spec(
        task.guide, aligner, align_kwargs,
        guide_id=task.guide_id,
        window_size=window_size,
        guide_length=task.guide_length,
        swallow_errors=swallow_errors,
        **hit_spec,
    )
    for (_tag, c, bstarts, *_rest), rows in map_items_mp(
        cand_stream(), spec, threads,
        worker_fn=_mp_finish_chunk,
        to_payload=lambda t: t,
        chunk=1,
        swallow_errors=swallow_errors,
        logger=logger,
    ):
        if len(rows):
            yield task, c, int(bstarts[0]) + 1, rows
    logger.info(
        "Screen %s/%s: %d of %d windows are candidates (%.2f%%).",
        name, task.guide_id, stats["cand"], len(starts),
        100.0 * stats["cand"] / max(len(starts), 1),
    )
