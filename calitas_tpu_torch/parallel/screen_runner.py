"""The genome search on the device screen plus the native host finish.

Port of ``calitas_tpu/parallel/screen_runner.py``'s production path:
each contig is staged once; every guide's segmented screen is launched
before any finishing starts, so the device works through all guides'
segments back to back while the host worker pool finishes earlier
segments' candidate windows with the batched native aligner
(``parallel/host_pool.py``).  Only flagged windows are
materialized, with the reference's exact window semantics, so the output
equals the host-only engine's row for row.

Guides of one shape (DP-query length, window step and PAM spec) form a
group: a group of two or more runs the multi-guide kernel, one launch
per segment for the whole group, and a single guide runs the dual-chain
kernel.  Each segment's readback resolves once; every guide of the group
reads its own slice of that one result.  A group whose DP query is longer
than the kernels take runs the plain PyTorch screen on the same device;
the route is chosen and logged once per group, before any launch.  With
a mesh of two or more devices (``parallel/mesh.py``) the screen is a
:class:`~calitas_tpu_torch.ops.genome_screen.ShardedGenomeScreen`, which
splits each segment into one span per mesh entry.

A device fault degrades, as the reference's does
(``utils.degradable``), and each one logs a WARNING and counts one in
``utils.DEGRADED``: a contig whose staging fails, or a guide group whose
segmented screen does not launch, is aligned on the host window by
window; a segment whose readback fails sends that segment and every
later one of the contig to the host unscreened, while earlier segments
keep their flags.  The host finish of an unscreened window is the host
engine's, so the table does not change.  A kernel that does not build or
launch (``utils.KernelError``) or that faults while it runs
(``utils.kernel_execution_fault``), a query the kernels do not take
(``NotImplementedError``) and programming errors propagate.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from calitas_tpu_torch import spans
from calitas_tpu_torch.align.engine import SequentialAligner
from calitas_tpu_torch.core.guide import Guide
from calitas_tpu_torch.core.sequence import revcomp
from calitas_tpu_torch.io.fasta import IndexedFasta
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops.genome_screen import GenomeScreen, range_block
from calitas_tpu_torch.utils import degradable, note_degraded

logger = logging.getLogger("calitas_tpu_torch.SearchReference")

#: candidates per array-batch item shipped to the finish workers (one
#: columnar RenderedBlock comes back per item)
_CAND_BATCH = 1024

#: threads that wait on segment readbacks ahead of the candidate stream
_RESOLVERS = 4

#: a ``prestaged`` value: the contig is not resident (its staging failed
#: in a resident server) and is aligned on the host, without a new staging
HOST_ONLY = object()

_SKIP = object()  # a contig too short to search


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
    window_size: int,
    hit_spec: dict,
    screen: GenomeScreen,
    threads: int = 1,
    swallow_errors: bool = False,
    prestaged: Optional[dict] = None,
    **align_kwargs,
) -> Iterator[tuple]:
    """Search every contig with the device screen + batched native
    finish; yields ``(task, chrom, start, rows)`` where rows is a
    RenderedBlock of finished 34-column rows.  ``hit_spec`` carries the
    run-scoped row fields (ref_path, aligner_id, arguments, vcf_id,
    timestamp, aligner_version).  Contigs outer (staged once), guides
    inner.  ``screen`` is a :class:`GenomeScreen`, or a
    :class:`~calitas_tpu_torch.ops.genome_screen.ShardedGenomeScreen` that splits each segment over a mesh.
    ``prestaged`` maps contig names to arrays that the
    screen's ``stage`` already made (a resident genome), or to
    :data:`HOST_ONLY`: those contigs are neither read nor staged again,
    and the screens never write into them (PAM bits go into a copy per
    guide group)."""
    names = [chrom] if chrom is not None else fasta.names
    groups = _guide_groups(tasks, align_kwargs)
    for (q_len, _step, _pspec), group in groups.items():
        dp_cuda.log_route(
            "Screen of guides " + ",".join(t.guide_id for _ti, t, _dq in group),
            q_len, screen.device,
        )

    # A one-slot staging thread reads and uploads contig N+1 while contig
    # N is screened and finished (at most two staged contigs live on the
    # device at once, besides the resident ones).  A genome of None means
    # the contig is aligned on the host.
    def stage_contig(name: str):
        contig_len = fasta.sequence_length(name) or 0
        if contig_len < 2:
            return name, contig_len, _SKIP  # too short to search
        genome = (prestaged or {}).get(name)
        if genome is HOST_ONLY:
            logger.info("Contig %s is not resident; aligning it on the host.", name)
            return name, contig_len, None
        if genome is None:
            try:
                genome = screen.stage(fasta.get_bases(name))
            except Exception as ex:
                if not degradable(ex):
                    raise
                note_degraded(
                    "staging", logger,
                    "Device staging failed for %s; falling back to host alignment.",
                    name,
                )
        return name, contig_len, genome

    stager = ThreadPoolExecutor(max_workers=1, thread_name_prefix="calitas-stage")
    try:
        nxt = stager.submit(stage_contig, names[0]) if names else None
        for idx in range(len(names)):
            with spans.span("stage_wait"):
                name, contig_len, genome = nxt.result()
            nxt = (
                stager.submit(stage_contig, names[idx + 1])
                if idx + 1 < len(names)
                else None
            )
            if genome is _SKIP:
                continue
            with spans.span("contig"):
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
    Future resolves once, and each guide reads its own ``[gi]`` (None when
    the readback degraded)."""

    def __init__(self, fut, gi: int):
        self._fut = fut
        self._gi = gi

    def result(self):
        res = self._fut.result()
        if res is None:
            return None
        chain_flags, ranges = res
        return chain_flags[self._gi], ranges[self._gi]


def _guarded(resolve, name: str, group, i0: int):
    """A segment's readback, or None when the device failed it (logged
    and counted once for the whole guide group)."""
    try:
        return resolve()
    except Exception as ex:
        if not degradable(ex):
            raise
        note_degraded(
            "readback", logger,
            "Device screen unavailable for %s/%s (segment at window %d); "
            "aligning remaining windows on the host.",
            name, ",".join(t.guide_id for _ti, t, _dq in group), i0,
        )
        return None


def _search_contig(
    fasta, name, contig_len, genome, tasks, groups, aligner, screen,
    window_size, threads, swallow_errors, hit_spec, align_kwargs,
):
    # Launch every group's segmented screen before finishing any: the
    # device runs all segments back to back while the host pool finishes
    # earlier ones.  Each segment's readback is submitted once to the
    # ordered resolver pool; its Future is the one shared result.
    # A future of None marks a span the host aligns unscreened.
    resolver = ThreadPoolExecutor(
        max_workers=_RESOLVERS, thread_name_prefix="calitas-resolve"
    )
    try:
        seg_futs: dict[int, list] = {}  # task index -> [(i0, n_seg, fut)]
        for (_q, step, pspec), group in groups.items():
            segs = None
            if genome is not None:
                try:
                    segs = _launch_group(
                        screen, genome, contig_len, step, pspec, group, aligner,
                        align_kwargs,
                    )
                except Exception as ex:
                    if not degradable(ex):
                        raise
                    note_degraded(
                        "launch", logger,
                        "Device screen unavailable for %s/%s; aligning every "
                        "window on the host.",
                        name, ",".join(t.guide_id for _ti, t, _dq in group),
                    )
            if segs is None:
                n = len(screen.window_starts(contig_len, step))
                for ti, _t, _dq in group:
                    seg_futs[ti] = [(0, n, None)]
                continue
            futs = [(i0, n, resolver.submit(_guarded, res, name, group, i0))
                    for i0, n, res in segs]
            if len(group) >= 2:
                for gi, (ti, _t, _dq) in enumerate(group):
                    seg_futs[ti] = [(i0, n, _GuideSlice(f, gi)) for i0, n, f in futs]
            else:
                seg_futs[group[0][0]] = futs
        for ti, task in enumerate(tasks):
            starts = screen.window_starts(contig_len, task.step_size)
            yield from _finish_segments(
                seg_futs[ti], starts, name, task, aligner, window_size,
                threads, swallow_errors, hit_spec, align_kwargs,
            )
    finally:
        resolver.shutdown(wait=False, cancel_futures=True)


def _launch_group(screen, genome, contig_len, step, pspec, group, aligner,
                  align_kwargs) -> list:
    """Launch a guide group's segmented screen: the multi-guide screen for
    two or more guides, the dual-chain one for one; ``(i0, n_seg,
    resolve)`` per segment."""
    mss = [
        aligner.min_guide_score(t.guide, align_kwargs["max_guide_diffs"])
        for _ti, t, _dq in group
    ]
    with spans.span("launch"):
        if len(group) >= 2:
            return screen.screen_contig_multi_async(
                genome, contig_len, step,
                [(dq, revcomp(dq)) for _ti, _t, dq in group], mss, pam_spec=pspec,
            )
        [(_ti, _t, dq)] = group
        return screen.screen_contig_async(
            genome, contig_len, step, dq, revcomp(dq), mss[0], pam_spec=pspec,
        )


def _finish_segments(
    seg_futs, starts, name, task, aligner, window_size, threads,
    swallow_errors, hit_spec, align_kwargs,
):
    """Consume a segmented contig screen: the candidate stream takes each
    segment's ``(chain_flags [2, n_seg], ranges [2, n_seg, 2])`` from its
    Future in window order, so the worker pool finishes segment N while
    the device screens segment N+1.  From the first segment without a
    result (no launch, or a failed readback) on, every window goes to the
    host finish unscreened: both passes, no column ranges."""
    from calitas_tpu_torch.parallel.host_pool import (
        _mp_finish_chunk,
        make_finish_spec,
        map_items_mp,
    )

    stats = {"cand": 0}
    rb = range_block(window_size)

    def cand_stream():
        unscreened = False
        for i0, n_seg, fut in seg_futs:
            res = None
            if not unscreened and fut is not None:
                with spans.span("segment_wait"):
                    res = fut.result()
            if res is None:
                unscreened = True
                stats["cand"] += n_seg
                span = starts[i0 : i0 + n_seg]
                for c0 in range(0, n_seg, _CAND_BATCH):
                    yield ("__batch__", name, span[c0 : c0 + _CAND_BATCH], None, None)
                continue
            with spans.span("candidates"):
                chain_flags, cranges = res
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
                # Widen the coarse range blocks back to 1-based column
                # bounds (the worker trim-shifts, mirrors chain B and
                # clips: align/batch.py::chain_ranges_to_pass).
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
