"""Host-side parallel window execution.

The TPU-native analogue of the reference's bounded-queue thread pool
(SearchReference.scala:75-94).  Measured on this workload (short native
calls interleaved with Python object construction) Python *threads* run
slower than serial due to GIL contention, so the production path uses
worker *processes* (``map_windows_mp``); ``map_windows`` is the simple
in-process fallback used by the list-driven tools whose tasks capture
unpicklable state (mmap'd references).  Results are always yielded in
submission order (final-table determinism comes from the global sort,
exactly as in the reference, but ordered yielding keeps intermediate hit
lists reproducible too).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

from calitas_tpu_torch import spans

W = TypeVar("W")
R = TypeVar("R")

#: queue depth factor (reference uses threads * 500)
QUEUE_FACTOR = 500

#: Feed/drain decoupling switch for map_items_mp (a producer thread
#: iterates + submits; the caller's thread only drains).  Module-level so
#: in-process interleaved A/B benchmarks can toggle it; off via
#: CALITAS_FEED_THREAD=0 as an operational escape hatch.
FEED_THREAD = True


class BlockFeed:
    """Producer-thread block chunker with CONSTRUCTION-TIME start: the
    producer begins pulling ``stream`` the moment the feed is created,
    so an expensive upstream (the variant window builder + device
    screen) overlaps whatever runs between construction and draining
    (e.g. the reference pass — the tool creates the variant feeds
    before pass 1).  At most ``depth`` completed blocks buffer;
    exceptions from the stream re-raise at the draining side; close()
    (or abandoning the drain) stops the producer.

    The stop is best effort: the producer sees it only between items of
    ``stream``, so one blocked inside the stream (a device dispatch, a
    read) runs on until that call returns.  close() waits ``timeout``
    seconds for it, then logs a warning naming the thread and returns."""

    def __init__(self, stream: Iterable[W], block_size: int, depth: int = 2):
        import queue as _queue
        import threading

        self._q: "_queue.Queue" = _queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._empty = _queue.Empty

        q = self._q
        stop = self._stop

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except _queue.Full:
                    continue
            return False

        def produce():
            block: list = []
            try:
                for w in stream:
                    block.append(w)
                    if len(block) >= block_size:
                        if not _put(block):
                            return
                        block = []
                    if stop.is_set():
                        return
                if block and not _put(block):
                    return
                _put(None)
            except BaseException as ex:
                _put(("__exc__", ex))

        self._thread = threading.Thread(
            target=produce, daemon=True, name="calitas-blocks"
        )
        self._thread.start()

    def __iter__(self) -> Iterator[list]:
        try:
            while True:
                item = self._q.get()
                if item is None:
                    break
                if type(item) is tuple and item[0] == "__exc__":
                    raise item[1]
                yield item
        finally:
            self.close()

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except self._empty:
                break
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            logging.getLogger(__name__).warning(
                "BlockFeed.close(): producer thread %s still running %.1f s "
                "after the stop (blocked inside its stream); it ends when "
                "that call returns", self._thread.name, timeout,
            )


def iter_blocks_threaded(
    stream: Iterable[W],
    block_size: int,
    *,
    depth: int = 2,
    enabled: bool = True,
) -> Iterator[list[W]]:
    """Chunk ``stream`` into lists of ``block_size`` items, pulling the
    stream from a PRODUCER THREAD with at most ``depth`` completed
    blocks buffered (a lazily-constructed :class:`BlockFeed` — the
    producer starts at the first ``next()``).  Used to overlap an
    expensive upstream (the variant window builder + device screen)
    with an expensive downstream (the finish pool): neither side ever
    waits for the other unless the buffer is empty/full.  Exceptions
    from the stream re-raise here; abandoning the iterator stops the
    producer."""
    if not enabled or block_size <= 0:
        block: list = []
        for w in stream:
            block.append(w)
            if len(block) >= block_size:
                yield block
                block = []
        if block:
            yield block
        return

    yield from BlockFeed(stream, block_size, depth=depth)


def map_windows(
    windows: Iterable[W],
    task: Callable[[W], R],
    threads: int,
) -> Iterator[tuple[W, R]]:
    """Apply ``task`` to each window with a bounded in-flight queue;
    yield (window, result) in submission order."""
    if threads <= 1:
        for w in windows:
            yield w, task(w)
        return
    max_inflight = threads * QUEUE_FACTOR
    with ThreadPoolExecutor(max_workers=threads) as pool:
        pending: list = []
        it = iter(windows)
        for w in it:
            pending.append((w, pool.submit(task, w)))
            if len(pending) >= max_inflight:
                w0, f0 = pending.pop(0)
                yield w0, f0.result()
        for w0, f0 in pending:
            yield w0, f0.result()


# ---------------------------------------------------------------------------
# Process-based window alignment (sidesteps the GIL: the per-window work is
# a mix of short native calls and Python object construction, which thread
# pools serialize — measured slower than serial on small hosts)
# ---------------------------------------------------------------------------

_MP_CACHE: dict = {}


def _mp_aligner_for(spec: dict):
    key = spec["key"]
    if key not in _MP_CACHE:
        from calitas_tpu_torch.core.guide import Guide
        from calitas_tpu_torch.align.engine import SequentialAligner

        guide = Guide.of(
            spec["guide"],
            pams_3prime=spec["pams_3prime"],
            pams_5prime=spec["pams_5prime"],
        )
        aligner = SequentialAligner(
            mismatch_net_cost=spec["mismatch_net_cost"],
            genome_gap_net_cost=spec["genome_gap_net_cost"],
            guide_gap_net_cost=spec["guide_gap_net_cost"],
            pam_mismatch_net_cost=spec["pam_mismatch_net_cost"],
        )
        _MP_CACHE[key] = (aligner, guide)
    return _MP_CACHE[key]


def _mp_align_chunk(spec: dict, chunk: list):
    """Worker: align a chunk of (chrom, start, bases[, passes]) windows."""
    aligner, guide = _mp_aligner_for(spec)
    out = []
    for item in chunk:
        chrom, start, bases = item[0], item[1], item[2]
        passes = item[3] if len(item) > 3 else ("fwd", "rev")
        try:
            res = aligner.align(
                guide, bases, target_name=chrom, target_offset=start - 1,
                passes=passes, **spec["align_kwargs"],
            )
        except Exception as ex:  # mirrored log-and-swallow happens in parent
            res = ("__error__", repr(ex))
        out.append(res)
    return out


def _mp_align_chunk_batched(spec: dict, chunk: list):
    """Worker: align a chunk of (chrom, start, bases[, passes]) windows
    through ONE batched native ``finish_batch`` call (bit-identical to the
    per-window ``aligner.align`` loop — tests/test_batch_finish.py), with
    the per-window engine loop as fallback when the native library is
    missing or the batched call fails.  The variant pass feeds thousands
    of small haplotype windows per block; one ctypes call per chunk
    replaces per-window query encoding / revcomp / pass dispatch."""
    aligner, guide = _mp_aligner_for(spec)
    try:
        from calitas_tpu_torch.align.batch import finish_windows

        kw = spec["align_kwargs"]
        windows = [(item[0], item[1], item[2]) for item in chunk]
        passes_list = [
            tuple(item[3]) if len(item) > 3 else ("fwd", "rev")
            for item in chunk
        ]
        per_window = finish_windows(
            guide, aligner, windows, passes_list, None, **kw
        )
        if per_window is not None:
            return per_window
    except Exception:
        pass  # fall back to the per-window loop (isolates failures too)
    return _mp_align_chunk(spec, chunk)


def make_align_spec(guide, aligner, align_kwargs) -> dict:
    """A picklable description of an alignment task for worker processes
    (guide: a core.guide.Guide)."""
    s = aligner.scorer
    # Recover net costs from the scorer derivation (exact inverse).
    return {
        "key": (guide.guide, guide.pams_3prime, guide.pams_5prime,
                 s.match_score, s.mismatch_score,
                 s.pam_match_score, s.pam_mismatch_score, s.query_gap_score,
                 s.target_gap_score, tuple(sorted(align_kwargs.items()))),
        "guide": guide.guide,
        "pams_3prime": guide.pams_3prime,
        "pams_5prime": guide.pams_5prime,
        "mismatch_net_cost": -(s.match_score - s.mismatch_score),
        "genome_gap_net_cost": -(s.match_score - s.target_gap_score),
        "guide_gap_net_cost": s.query_gap_score,
        "pam_mismatch_net_cost": -(s.pam_match_score - s.pam_mismatch_score),
        "align_kwargs": dict(align_kwargs),
    }


def make_finish_spec(
    guide, aligner, align_kwargs, *, guide_id, ref_path, aligner_id,
    arguments, vcf_id, timestamp, window_size, guide_length,
    aligner_version=None, swallow_errors: bool = False,
) -> dict:
    """Spec for :func:`_mp_finish_chunk`: align spec + everything a worker
    needs to materialize windows and build ReferenceHit rows itself.
    ``swallow_errors`` carries the caller's error policy into the batch
    fallback (whose per-window errors surface inside the worker)."""
    spec = make_align_spec(guide, aligner, align_kwargs)
    spec.update(
        guide_id=guide_id,
        ref_path=str(ref_path),
        aligner_id=aligner_id,
        arguments=arguments,
        vcf_id=vcf_id,
        timestamp=timestamp,
        window_size=window_size,
        guide_length=guide_length,
        aligner_version=aligner_version,
        swallow_errors=swallow_errors,
    )
    return spec


def map_windows_mp(
    windows: Iterable,
    spec: dict,
    processes: int,
    *,
    chunk: int = 64,
    swallow_errors: bool = False,
    logger=None,
) -> Iterator[tuple]:
    """Align windows across worker processes; yields (window, results) in
    submission order."""
    yield from map_items_mp(
        windows, spec, processes,
        worker_fn=_mp_align_chunk,
        to_payload=lambda w: (w.chrom, w.start, w.bases),
        chunk=chunk, swallow_errors=swallow_errors, logger=logger,
    )


def map_items_mp(
    windows: Iterable,
    spec: dict,
    processes: int,
    *,
    worker_fn,
    to_payload,
    chunk: int = 64,
    swallow_errors: bool = False,
    logger=None,
) -> Iterator[tuple]:
    """Run ``worker_fn(spec, [to_payload(item), ...])`` chunks across
    worker processes; yields (item, result) in submission order.  Falls
    back to in-process execution for processes <= 1 or short streams."""
    import itertools
    import os
    import sys

    processes = min(processes, os.cpu_count() or 1)
    if processes > 1:
        # The spawn context re-imports __main__ in workers; interactive /
        # stdin scripts have no importable __main__, so fall back serial.
        main_mod = sys.modules.get("__main__")
        main_file = getattr(main_mod, "__file__", None)
        if main_file is None or not os.path.exists(main_file):
            processes = 1
    if processes > 1:
        # Worker startup costs ~1s each; only fan out when the stream is
        # long enough to amortize it.
        windows = iter(windows)
        head = list(itertools.islice(windows, 4 * chunk))
        if len(head) < 4 * chunk:
            windows, processes = iter(head), 1
        else:
            windows = itertools.chain(head, windows)
    if processes <= 1:
        # In-process execution still batches worker_fn calls: the native
        # finish amortizes buffer setup over the chunk exactly as the
        # pooled path does (matters for the degraded/no-subprocess path).
        windows = iter(windows)
        while True:
            blk = list(itertools.islice(windows, chunk))
            if not blk:
                return
            with spans.span("finish"):
                results = worker_fn(spec, [to_payload(w) for w in blk])
            spans.count("finish_chunks_inline", 1)
            for w0, res in zip(blk, results):
                yield w0, _unwrap(res, swallow_errors, logger)

    import queue as _queue
    import threading

    from concurrent.futures.process import BrokenProcessPool

    # Feed/drain decoupling: the candidate stream often blocks on device
    # readbacks (screen_runner's segment resolve()), and draining blocks
    # on worker results — running both from one thread starves the
    # worker pool (measured round 4: the 1 Gb collect phase was
    # IDENTICAL at threads=1/2/4 while the same finish workload fed
    # independently scaled 4x).  A producer thread iterates + submits;
    # this (consumer) thread only drains, in submission order, so
    # device readbacks for segment N+1 overlap the finish of segment N.
    # The bounded queue IS the reference's backpressure
    # (SearchReference.scala:75-94: feeding never blocks alignment).
    max_inflight = processes * 4
    pool = _shared_pool(processes)
    state = {"broken": False}
    inflight: _queue.Queue = _queue.Queue(maxsize=max_inflight)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                inflight.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def feed():
        buf: list = []
        try:
            for w in windows:
                buf.append(w)
                if len(buf) >= chunk:
                    # stop check BEFORE submit: a consumer that
                    # abandoned the drain (teardown, error) must not
                    # have work dispatched to the shared pool after it
                    if stop.is_set():
                        return
                    if not _put(_submitted(buf)):
                        return
                    buf = []
            if stop.is_set():
                return
            if buf and not _put(_submitted(buf)):
                return
            _put(None)
        except BaseException as ex:  # iterator errors surface downstream
            _put(("__exc__", ex, None))

    def drain(ws, fut, payload):
        pooled = fut is not None
        with spans.span("finish"):
            if pooled:
                from concurrent.futures import CancelledError

                try:
                    results = fut.result()
                except (BrokenProcessPool, CancelledError):
                    # Worker died (environment forbids subprocesses) or the
                    # shared pool was replaced under us (a concurrent caller
                    # grew it, cancelling our queued futures); recompute
                    # this chunk in-process and stop fanning out.
                    if not state["broken"] and logger is not None:
                        logger.warning(
                            "Worker pool broken; finishing in-process "
                            "(single-threaded) from here on.", exc_info=True,
                        )
                    state["broken"] = True
                    pooled = False
                    results = worker_fn(spec, [to_payload(w) for w in ws])
            else:
                results = worker_fn(spec, payload)
        spans.count("finish_chunks_pooled" if pooled else "finish_chunks_inline", 1)
        for w0, res in zip(ws, results):
            yield w0, _unwrap(res, swallow_errors, logger)

    def _submitted(ws):
        payload = [to_payload(w) for w in ws]
        if not state["broken"]:
            try:
                return (ws, pool.submit(worker_fn, spec, payload), None)
            except BrokenProcessPool:
                state["broken"] = True
        return (ws, None, payload)

    if not (FEED_THREAD and os.environ.get("CALITAS_FEED_THREAD") != "0"):
        # Legacy single-thread loop (A/B baseline + escape hatch): the
        # caller's thread alternates feeding and draining.
        pending: list = []
        buf: list = []
        for w in windows:
            buf.append(w)
            if len(buf) >= chunk:
                pending.append(_submitted(buf))
                buf = []
            if len(pending) >= max_inflight:
                yield from drain(*pending.pop(0))
        if buf:
            pending.append(_submitted(buf))
        for item in pending:
            yield from drain(*item)
        return

    feeder = threading.Thread(target=feed, daemon=True, name="calitas-feed")
    feeder.start()
    try:
        while True:
            with spans.span("feed_wait"):
                item = inflight.get()
            if item is None:
                break
            if type(item) is tuple and item[0] == "__exc__":
                raise item[1]
            yield from drain(*item)
    finally:
        stop.set()
        while True:  # unblock a producer parked on a full queue
            try:
                inflight.get_nowait()
            except _queue.Empty:
                break
        feeder.join(timeout=10)


_SHARED_POOL = None
_SHARED_POOL_SIZE = 0
_SHARED_POOL_ATEXIT = False


def _shared_pool(processes: int):
    """A lazily-created, process-wide worker pool (spawning workers costs
    ~1s each; searches call the pool once per contig x guide)."""
    global _SHARED_POOL, _SHARED_POOL_SIZE, _SHARED_POOL_ATEXIT
    import atexit
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    if _SHARED_POOL is None or _SHARED_POOL_SIZE < processes:
        if _SHARED_POOL is not None:
            # A partially-consumed map_items_mp generator may still hold
            # futures on the old pool; cancelling surfaces there as
            # CancelledError, which drain() recomputes in-process.
            _SHARED_POOL.shutdown(wait=False, cancel_futures=True)
        _SHARED_POOL = ProcessPoolExecutor(
            max_workers=processes, mp_context=mp.get_context("spawn")
        )
        _SHARED_POOL_SIZE = processes
        if not _SHARED_POOL_ATEXIT:
            _SHARED_POOL_ATEXIT = True
            atexit.register(
                lambda: _SHARED_POOL and _SHARED_POOL.shutdown(wait=False)
            )
    return _SHARED_POOL


def _unwrap(res, swallow_errors, logger):
    if isinstance(res, tuple) and len(res) == 2 and res[0] == "__error__":
        if not swallow_errors:
            raise RuntimeError(res[1])
        if logger is not None:
            logger.error("Encountered an exception: %s", res[1])
        return []
    return res


# ---------------------------------------------------------------------------
# Screened-search finish worker: window materialization + batched native
# finish + ReferenceHit construction, all inside the worker process
# ---------------------------------------------------------------------------

_MP_FINISH_CACHE: dict = {}


def _finish_cache_key(spec: dict, suffix: str = "") -> tuple:
    """THE key construction for every worker-side finish cache: includes
    every run-scoped output column (timestamp, arguments, aligner
    id/version, VCF id — the CLAUDE.md worker-cache invariant) so a
    second run in the same interpreter never renders rows with the first
    run's metadata.  Adding a run-scoped column means editing exactly
    this function."""
    return (
        spec["key"], spec["guide_id"], spec["ref_path"],
        spec["aligner_id"], spec["arguments"], spec["vcf_id"],
        spec["timestamp"], spec.get("aligner_version"), suffix,
    )


def _evict_other_runs(spec: dict) -> None:
    """Drop cache entries from previous runs (workers outlive runs; a
    resident server would otherwise leak one IndexedFasta mmap + builder
    per request until EMFILE).  Entries of the CURRENT run — one per
    guide in a multi-guide search — stay."""
    cur = (spec["timestamp"], spec["arguments"], spec["vcf_id"])
    stale = [
        k for k in _MP_FINISH_CACHE if (k[6], k[4], k[5]) != cur
    ]
    for k in stale:
        old = _MP_FINISH_CACHE.pop(k)
        if isinstance(old, tuple) and len(old) == 4 and hasattr(
            old[2], "close"
        ):
            try:
                old[2].close()
            except Exception:
                pass


def _render_consts_for(spec: dict, builder, guide):
    key = _finish_cache_key(spec, "rc")
    consts = _MP_FINISH_CACHE.get(key)
    if consts is None:
        from calitas_tpu_torch.align.batch import make_render_consts

        consts = make_render_consts(builder, guide)
        _MP_FINISH_CACHE[key] = consts
    return consts


def _mp_finish_state(spec: dict):
    """Worker-side cached state: aligner, guide, indexed reference and a
    HitBuilder sharing the parent's run timestamp / VCF id (key contract:
    :func:`_finish_cache_key`)."""
    key = _finish_cache_key(spec)
    if key not in _MP_FINISH_CACHE:
        from calitas_tpu_torch.io.fasta import IndexedFasta
        from calitas_tpu_torch.search.hits import HitBuilder

        _evict_other_runs(spec)
        aligner, guide = _mp_aligner_for(spec)
        ref = IndexedFasta(spec["ref_path"])
        builder = HitBuilder(
            guide_id=spec["guide_id"],
            guide=guide,
            ref=ref,
            vcf=None,
            aligner_id=spec["aligner_id"],
            arguments=spec["arguments"],
            _vcf_id=spec["vcf_id"],
            _timestamp=spec["timestamp"],
            _aligner_version=spec.get("aligner_version"),
        )
        _MP_FINISH_CACHE[key] = (aligner, guide, ref, builder)
    return _MP_FINISH_CACHE[key]


def _mp_finish_batch_item(spec: dict, item: tuple):
    """Worker: ONE array-batched candidate item
    ``("__batch__", chrom, starts int64[], sel uint8[]|None,
    cranges int32[k,4]|None)`` -> a columnar RenderedBlock (or a flat
    RenderedHit list from the per-window fallback).

    ``sel`` is the screen's per-window chain-flag code (bit0 = chain A =
    native pass 0, bit1 = chain B = native pass 1); None means both
    passes, unscreened.  The block path has ZERO per-candidate Python
    beyond the mmap read of each raw context slice."""
    import numpy as np

    _tag, chrom, starts, sel, cr = item
    aligner, guide, ref, builder = _mp_finish_state(spec)
    window_size = spec["window_size"]
    kw = spec["align_kwargs"]
    FLANK_PAD = 10
    try:
        from calitas_tpu_torch.align.batch import (
            make_render_consts,
            materialize_finish_lines,
        )

        seq_len = ref.sequence_length(chrom)
        n = len(starts)
        ends = np.minimum(seq_len, starts + window_size)
        cs1 = np.maximum(1, starts + 1 - FLANK_PAD)
        c2 = np.minimum(seq_len, ends + FLANK_PAD)
        wrl = (ends - starts).astype(np.int32)
        mask = (
            np.full(n, 3, np.uint8)
            if sel is None
            else np.ascontiguousarray(sel, np.uint8)
        )
        consts = _render_consts_for(spec, builder, guide)
        fin_kw = dict(
            block=True,
            max_guide_diffs=kw["max_guide_diffs"],
            max_pam_diffs=kw["max_pam_diffs"],
            max_gaps_between_guide_and_pam=kw["max_gaps_between_guide_and_pam"],
            max_total_diffs=kw["max_total_diffs"],
            max_overlap=kw["max_overlap"],
        )
        blk = None
        raw_spans = getattr(ref, "raw_spans", None)
        if raw_spans is not None:
            # Zero-per-candidate-Python path: contexts stay in the
            # mmap'd file; native code strips newlines itself.
            try:
                buf, roff, rlen = raw_spans(chrom, cs1, c2)
                blen = (c2 - cs1 + 1).astype(np.int32)
                blk = materialize_finish_lines(
                    guide, aligner, chrom, None, cs1, starts, wrl, mask,
                    cr, consts, spec["guide_length"],
                    raw_ctx=(buf, roff, rlen, blen), **fin_kw,
                )
            except Exception:
                blk = None
        if blk is None:
            cs1_l = cs1.tolist()
            c2_l = c2.tolist()
            gs = ref.get_subsequence
            ctxs = [gs(chrom, cs1_l[i], c2_l[i]) for i in range(n)]
            blk = materialize_finish_lines(
                guide, aligner, chrom, ctxs, cs1, starts, wrl, mask, cr,
                consts, spec["guide_length"], **fin_kw,
            )
        if blk is not None:
            return blk
    except Exception:
        pass
    # Fallback: expand into classic per-window items (isolates bad
    # windows exactly like the reference's per-window log-and-swallow).
    a_name = "rev" if guide.pam_is_5prime else "fwd"
    b_name = "fwd" if guide.pam_is_5prime else "rev"
    ptab = ((), (a_name,), (b_name,), (a_name, b_name))
    sel_l = (
        [3] * len(starts) if sel is None else np.asarray(sel).tolist()
    )
    cr_l = (
        [None] * len(starts) if cr is None else np.asarray(cr).tolist()
    )
    items = [
        (chrom, int(s), ptab[c], r)
        for s, c, r in zip(np.asarray(starts).tolist(), sel_l, cr_l)
    ]
    flat: list = []
    import logging

    for res in _mp_finish_chunk(spec, items):
        if isinstance(res, tuple) and len(res) == 2 and res[0] == "__error__":
            if not spec.get("swallow_errors", False):
                # Honor the caller's policy: propagate through the pool
                # future instead of silently dropping the window's rows.
                raise RuntimeError(res[1])
            logging.getLogger("calitas_tpu_torch.SearchReference").error(
                "Window finish failed (swallowed): %s", res[1]
            )
            continue
        flat.extend(res)
    return flat


def _mp_finish_chunk(spec: dict, chunk: list):
    """Worker: chunk of (chrom, start0, passes, ranges|None) candidate
    windows -> per-item lists of ReferenceHit rows.  A chunk of ONE
    array-batched item (``("__batch__", ...)``, see
    :func:`_mp_finish_batch_item`) returns a one-element list holding
    that batch's RenderedBlock.

    Materializes each window from the mmap'd reference with the exact
    reference semantics (N-trim on raw bytes, uppercase, 1-based closed —
    SearchReference.scala:52-68), finishes the whole chunk in one native
    call, and builds the output rows in-process so the parent only
    collects them."""
    import numpy as np

    if chunk and type(chunk[0]) is tuple and chunk[0][0] == "__batch__":
        return [_mp_finish_batch_item(spec, item) for item in chunk]

    from calitas_tpu_torch.align.batch import (
        chain_ranges_to_pass,
        max_target_span,
    )
    from calitas_tpu_torch.search.windows import materialize_window, upper_bytes

    aligner, guide, ref, builder = _mp_finish_state(spec)
    window_size = spec["window_size"]
    guide_length = spec["guide_length"]
    kw = spec["align_kwargs"]
    q_len = len(guide.guide_fw)
    min_score = aligner.min_guide_score(guide, kw["max_guide_diffs"])
    scorer = aligner.scorer

    #: flank margin around the raw window: every output flank lies within
    #: [window_start - 9, window_end + 10] (finish_batch_render contract)
    FLANK_PAD = 10

    # Fully-native fast path: ONE mmap read per candidate, then one C++
    # call does N-trim, uppercase, screen-range mapping and the complete
    # line rendering (materialize_finish_render).  Any failure falls
    # through to the incremental paths below, which rebuild from scratch.
    try:
        from calitas_tpu_torch.align.batch import (
            make_render_consts,
            materialize_finish_lines,
        )

        chrom0 = chunk[0][0] if chunk else None
        if chrom0 is not None and all(item[0] == chrom0 for item in chunk):
            seq_len = ref.sequence_length(chrom0)
            n = len(chunk)
            ctxs: list = []
            cs1 = np.empty(n, np.int64)
            ws0 = np.empty(n, np.int64)
            wrl = np.empty(n, np.int32)
            cr = np.full((n, 4), -1, np.int32)
            passes_list = []
            for i, item in enumerate(chunk):
                start0, passes = item[1], item[2]
                end = min(seq_len, start0 + window_size)
                c1 = max(1, start0 + 1 - FLANK_PAD)
                ctxs.append(
                    ref.get_subsequence(chrom0, c1, min(seq_len, end + FLANK_PAD))
                )
                cs1[i] = c1
                ws0[i] = start0
                wrl[i] = end - start0
                passes_list.append(item[2])
                if len(item) > 3 and item[3] is not None:
                    cr[i] = item[3]
            consts = _render_consts_for(spec, builder, guide)
            per = materialize_finish_lines(
                guide, aligner, chrom0, ctxs, cs1, ws0, wrl, passes_list,
                cr, consts, guide_length,
                max_guide_diffs=kw["max_guide_diffs"],
                max_pam_diffs=kw["max_pam_diffs"],
                max_gaps_between_guide_and_pam=kw[
                    "max_gaps_between_guide_and_pam"
                ],
                max_total_diffs=kw["max_total_diffs"],
                max_overlap=kw["max_overlap"],
            )
            if per is not None:
                return per
    except Exception:
        pass  # incremental paths below recover (and isolate bad items)

    out: list = [[] for _ in chunk]
    mat = []  # (item_idx, RefWindow, passes, pass_ranges, flank_src)
    for i, item in enumerate(chunk):
        chrom, start0, passes = item[0], item[1], item[2]
        cr = item[3] if len(item) > 3 else None
        try:
            seq_len = ref.sequence_length(chrom)
            end = min(seq_len, start0 + window_size)
            # One mmap read covers the window AND its flank margin: the
            # raw window is the interior slice, the uppercased whole is
            # the native line-renderer's flank source.
            ctx_start1 = max(1, start0 + 1 - FLANK_PAD)
            ctx_end1 = min(seq_len, end + FLANK_PAD)
            ctx = np.frombuffer(
                ref.get_subsequence(chrom, ctx_start1, ctx_end1),
                dtype=np.uint8,
            )
            a = start0 + 1 - ctx_start1
            raw = ctx[a : a + (end - start0)]
            w = materialize_window(chrom, raw, 0, window_size)
            # materialize_window worked on the extracted slice; shift its
            # 1-based coordinates to the genome.
            w.start += start0
            w.end += start0
            if len(w.bases) < guide_length or not passes:
                continue
            ranges = None
            if cr is not None:
                T = len(w.bases)
                ranges = chain_ranges_to_pass(
                    cr, w.start - (start0 + 1), T,
                    max_target_span(
                        q_len, scorer.match_score, scorer.query_gap_score,
                        min_score, T,
                    ),
                )
            mat.append((i, w, passes, ranges, (ctx_start1, upper_bytes(ctx))))
        except Exception as ex:
            out[i] = ("__error__", repr(ex))
    if not mat:
        return out
    try:
        from calitas_tpu_torch.align.batch import (
            finish_lines,
            finish_rendered,
            make_render_consts,
        )

        windows = [(w.chrom, w.start, w.bases) for _, w, _, _, _ in mat]
        passes_list = [ps for _, _, ps, _, _ in mat]
        ranges_arr = None
        if any(r is not None for _, _, _, r, _ in mat):
            ranges_arr = np.zeros((len(mat), 4), np.int32)
            for k, (_, _, _, r, _) in enumerate(mat):
                if r is not None:
                    ranges_arr[k] = r
        limits = dict(
            max_guide_diffs=kw["max_guide_diffs"],
            max_pam_diffs=kw["max_pam_diffs"],
            max_gaps_between_guide_and_pam=kw["max_gaps_between_guide_and_pam"],
            max_total_diffs=kw["max_total_diffs"],
            max_overlap=kw["max_overlap"],
        )
        consts = _render_consts_for(spec, builder, guide)

        # Fastest path: the COMPLETE line (flanks included) renders in
        # native code; Python only slices the line buffer.
        per_window = finish_lines(
            guide, aligner, windows, passes_list, ranges_arr, consts,
            [fs for _, _, _, _, fs in mat], **limits,
        )
        if per_window is not None:
            for (i, _w, _, _, _), rows in zip(mat, per_window):
                out[i] = rows
            return out

        def fetch(chrom, a, b):
            return builder._fetch(chrom, a, b, False)

        # Fast path: native buffers -> final TSV lines + dedup keys,
        # no per-row GuideAlignment/ReferenceHit objects.
        per_window = finish_rendered(
            guide, aligner, windows, passes_list, ranges_arr, consts,
            fetch, **limits,
        )
        if per_window is not None:
            for (i, _w, _, _, _), rows in zip(mat, per_window):
                out[i] = rows
            return out

        # No native lib: engine fallback builds full rows.
        from calitas_tpu_torch.io.tsv import fields_of, render_row
        from calitas_tpu_torch.search.hits import ReferenceHit, RenderedHit

        fields = fields_of(ReferenceHit)
        per_window = [
            aligner.align(
                guide, w.bases, target_name=w.chrom,
                target_offset=w.start - 1, passes=ps, **kw,
            )
            for _, w, ps, _, _ in mat
        ]
        for (i, w, _, _, _), alns in zip(mat, per_window):
            out[i] = [
                RenderedHit.of(h, render_row(h, fields))
                for h in (builder.build(a) for a in alns)
            ]
    except Exception as ex:
        return [("__error__", repr(ex))] * len(chunk)
    return out


# ---------------------------------------------------------------------------
# Workers for the list-driven tools
# ---------------------------------------------------------------------------

_MP_REF_CACHE: dict = {}


def _mp_ref_aligner_for(spec: dict):
    key = spec["key"]
    if key not in _MP_REF_CACHE:
        from calitas_tpu_torch.align.engine import SequentialAligner
        from calitas_tpu_torch.io.fasta import IndexedFasta

        ref = IndexedFasta(spec["ref_path"])
        aligner = SequentialAligner(
            ref=ref,
            mismatch_net_cost=spec["mismatch_net_cost"],
            genome_gap_net_cost=spec["genome_gap_net_cost"],
            guide_gap_net_cost=spec["guide_gap_net_cost"],
            pam_mismatch_net_cost=spec["pam_mismatch_net_cost"],
        )
        _MP_REF_CACHE[key] = aligner
    return _MP_REF_CACHE[key]


def _mp_a2r_chunk(spec: dict, chunk: list):
    """AlignToReference worker: chunk of (id, query, chrom, pos[, extra])
    -> list of (Guide, [GuideAlignment, ...]).

    ``extra`` carries the device screen's verdict: in all-hits mode a
    ``passes`` tuple (possibly empty — the window provably holds no
    qualifying alignment); in best mode a pass-DP-bounds dict for the
    engine's exact rev-pass skip (used only by the per-item fallback).

    Like the pairwise worker, items sharing a query batch through ONE
    native ``finish_batch`` call over their (mmap-fetched) loci windows;
    per-window results are sorted with the engine's SORT_KEY, which is
    exactly ``align_to_ref``'s contract, and best mode takes the head
    like ``align_to_ref_best`` (batched both-pass run == the bounds path,
    output-identically, per engine.align_to_ref_best's merge note)."""
    from calitas_tpu_torch.core.guide import Guide

    aligner = _mp_ref_aligner_for(spec)
    ref = aligner.ref
    out: list = [None] * len(chunk)
    all_hits = spec["all_hits"]
    window_size = spec["window_size"]
    groups: dict[str, list[int]] = {}
    for i, item in enumerate(chunk):
        groups.setdefault(item[1], []).append(i)

    def _fallback(i):
        item = chunk[i]
        _task_id, query, chrom, pos = item[:4]
        extra = item[4] if len(item) > 4 else None
        try:
            guide = Guide.parse(query)
            if all_hits:
                passes = ("fwd", "rev") if extra is None else tuple(extra[0])
                alns = (
                    aligner.align_to_ref(
                        guide, chrom, pos, window_size,
                        passes=passes, **spec["align_kwargs"],
                    )
                    if passes
                    else []
                )
            else:
                alns = [
                    aligner.align_to_ref_best(
                        guide, chrom, pos, window_size,
                        max_gaps_between_guide_and_pam=spec["align_kwargs"][
                            "max_gaps_between_guide_and_pam"
                        ],
                        pass_dp_bounds=extra,
                    )
                ]
            out[i] = (guide, alns)
        except Exception as ex:
            out[i] = ("__error__", repr(ex))

    import numpy as np

    from calitas_tpu_torch.align.batch import finish_windows
    from calitas_tpu_torch.align.guide_alignment import SORT_KEY

    for q, idxs in groups.items():
        try:
            guide = Guide.parse(q)
        except Exception as ex:
            err = ("__error__", repr(ex))
            for i in idxs:
                out[i] = err
            continue
        if all_hits:
            kw = dict(spec["align_kwargs"])
        else:
            gaps = spec["align_kwargs"]["max_gaps_between_guide_and_pam"]
            kw = dict(
                max_guide_diffs=guide.protospacer_length,
                max_gaps_between_guide_and_pam=gaps,
                max_pam_diffs=guide.pam_length,
                max_total_diffs=guide.protospacer_length + gaps
                + guide.pam_length,
                max_overlap=0,
            )
        windows: list = []
        passes_list: list = []
        pass_ranges: list = []  # per-window (lo0,hi0,lo1,hi1) or None
        live: list = []  # chunk indices batched (errors resolved inline)
        from calitas_tpu_torch.align.engine import a2r_region
        if all_hits:
            from calitas_tpu_torch.align.batch import (
                chain_ranges_to_pass,
                max_target_span,
            )

            scorer = aligner.scorer
            q_len = len(guide.guide_fw)
            min_score = aligner.min_guide_score(guide, kw["max_guide_diffs"])
        for i in idxs:
            item = chunk[i]
            chrom, pos = item[2], item[3]
            extra = item[4] if len(item) > 4 else None
            passes = ("fwd", "rev")
            cr = None
            if all_hits and extra is not None:
                passes, cr = tuple(extra[0]), extra[1]
            try:
                seq_len = ref.sequence_length(chrom)
                if seq_len is None:
                    raise ValueError(f"Unknown chromosome: {chrom}")
                if not passes:
                    out[i] = (guide, [])
                    continue
                region_start, region_end = a2r_region(
                    guide.length, pos, window_size, seq_len
                )
                target = ref.get_subsequence(chrom, region_start, region_end)
                ranges = None
                if cr is not None:
                    # The screen saw this exact window (no N-trim in the
                    # A2R path, so trim=0): slice the native finish DP to
                    # the qualifying end columns, as the genome path does.
                    T = len(target)
                    ranges = chain_ranges_to_pass(
                        cr, 0, T,
                        max_target_span(
                            q_len, scorer.match_score,
                            scorer.query_gap_score, min_score, T,
                        ),
                    )
                windows.append(
                    (chrom, region_start, np.frombuffer(target, np.uint8))
                )
                passes_list.append(passes)
                pass_ranges.append(ranges)
                live.append(i)
            except Exception as ex:
                out[i] = ("__error__", repr(ex))
        if not live:
            continue
        ranges_arr = None
        if any(r is not None for r in pass_ranges):
            ranges_arr = np.zeros((len(windows), 4), np.int32)
            for k, r in enumerate(pass_ranges):
                if r is not None:
                    ranges_arr[k] = r
        per_window = None
        try:
            per_window = finish_windows(
                guide, aligner, windows, passes_list, ranges_arr, **kw
            )
        except Exception:
            per_window = None
        if per_window is None:  # no native lib: per-item engine path
            for i in live:
                _fallback(i)
            continue
        for i, alns in zip(live, per_window):
            ordered = sorted(alns, key=SORT_KEY)
            if all_hits:
                out[i] = (guide, ordered)
            elif ordered:
                out[i] = (guide, ordered[:1])
            else:  # align_to_ref_best raises IndexError on no alignments
                out[i] = ("__error__", "IndexError('list index out of range')")
    return out


def _mp_pairwise_chunk(spec: dict, chunk: list):
    """PairwiseAlignSequences worker: chunk of (query, target[, bounds])
    -> best GuideAlignment per pair.

    Pairs sharing a query string (the common case: one guide vs
    thousands of sites) are finished through ONE batched native
    ``finish_batch`` call with align_best's maxed-out limits — the
    per-pair engine layers (parse, encode, per-pass ctypes calls, light
    records) collapse into a per-chunk constant.  Best-alignment
    selection preserves align_best's first-max-wins tie-break exactly:
    finish_windows returns alignments in the engine's order (fwd pass
    then rev, each sorted + deduped).  ``bounds`` (the optional device
    pass-DP-bounds dict) only steers the per-pair engine fallback; the
    batched native path runs both passes outright, which is
    output-identical and cheaper than skipping."""
    import numpy as np

    from calitas_tpu_torch.core.guide import Guide

    aligner, _ = _mp_aligner_for({**spec, "guide": "A",
                                  "pams_3prime": (), "pams_5prime": ()})
    out: list = [None] * len(chunk)
    groups: dict[str, list[int]] = {}
    for i, item in enumerate(chunk):
        groups.setdefault(item[0], []).append(i)
    for q, idxs in groups.items():
        try:
            guide = Guide.parse(q)
        except Exception as ex:
            err = ("__error__", repr(ex))
            for i in idxs:
                out[i] = err
            continue
        kw = dict(
            max_guide_diffs=guide.protospacer_length,
            max_gaps_between_guide_and_pam=spec["max_gaps"],
            max_pam_diffs=guide.pam_length,
            max_total_diffs=guide.protospacer_length + spec["max_gaps"]
            + guide.pam_length,
            max_overlap=0,
        )
        per_pair = None
        try:
            from calitas_tpu_torch.align.batch import finish_windows

            windows = [
                ("pair", 1,
                 np.frombuffer(chunk[i][1].encode("ascii"), np.uint8))
                for i in idxs
            ]
            per_pair = finish_windows(
                guide, aligner, windows, [("fwd", "rev")] * len(idxs),
                None, **kw,
            )
        except Exception:
            per_pair = None  # fall back to the per-pair engine path
        if per_pair is not None:
            for i, alns in zip(idxs, per_pair):
                try:
                    out[i] = max(alns, key=lambda a: a.score)
                except ValueError as ex:  # no alignment at all
                    out[i] = ("__error__", repr(ex))
            continue
        for i in idxs:
            item = chunk[i]
            bounds = item[2] if len(item) > 2 else None
            try:
                out[i] = aligner.align_best(
                    guide, item[1],
                    max_gaps_between_guide_and_pam=spec["max_gaps"],
                    pass_dp_bounds=bounds,
                )
            except Exception as ex:
                out[i] = ("__error__", repr(ex))
    return out
