"""Device screening of variant windows: the port of
``calitas_tpu/search/variants.py::screened_variant_windows_multi`` and
``screened_variant_windows``.

The window builder, clustering, lift-back and flanks are the reference
package's own (``variant_window_iterator``, ``_WindowBlock``,
``flank_and_absolutize``), imported, not copied.  Only the device calls
differ: slot batches go to :func:`~calitas_tpu_torch.ops.genome_screen.
screen_slots_multi`, the multi-guide kernel on CUDA or its plain version
on the CPU (and on CUDA for guides whose DP query is longer than the
kernel takes: the route is chosen and logged once per guide group).  A
device error propagates; nothing degrades to unscreened alignment.
"""

from __future__ import annotations

import numpy as np
import torch

from calitas_tpu.core.sequence import TARGET_MASK_TABLE, encode_query, revcomp
from calitas_tpu.search.variants import _WindowBlock
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops.genome_screen import screen_slots_multi, slot_batch_unit


def screened_variant_windows_multi(
    window_iter,
    aligner,
    guide_specs,  # sequence of (key, Guide, min_score)
    *,
    device,
    slot: int = 512,
    batch_slots: int = 8192,
    pipeline_depth: int = 3,
):
    """Yield ``(window, flagged_keys)`` pairs: for every variant window,
    the set of guides whose exact device screen says the window can
    contain a hit.

    All guides share one window stream and one mask upload per batch;
    each same-length guide group then costs one multi-guide launch
    (flags thresholded and bit-packed on the device) and one small
    readback.  Up to ``pipeline_depth`` batches stay in flight before the
    oldest is resolved.  Windows longer than ``slot`` pass through
    unscreened, flagged for every guide.  Flags are a superset (zero
    padding only adds candidate end columns), so aligning the flagged
    windows gives the exact output.  Guides longer than
    :data:`~calitas_tpu_torch.ops.dp_cuda.Q_MAX` bases raise
    NotImplementedError on CUDA."""
    device = torch.device(device)
    # Same-length guide groups: one launch per group per batch.  On CUDA
    # every group with Q <= Q_MAX runs the kernel (the reference's
    # use_pallas flag of the key).
    by_len: dict = {}  # (kernel, Q) -> [keys], [qv2 [2,Q]], [min_score]
    for key, guide, min_score in guide_specs:
        dp_query = guide.guide_rc if guide.pam_is_5prime else guide.guide_fw
        q_len = len(dp_query)
        kernel = device.type == "cuda" and q_len <= dp_cuda.Q_MAX
        ks, qs, ms = by_len.setdefault((kernel, q_len), ([], [], []))
        ks.append(key)
        qs.append(
            np.stack([encode_query(dp_query), encode_query(revcomp(dp_query))])
        )
        ms.append(min_score)
    group_keys = [ks for ks, _, _ in by_len.values()]
    for (_kernel, q_len), (ks, _qs, _ms) in by_len.items():
        dp_cuda.log_route(
            "Variant screen of guides " + ",".join(map(str, ks)), q_len, device
        )
    groups = [
        (np.stack(qs).astype(np.int32), np.asarray(ms, np.int32))
        for ks, qs, ms in by_len.values()
    ]
    unit = slot_batch_unit(any(kernel for kernel, _q in by_len))

    all_keys = frozenset(k for k, *_ in guide_specs)
    # The batch is a list of segments: (block, row-indices) spans from raw
    # builder blocks, or (window, None) singletons, so filling and flag
    # fan-out run as vectorized NumPy over whole spans.
    batch: list = []  # [(item, bis ndarray | None)]
    batch_count = 0
    pending: list = []  # [(segments, [([keys], resolver), ...])]

    def _seg_lengths(item, bis):
        if bis is None:
            return np.asarray([item.length], dtype=np.int64)
        return item._wlen[bis].astype(np.int64)

    def dispatch():
        """Pack the current batch and launch every guide group's screen;
        the device works while the host packs the next batches.  The slot
        width is the smallest power of two (at least 64) covering this
        batch's longest window."""
        nonlocal batch, batch_count
        longest = max(int(_seg_lengths(item, bis).max()) for item, bis in batch)
        slot_b = max(64, 1 << (longest - 1).bit_length())
        # Padding rows are zero and are never read back into the stream.
        B = -(-max(batch_count, batch_slots) // unit) * unit
        tmasks = np.zeros((B, slot_b), dtype=np.uint8)
        flat = tmasks.reshape(-1)
        row = 0
        for item, bis in batch:
            if bis is None:
                m = TARGET_MASK_TABLE[item.bases]
                tmasks[row, : len(m)] = m
                row += 1
                continue
            # Vectorized ragged copy: the block's mask rows are consecutive
            # slices of one buffer; scatter them into the slot grid.
            wl = item._wlen[bis].astype(np.int64)
            off = item._woff[bis].astype(np.int64)
            tot = int(wl.sum())
            ends = np.cumsum(wl)
            within = np.arange(tot, dtype=np.int64) - np.repeat(ends - wl, wl)
            src = np.repeat(off, wl) + within
            dst = np.repeat(
                (row + np.arange(len(bis), dtype=np.int64)) * slot_b, wl
            ) + within
            flat[dst] = item.masks[src]
            row += len(bis)
        resolvers = screen_slots_multi(aligner.scorer, tmasks, groups, device)
        out = (batch, list(zip(group_keys, resolvers)))
        batch = []
        batch_count = 0
        return out

    def resolve(p):
        segments, launched = p
        fls = [(keys, resolver()) for keys, resolver in launched]
        # [G_total, B] bool stacked over groups, keys flattened to match
        keys_flat = [k for keys, _fl in fls for k in keys]
        fl = np.concatenate([f for _k, f in fls], axis=0)
        any_fl = fl.any(axis=0)
        row = 0
        for item, bis in segments:
            nrows = 1 if bis is None else len(bis)
            hit_rows = np.nonzero(any_fl[row : row + nrows])[0]
            for r in hit_rows.tolist():
                keys = {k for g, k in enumerate(keys_flat) if fl[g, row + r]}
                w = item if bis is None else item.window(int(bis[r]))
                yield w, keys
            row += nrows

    def flush_full():
        pending.append(dispatch())
        if len(pending) > pipeline_depth:
            return resolve(pending.pop(0))
        return ()

    for it in window_iter:
        if isinstance(it, _WindowBlock):
            wl = it._wlen[: it.n]
            long_idx = np.nonzero(wl > slot)[0]
            for bi in long_idx.tolist():  # rare: align unscreened
                yield it.window(bi), all_keys
            ok = (
                np.arange(it.n, dtype=np.int64)
                if not len(long_idx)
                else np.nonzero(wl <= slot)[0]
            )
            pos = 0
            while pos < len(ok):
                take = min(batch_slots - batch_count, len(ok) - pos)
                batch.append((it, ok[pos : pos + take]))
                batch_count += take
                pos += take
                if batch_count == batch_slots:
                    yield from flush_full()
        else:
            if it.length > slot:
                yield it, all_keys  # too long; align unscreened
                continue
            batch.append((it, None))
            batch_count += 1
            if batch_count == batch_slots:
                yield from flush_full()
    if batch:
        pending.append(dispatch())
    for p in pending:
        yield from resolve(p)


def screened_variant_windows(
    window_iter,
    aligner,
    guide,
    min_score: int,
    *,
    device,
    slot: int = 512,
    batch_slots: int = 8192,
):
    """Single-guide wrapper over :func:`screened_variant_windows_multi`:
    yield only variant windows that can contain a hit for ``guide``."""
    for w, _keys in screened_variant_windows_multi(
        window_iter, aligner, [("g", guide, min_score)],
        device=device, slot=slot, batch_slots=batch_slots,
    ):
        yield w
