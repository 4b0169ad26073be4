"""The device mesh of the window split, and the mesh batch screen.

Port of ``calitas_tpu/parallel/mesh.py``.  The reference's mesh is a
one-axis ``jax.sharding.Mesh`` whose ``shard_map`` programs run one
contiguous span of rows or window batches per device.  Here a mesh is a
tuple of ``torch.device``: :class:`~calitas_tpu_torch.ops.genome_screen.
ShardedGenomeScreen`, the sharded slot batches
(``ops/genome_screen.py::screen_slots_multi``) and the batch screen
:func:`sharded_screen_fn` / :func:`screen_on_mesh` run one contiguous span
per entry, each on its own CUDA stream.  An entry may repeat a device:
``(cuda:0,) * 4`` is four spans on one card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from calitas_tpu_torch.core.scoring import Scorer
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops.dp_screen import screen_rows_reference
from calitas_tpu_torch.ops.genome_screen import _mesh_streams, _on_stream, mesh_spans


def make_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> tuple:
    """The mesh over ``devices`` (default: every visible CUDA device), cut
    to its first ``n_devices`` entries when given: a tuple of
    ``torch.device``, repeats kept.  A bare ``cuda`` means the current CUDA
    device."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        elif d.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported mesh device {d}: use cuda or cpu")
        mesh.append(d)
    if n_devices is not None:
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device (no CUDA device is visible)")
    return tuple(mesh)


def sharded_screen_fn(mesh, scorer: Scorer):
    """The batch screen over ``mesh``: ``screen(qmask, tmasks, lengths,
    min_score, rows=None) -> (best, total)``.  The ``[B, T]`` uint8 target
    rows ``tmasks`` and their ``[B]`` lengths (host arrays) split into one
    contiguous span per mesh entry (``genome_screen.mesh_spans``); each
    span goes to its entry's device and, on that entry's own stream, takes
    its per-row best final-row score of the shared query ``qmask`` [Q]
    from ``dp_cuda.screen_rows`` (the row kernel on a CUDA device; the
    plain version on the CPU, and on CUDA for a query longer than the
    kernel takes, by ``dp_cuda.uses_kernel``) and counts its rows with
    ``best >= min_score`` there.  The counts are summed on the mesh's
    first device: the counterpart of the reference's ``jax.lax.psum``.
    ``rows`` counts only the first ``rows`` rows (padding rows stay out of
    the total).  Returns ``best`` [B] int32 (numpy) and ``total`` (int).

    The reference caches its traced ``shard_map`` program per (mesh,
    scorer); torch traces nothing, so there is nothing to cache."""
    mesh = tuple(torch.device(d) for d in mesh)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    streams = _mesh_streams(mesh)
    scores = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
                  qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)

    def screen(qmask, tmasks, lengths, min_score: int, rows: Optional[int] = None):
        qmask = np.asarray(qmask, dtype=np.uint8)[None]
        tmasks = np.asarray(tmasks, dtype=np.uint8)
        lengths = np.asarray(lengths, dtype=np.int32)
        B = tmasks.shape[0]
        rows = B if rows is None else rows
        resolves, counts = [], []
        for k, r0, n in mesh_spans(len(mesh), 0, B):
            dev, stream = mesh[k], streams[k]
            with _on_stream(stream, dev):
                tm = dp_cuda.to_device(tmasks[r0 : r0 + n], dev)
                ln = dp_cuda.to_device(lengths[r0 : r0 + n], dev)
                row_screen = (dp_cuda.screen_rows
                              if dp_cuda.uses_kernel(qmask.shape[1], dev)
                              else screen_rows_reference)
                best = row_screen(qmask, tm, ln, **scores)[0][0]
                live = best[: max(0, min(n, rows - r0))]
                counts.append((live >= min_score).sum(dtype=torch.int64))
                resolves.append(dp_cuda.readback((best,), lambda b: b))
        for dev, stream in zip(mesh, streams):
            if stream is not None:
                torch.cuda.current_stream(dev).wait_stream(stream)
        if not counts:
            return np.zeros(0, np.int32), 0
        total = torch.stack([c.to(mesh[0]) for c in counts]).sum()
        return np.concatenate([r() for r in resolves]), int(total)

    return screen


def screen_on_mesh(mesh, scorer: Scorer, qmask: np.ndarray, tmasks: np.ndarray,
                   lengths: np.ndarray, min_score: int):
    """Pads the batch to a multiple of the mesh size (zero rows of length
    0, as the reference does) and runs :func:`sharded_screen_fn` over it:
    ``(best [B] int32, total)``.  Unlike the reference, whose ``psum`` also
    counts the padding rows when ``min_score`` is at or below their
    NEG_INF score, the total counts the ``B`` given rows only."""
    n = len(mesh)
    B = tmasks.shape[0]
    pad = (-B) % n
    if pad:
        tmasks = np.concatenate(
            [tmasks, np.zeros((pad, tmasks.shape[1]), tmasks.dtype)]
        )
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    best, total = sharded_screen_fn(mesh, scorer)(qmask, tmasks, lengths, min_score,
                                                  rows=B)
    return best[:B], total
