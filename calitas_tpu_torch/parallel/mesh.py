"""The device mesh of the window split: the devices a sharded screen runs
its spans on.

Port of ``calitas_tpu/parallel/mesh.py::make_mesh``.  The reference's
mesh is a one-axis ``jax.sharding.Mesh`` whose ``shard_map`` programs run
one contiguous span of window batches per device.  Here a mesh is a tuple
of ``torch.device``: :class:`~calitas_tpu_torch.ops.genome_screen.
ShardedGenomeScreen` and the sharded slot batches
(``ops/genome_screen.py::screen_slots_multi``) run one contiguous span per
entry, each on its own CUDA stream.  An entry may repeat a device:
``(cuda:0,) * 4`` is four spans on one card.  ``sharded_screen_fn`` and
``screen_on_mesh`` are not ported (ROADMAP "Don't port").
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


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
