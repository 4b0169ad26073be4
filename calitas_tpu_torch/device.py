"""Engine and device resolution: which engine a run uses, and on which
``torch.device`` the screen runs.

Counterpart of ``calitas_tpu/tools/search_reference.py::_resolve_engine``,
the list-driven tools' auto rule included.  A CUDA device that was asked
for and is absent is an error: the port never falls back to the CPU
behind the caller's back.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

logger = logging.getLogger("calitas_tpu_torch.device")

ENGINES = ("auto", "host", "gpu")

#: below this many items the list-driven tools' auto engine stays on the
#: host (calitas_tpu/tools/search_reference.py:632-635)
AUTO_DEVICE_MIN_TASKS = 1000


def resolve_engine(
    engine: str,
    device: Optional[str | torch.device] = None,
    *,
    n_tasks: Optional[int] = None,
    prefer_host_when_native: bool = False,
) -> Optional[torch.device]:
    """The device the screen runs on, or None for the host engine.

    ``host`` aligns every window on the host.  ``gpu`` screens on
    ``device`` (default ``cuda``); ``device="cpu"`` runs the same screen
    through its plain PyTorch version.  ``auto`` picks ``gpu`` only when
    ``torch.cuda.is_available()``, else ``host``, and logs its choice.
    The list-driven tools pass ``n_tasks`` and ``prefer_host_when_native``:
    their auto engine stays on the host below
    :data:`AUTO_DEVICE_MIN_TASKS` items, and whenever the native host
    library is available (the reference's rule, kept as it is)."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if engine == "host":
        return None
    if engine == "auto":
        if n_tasks is not None and n_tasks < AUTO_DEVICE_MIN_TASKS:
            logger.info(
                "engine auto: %d items (< %d); using the host engine.",
                n_tasks, AUTO_DEVICE_MIN_TASKS,
            )
            return None
        if prefer_host_when_native:
            from calitas_tpu import native

            if native.available():
                logger.info(
                    "engine auto: the native host finish is available; "
                    "using the host engine."
                )
                return None
        if not torch.cuda.is_available():
            logger.info("engine auto: no CUDA device; using the host engine.")
            return None
        logger.info("engine auto: CUDA device found; using the gpu engine.")
    return resolve_device(device)


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """``device`` as a ``torch.device`` (default ``cuda``); raises when a
    CUDA device is asked for and torch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "false"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev
