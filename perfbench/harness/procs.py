"""Stopping every process a run started: the program's finish pool, the
resource tracker its spawn context starts, and any other descendant (after
``chip_smoke.py::stop_processes``)."""

from __future__ import annotations

import gc
import multiprocessing
import os
import signal
import time
from pathlib import Path


def own_processes() -> list:
    """``(pid, command line)`` of every process descended from this one,
    read from /proc."""
    parent, cmd = {}, {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            fields = (d / "stat").read_text().rsplit(")", 1)[1].split()
            cmd[int(d.name)] = (d / "cmdline").read_bytes().replace(b"\0", b" ").decode(
                errors="replace").strip()
        except (OSError, IndexError):
            continue  # ended while being read
        parent[int(d.name)] = int(fields[1])
    mine, level = [], {os.getpid()}
    while level:
        level = {pid for pid, ppid in parent.items() if ppid in level}
        mine += sorted(level)
    return [(pid, cmd.get(pid, "")) for pid in mine]


def stop_processes() -> list:
    """Shuts the finish pool down, stops the resource tracker and waits;
    then sends SIGTERM, and SIGKILL, to any other descendant.  Returns the
    processes that were left to kill."""
    from multiprocessing import resource_tracker

    from calitas_tpu_torch.parallel import host_pool

    if host_pool._SHARED_POOL is not None:
        host_pool._SHARED_POOL.shutdown(wait=True)
        host_pool._SHARED_POOL = None
    for proc in multiprocessing.active_children():
        proc.join(30)
    gc.collect()  # the pool's semaphores unregister while the tracker runs
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    killed = own_processes()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        left = own_processes()
        if not left:
            break
        for pid, _cmd in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + 10
        while left and time.monotonic() < deadline:
            for pid, _cmd in left:
                try:
                    os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    pass
            time.sleep(0.05)
            left = own_processes()
    return killed
