"""How the host's threads wait for the card: every run sets
``CU_CTX_SCHED_BLOCKING_SYNC`` on each device's primary CUDA context,
through the CUDA driver, before the program makes the context.

The CUDA driver's default spins a core for each thread that waits on the card
while there are fewer active contexts than cores.  The program's waiting
threads (the request's, the stager's and the readback resolvers') then took
the cores that its finish pool needs on a host of 8: a run of one process
used 14 s of CPU in a 12 s window and its rate swung by 12 % from process to
process, against 9 s and 5 % with the flag set (PERF.md).
"""

from __future__ import annotations

import ctypes

#: ``CU_CTX_SCHED_BLOCKING_SYNC`` of cuda.h
BLOCKING_SYNC = 4


def block_on_sync() -> int:
    """Sets the flag on every visible device; returns how many (0 where
    there is no CUDA driver).  Call it before anything makes a context."""
    try:
        cu = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    count = ctypes.c_int(0)
    if cu.cuInit(0) != 0 or cu.cuDeviceGetCount(ctypes.byref(count)) != 0:
        return 0
    set_flags = getattr(cu, "cuDevicePrimaryCtxSetFlags_v2", None) or cu.cuDevicePrimaryCtxSetFlags
    for ordinal in range(count.value):
        dev = ctypes.c_int(0)
        rc = cu.cuDeviceGet(ctypes.byref(dev), ordinal) or set_flags(dev, BLOCKING_SYNC)
        if rc != 0:
            raise RuntimeError(f"CUDA driver error {rc} on device {ordinal}")
    return count.value
