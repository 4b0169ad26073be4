"""Small shared utilities."""

from __future__ import annotations

import re
import threading


def camel_to_gnu(name: str) -> str:
    """camelCase -> gnu-style-option-name (fgbio StringUtil.camelToGnu, used
    for the aligner_other_parameters column, SearchReference.scala:496-508)."""
    return re.sub(r"(?<!^)(?=[A-Z])", "-", name).lower()


def scala_option_repr(v) -> str:
    """Render an optional value the way Scala's Option.toString does —
    AlignToReference interpolates Option values directly into its
    parameter string (AlignToReference.scala:77-86)."""
    return "None" if v is None else f"Some({v})"


class ProgressLogger:
    """Throughput progress logging (reference: fgbio ProgressLogger —
    every `unit` records, SearchReference.scala:531,579)."""

    def __init__(self, logger, noun: str = "records", verb: str = "Processed",
                 unit: int = 25_000):
        import time as _time

        self._logger = logger
        self._noun = noun
        self._verb = verb
        self._unit = unit
        self._count = 0
        self._start = _time.monotonic()

    def record(self, chrom: str = "", pos: int = 0, n: int = 1) -> None:
        import time as _time

        self._count += n
        if self._count % self._unit < n:
            elapsed = _time.monotonic() - self._start
            rate = self._count / elapsed if elapsed > 0 else 0.0
            where = f" Last {self._noun[:-1]}: {chrom}:{pos}." if chrom else ""
            self._logger.info(
                "%s %s %s. Elapsed %.0fs (%.0f/s).%s",
                self._verb, f"{self._count:,}", self._noun, elapsed, rate, where,
            )


class KernelError(RuntimeError):
    """A fault of the port's own CUDA kernels: ``nvcc`` missing, a failed
    build or library load, a launch the kernel refused, or a kernel that
    faulted while it ran (``ops/dp_cuda.py``, ``ops/probes.py``).  Never
    degradable: a host fallback would hide a broken kernel behind an
    identical table."""


#: cudaGetErrorString's text for the faults that only a kernel's own
#: execution raises (errors 700, 702, 710, 714-719).  torch reports them
#: late, as a ``RuntimeError`` or, in newer releases, its subclass
#: ``torch.AcceleratorError`` ("CUDA error: ..."), from whatever call next
#: meets the device: a readback's synchronize, a copy, a later launch.
#: The context stays broken after one, so every later call fails alike.
_KERNEL_EXECUTION_FAULTS = (
    "an illegal memory access was encountered",
    "the launch timed out and was terminated",
    "device-side assert triggered",
    "hardware stack error",
    "an illegal instruction was encountered",
    "misaligned address",
    "operation not supported on global/shared address space",
    "invalid program counter",
    "unspecified launch failure",
)


def kernel_execution_fault(exc: BaseException) -> bool:
    """True if ``exc`` reports a device kernel that faulted while it ran:
    a fault of the program (the port's kernels or torch's), not of the
    device."""
    return any(m in str(exc) for m in _KERNEL_EXECUTION_FAULTS)


#: Exception types that always indicate a host-side programming error.
#: The degradation policy (device failure degrades to host alignment,
#: never aborts — SearchReference.scala:555-559's log-and-continue
#: intent) must NOT swallow these: a silent 100x slowdown over a bug is
#: worse than a crash that gets the bug fixed.
_PROGRAMMING_ERRORS = (
    RecursionError,
    TypeError,
    ValueError,  # numpy reshape/stack shape bugs raise this
    AssertionError,
    AttributeError,
    NameError,
    UnboundLocalError,
    IndexError,
    KeyError,
    SyntaxError,
)


def degradable(exc: BaseException) -> bool:
    """True if ``exc`` is a device failure the screen paths may degrade on
    (falling back to host alignment with identical output); False for
    programming errors and for faults of the port's kernels, which must
    propagate.

    torch reports device faults as ``torch.cuda.OutOfMemoryError`` or as
    a ``RuntimeError`` ("CUDA error: ...") from a copy, an allocation or a
    synchronize: both degrade.  :class:`KernelError` (a kernel that does
    not build or launch), a kernel that faulted while it ran
    (:func:`kernel_execution_fault`, wherever it surfaces) and
    ``NotImplementedError`` (a query the kernels do not take on CUDA; a
    ``RuntimeError`` subclass) never do."""
    if isinstance(exc, (KernelError, NotImplementedError)) or kernel_execution_fault(exc):
        return False
    return not isinstance(exc, _PROGRAMMING_ERRORS)


#: degradations by point since the last :func:`reset_degraded`, at the
#: counterparts of the reference's catches: a contig's staging, a guide
#: group's segmented screen launch, a segment's readback, a variant slot
#: batch, a list tool's pair screen, and a resident server's staging of a
#: contig.  A run whose device never failed reads zero everywhere.  The
#: table of a degraded run equals a screened one by design, so this
#: counter (with the kernels' launch counts) is what shows a fault
#: happened.
DEGRADED = dict.fromkeys(
    ("staging", "launch", "readback", "variant_screen", "pair_screen",
     "resident_staging"),
    0,
)

_degraded_lock = threading.Lock()


def note_degraded(point: str, log, msg: str, *args) -> None:
    """Record one degradation at ``point``: a WARNING on ``log`` with the
    exception being handled (call from an ``except`` block), and one more
    in :data:`DEGRADED`."""
    log.warning(msg, *args, exc_info=True)
    with _degraded_lock:
        DEGRADED[point] += 1


def reset_degraded() -> None:
    with _degraded_lock:
        for point in DEGRADED:
            DEGRADED[point] = 0
