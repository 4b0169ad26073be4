"""The CUDA screens (``csrc/screen_dual.cu``, ``csrc/screen_multi.cu``,
``csrc/screen_rows.cu``): build, wrappers, launch counters and the static
route between a kernel and its plain version.  The roofline probes
(``csrc/probes.cu``, wrappers in :mod:`~calitas_tpu_torch.ops.probes`)
are built, loaded and counted here too.

:func:`screen_dual` replaces ``calitas_tpu/ops/dp_pallas2.py::
_pallas_screen_dual`` (kernel ``_kernel2``), :func:`screen_multi`
replaces ``_pallas_screen_multi`` (kernel ``_kernel_multi``) and
:func:`screen_rows` replaces ``_pallas_screen2`` (kernel ``_kernel``) and
carries the list tools' pair screen.  A CUDA tensor goes to the kernel or
raises; a CPU tensor goes to the plain PyTorch version in
:mod:`~calitas_tpu_torch.ops.dp_screen`.  There is no fallback between
the two: callers choose the route before any launch with
:func:`uses_kernel`, from the query length alone.

Each kernel is built from the repository's source with ``nvcc`` at first
use, into ``csrc/build/`` (git-ignored), keyed by a hash of the source
and flags, and loaded with ``ctypes`` through its plain C interface.
:func:`build_all` starts one ``nvcc`` per source, all at once.  A kernel
that does not build, load or launch, or faults while it runs, raises
:class:`KernelError`, which no caller degrades on (``utils.degradable``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from calitas_tpu_torch import spans
from calitas_tpu_torch.ops.dp_screen import (
    ScreenKernel,
    screen_dual_reference,
    screen_multi_reference,
    screen_rows_reference,
)
from calitas_tpu_torch.utils import KernelError, kernel_execution_fault

logger = logging.getLogger("calitas_tpu_torch.screen")

#: longest query the kernels are instantiated for (the reference's unroll
#: limit, calitas_tpu/ops/dp_pallas2.py:133-134)
Q_MAX = 48
#: most guides one screen_multi launch takes (the grid's y extent)
G_MAX = 65535
#: lanes per window the dual kernel is built for (csrc/screen_dual.cu)
DUAL_LANES = (1, 2)
#: lanes per window the multi-guide kernel is built for (csrc/screen_multi.cu)
MULTI_LANES = (1, 2, 4)
#: lanes per row and chain the row kernel is built for
#: (csrc/screen_rows.cu::built), by mode: per-row queries (True) or one
#: shared query (False)
ROWS_LANES = {True: (1, 2, 4), False: (1, 2)}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {
    "screen_dual": _CSRC / "screen_dual.cu",
    "screen_multi": _CSRC / "screen_multi.cu",
    "screen_rows": _CSRC / "screen_rows.cu",
    "probes": _CSRC / "probes.cu",
}
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)

#: kernel launches by kernel name; callers that need to show a kernel ran
#: call :func:`reset_launches` and read this afterwards
launches = {
    name: 0
    for name in ("screen_dual", "screen_multi", "screen_rows", "ceiling_probe",
                 "peak_probe")
}

_libs: dict = {}
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _count_launch(name: str) -> None:
    """One launch of kernel ``name``: the wrappers call this right after a
    successful launch, from whichever thread launched."""
    with _count_lock:
        launches[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    """The library of source ``name``, keyed by the source, every header
    of ``csrc/`` (the sources include ``dp_lane.cuh``) and the flags."""
    key = hashlib.sha256(
        SOURCES[name].read_bytes()
        + b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_all(names) -> dict:
    """The kernel libraries ``{name: path}``, compiling with one ``nvcc``
    per source, all started together, unless a build of this exact source
    and flag set exists.  Raises :class:`KernelError` with nvcc's stderr on
    failure.  ptxas's register and spill report goes beside each as
    ``<lib>.log``."""
    libs = {name: _lib_path(name) for name in names}
    procs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        _out, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(
                f"nvcc failed (exit {proc.returncode}) building "
                f"{SOURCES[name]}:\n{err}"
            )
            continue
        libs[name].with_name(libs[name].name + ".log").write_text(err)
        os.replace(tmp, libs[name])
    if failed:
        raise KernelError("\n".join(failed))
    return libs


def _bind(lib: ctypes.CDLL, name: str) -> None:
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if name == "screen_dual":
        dual = [
            vp, ll, ll, ll, i32, i32,  # genome, len, base0, step, window, n
            ctypes.POINTER(i32), i32,  # qvals, q_len
            i32, i32, i32, i32, i32, i32,  # scores, min_score, pam_gate
            vp, vp, vp,  # best, ranges, stream
        ]
        lib.calitas_screen_dual.argtypes = dual
        lib.calitas_screen_dual_lanes.argtypes = [*dual, i32]  # lanes
        lib.calitas_screen_dual_default_lanes.argtypes = [i32]
        for fn in (lib.calitas_screen_dual, lib.calitas_screen_dual_lanes,
                   lib.calitas_screen_dual_default_lanes):
            fn.restype = i32
    elif name == "screen_rows":
        rows = [
            vp, ll, i32, i32, vp,  # tmasks, ld, T, n_rows, lengths
            ctypes.POINTER(i32), vp, i32,  # query (host), qrows, q_len
            vp, i32, i32, i32, i32,  # min_scores, scores
            vp, vp, vp,  # best, ranges, stream
        ]
        lib.calitas_screen_rows.argtypes = rows
        lib.calitas_screen_rows_lanes.argtypes = [*rows, i32]  # lanes
        lib.calitas_screen_rows_default_lanes.argtypes = [i32, i32, i32]
        for fn in (lib.calitas_screen_rows, lib.calitas_screen_rows_lanes,
                   lib.calitas_screen_rows_default_lanes):
            fn.restype = i32
    elif name == "probes":
        for fn in (lib.calitas_ceiling_probe, lib.calitas_peak_probe):
            fn.argtypes = [vp, i32, ll, i32, i32, vp, vp]  # tcols, T, N, Q, bias, out, stream
            fn.restype = i32
    else:
        multi = [
            vp, ll, ll, ll, i32, i32,  # genome, len, base0, step, window, n
            vp, i32, i32, vp,  # qvals, q_len, n_guides, min_scores
            i32, i32, i32, i32, i32,  # scores, pam_gate
            vp, vp, vp,  # best, ranges (0 = none), stream
        ]
        lib.calitas_screen_multi.argtypes = multi
        lib.calitas_screen_multi_lanes.argtypes = [*multi, i32]  # lanes
        lib.calitas_screen_multi_default_lanes.argtypes = [i32, i32, i32, i32]
        for fn in (lib.calitas_screen_multi, lib.calitas_screen_multi_lanes,
                   lib.calitas_screen_multi_default_lanes):
            fn.restype = i32
    lib.calitas_cuda_error_string.argtypes = [i32]
    lib.calitas_cuda_error_string.restype = ctypes.c_char_p


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``; the first call builds every
    kernel not built yet, in parallel."""
    with _lib_lock:
        if name not in _libs:
            for n, path in build_all(
                tuple(n for n in SOURCES if n not in _libs)
            ).items():
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as ex:
                    raise KernelError(f"cannot load {path}: {ex}") from ex
                _bind(lib, n)
                _libs[n] = lib
    return _libs[name]


def _check_grid(genome, base0, step, n_windows, window):
    if genome.dtype != torch.uint8 or genome.dim() != 1:
        raise ValueError(
            f"genome must be a 1-D uint8 tensor, got {genome.dtype} "
            f"{tuple(genome.shape)}"
        )
    if not genome.is_contiguous():
        raise ValueError("genome must be contiguous")
    if window < 1 or step < 1 or base0 < 0 or n_windows < 0:
        raise ValueError(
            f"bad window grid: base0={base0} step={step} "
            f"n_windows={n_windows} window={window}"
        )
    if n_windows >= 2**31:
        raise ValueError(f"n_windows {n_windows} exceeds int32")
    if genome.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {genome.device}")


def _check_masks(qvals):
    if qvals.min() < 0 or qvals.max() > 15:
        raise ValueError("qvals must be 4-bit IUPAC masks")


def _check_q_len(Q: int, what: str):
    if Q > Q_MAX:
        raise NotImplementedError(
            f"CUDA {what} screen takes queries up to {Q_MAX} bases (got {Q}): "
            "callers route longer ones to the plain screen (uses_kernel); "
            "a kernel form is open work (ROADMAP Queue 2, device programs "
            "outside Pallas, item 3)"
        )


def uses_kernel(q_len: int, device) -> bool:
    """The static route of a screen of a ``q_len``-base query on
    ``device``, chosen before any launch: True = the CUDA kernel, False =
    the plain PyTorch screen on the same device (the CPU, or a query
    longer than :data:`Q_MAX` on CUDA).  This is the reference's rule,
    which sends queries over its kernels' unroll limit to its XLA scan on
    the same accelerator (calitas_tpu/ops/genome_screen.py:749-753,
    calitas_tpu/search/variants.py:790)."""
    return torch.device(device).type == "cuda" and q_len <= Q_MAX


def log_route(what: str, q_len: int, device) -> bool:
    """:func:`uses_kernel`, logged at INFO with the query length; callers
    log once per guide group or query-length bucket."""
    kernel = uses_kernel(q_len, device)
    logger.info(
        "%s: %d-base query on %s -> %s", what, q_len, torch.device(device),
        "CUDA kernel" if kernel else (
            f"plain PyTorch screen (queries over {Q_MAX} bases)"
            if torch.device(device).type == "cuda" else "plain PyTorch screen"
        ),
    )
    return kernel


def _raise_on(lib, err: int, what: str):
    if err != 0:
        msg = lib.calitas_cuda_error_string(err).decode()
        raise KernelError(f"{what} launch failed: CUDA error {err} ({msg})")


def screen_dual(
    genome: torch.Tensor,
    qvals: np.ndarray,
    *,
    base0: int,
    step: int,
    n_windows: int,
    window: int,
    min_score: int,
    match: int,
    mismatch: int,
    qgap: int,
    tgap: int,
    pam_gate: bool,
):
    """Dual-chain screen of the window grid ``base0 + w*step`` over an
    annotated genome: returns ``best`` [2, n_windows] and ``ranges``
    [2, 2, n_windows] int32 (contract: :func:`screen_dual_reference`).

    CUDA tensors launch the kernel on the current stream, with the lanes
    per window the kernel's table gives the query length
    (:func:`screen_dual_default_lanes`); CPU tensors run the plain
    version.  Q > 48 on CUDA raises NotImplementedError."""
    return _screen_dual(genome, qvals, None, dict(
        base0=base0, step=step, n_windows=n_windows, window=window,
        min_score=min_score, match=match, mismatch=mismatch, qgap=qgap,
        tgap=tgap, pam_gate=pam_gate,
    ))


def _screen_dual_lanes(genome: torch.Tensor, qvals: np.ndarray, *, lanes: int, **kw):
    """:func:`screen_dual` with ``lanes`` lanes per window (one of
    :data:`DUAL_LANES`, at most Q) instead of the table's choice, for
    timing and checking each lane count of the kernel.  Counts as a
    ``screen_dual`` launch.  CPU tensors run the plain version."""
    Q = np.asarray(qvals).shape[-1]
    if lanes not in DUAL_LANES or lanes > Q:
        raise ValueError(f"lanes must be one of {DUAL_LANES} and at most Q={Q}, got {lanes}")
    return _screen_dual(genome, qvals, lanes, kw)


def screen_dual_default_lanes(q_len: int) -> int:
    """The lanes per window :func:`screen_dual` launches a ``q_len``-base
    query with (the kernel's compile-time table); builds the kernels."""
    _check_q_len(q_len, "dual")
    return library("screen_dual").calitas_screen_dual_default_lanes(q_len)


def _screen_dual(genome, qvals, lanes, kw):
    qvals = np.asarray(qvals)
    _check_grid(genome, kw["base0"], kw["step"], kw["n_windows"], kw["window"])
    if qvals.ndim != 2 or qvals.shape[0] != 2 or qvals.shape[1] < 1:
        raise ValueError(f"qvals must be [2, Q] with Q >= 1, got {qvals.shape}")
    _check_masks(qvals)
    if genome.device.type == "cpu":
        return screen_dual_reference(genome, qvals, **kw)
    Q = qvals.shape[1]
    _check_q_len(Q, "dual")
    dev = genome.device
    n_windows = kw["n_windows"]
    best = torch.empty((2, n_windows), dtype=torch.int32, device=dev)
    ranges = torch.empty((2, 2, n_windows), dtype=torch.int32, device=dev)
    if n_windows == 0:
        return best, ranges
    lib = library("screen_dual")
    q = (ctypes.c_int * (2 * Q))(*(int(v) for v in qvals.reshape(-1)))
    args = (
        genome.data_ptr(), genome.numel(), kw["base0"], kw["step"], kw["window"],
        n_windows, q, Q, kw["match"], kw["mismatch"], kw["qgap"], kw["tgap"],
        kw["min_score"], int(bool(kw["pam_gate"])), best.data_ptr(),
        ranges.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    with torch.cuda.device(dev):
        if lanes is None:
            err = lib.calitas_screen_dual(*args)
        else:
            err = lib.calitas_screen_dual_lanes(*args, lanes)
    _raise_on(lib, err, "screen_dual")
    _count_launch("screen_dual")
    return best, ranges


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  For CUDA the copy goes
    through pinned memory to the device's current stream without blocking
    the host (the caching host allocator keeps the pinned block until the
    copy is done); a CPU device gets a view of ``arr``."""
    device = torch.device(device)
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def readback(dev_out: tuple, finish):
    """``resolve()`` of device results: on CUDA each tensor is copied to
    pinned host memory without blocking, behind a recorded event that
    ``resolve`` waits on; ``finish`` turns the host numpy arrays into the
    result.  The copies and the event go to the current stream of the
    tensors' device, so a launching thread's work stays in its order.  A
    kernel that faulted while it ran shows at the wait, and raises
    :class:`KernelError`.  The results' bytes count in the ``d2h_bytes``
    counter (``spans.py``)."""
    dev = dev_out[0].device
    spans.count("d2h_bytes", sum(t.numel() * t.element_size() for t in dev_out))
    event = None
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in dev_out
            )
            for h, t in zip(host, dev_out):
                h.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
    else:
        host = dev_out

    def resolve():
        if event is not None:
            _wait(event)
        return finish(*(h.numpy() for h in host))

    return resolve


def _wait(event) -> None:
    try:
        event.synchronize()
    except RuntimeError as ex:
        if kernel_execution_fault(ex):
            raise KernelError(f"a kernel faulted while it ran: {ex}") from ex
        raise


def screen_multi(
    genome: torch.Tensor,
    qvals: np.ndarray,
    min_scores: np.ndarray,
    *,
    base0: int,
    step: int,
    n_windows: int,
    window: int,
    match: int,
    mismatch: int,
    qgap: int,
    tgap: int,
    pam_gate: bool,
    emit_ranges: bool,
):
    """Dual-chain screen of G same-length guides over the window grid
    ``base0 + w*step``: returns ``best`` [G, 2, n_windows] int32 and
    ``ranges`` [G, 2, 2, n_windows] int32 when ``emit_ranges`` (else
    None), each guide against its own ``min_scores[g]`` (contract:
    :func:`screen_multi_reference`).

    CUDA tensors launch the kernel on the current stream, with the lanes
    per window the kernel's table gives the query length, the number of
    (window, guide) pairs and ``emit_ranges``
    (:func:`screen_multi_default_lanes`); CPU
    tensors run the plain version.  Q > 48 on CUDA raises
    NotImplementedError."""
    return _screen_multi(genome, qvals, min_scores, None, dict(
        base0=base0, step=step, n_windows=n_windows, window=window,
        match=match, mismatch=mismatch, qgap=qgap, tgap=tgap,
        pam_gate=pam_gate, emit_ranges=emit_ranges,
    ))


def _check_multi_lanes(lanes, Q: int):
    if lanes is not None and not (lanes in MULTI_LANES and lanes <= Q):
        raise ValueError(f"lanes must be one of {MULTI_LANES} and at most Q={Q}, got {lanes}")


def _screen_multi_lanes(genome: torch.Tensor, qvals: np.ndarray,
                        min_scores: np.ndarray, *, lanes: int, **kw):
    """:func:`screen_multi` with ``lanes`` lanes per window (one of
    :data:`MULTI_LANES`, at most Q) instead of the table's choice, for
    timing and checking each lane count of the kernel.  Counts as a
    ``screen_multi`` launch.  CPU tensors run the plain version."""
    _check_multi_lanes(lanes, np.shape(qvals)[-1])
    return _screen_multi(genome, qvals, min_scores, lanes, kw)


def screen_multi_default_lanes(q_len: int, n_windows: int, n_guides: int,
                               emit_ranges: bool) -> int:
    """The lanes per window :func:`screen_multi` launches ``n_guides``
    ``q_len``-base guides over ``n_windows`` windows with (the kernel's
    compile-time table): a launch without ranges is a slot batch, with
    them a genome grid.  Builds the kernels."""
    _check_q_len(q_len, "multi-guide")
    return library("screen_multi").calitas_screen_multi_default_lanes(
        q_len, n_windows, n_guides, int(bool(emit_ranges)))


def _multi_args(genome, qvals, min_scores, kw):
    """``(qvals, min_scores)`` as checked int32 host arrays."""
    qvals = np.ascontiguousarray(qvals, dtype=np.int32)
    min_scores = np.ascontiguousarray(min_scores, dtype=np.int32)
    _check_grid(genome, kw["base0"], kw["step"], kw["n_windows"], kw["window"])
    if qvals.ndim != 3 or qvals.shape[1] != 2 or qvals.shape[2] < 1:
        raise ValueError(f"qvals must be [G, 2, Q] with Q >= 1, got {qvals.shape}")
    G = qvals.shape[0]
    if not 1 <= G <= G_MAX or min_scores.shape != (G,):
        raise ValueError(
            f"need 1..{G_MAX} guides with one min score each: qvals "
            f"{qvals.shape}, min_scores {min_scores.shape}"
        )
    _check_masks(qvals)
    return qvals, min_scores


def _multi_prepared(genome, qvals, min_scores, lanes, kw):
    """The outputs of one multi-guide launch on a CUDA tensor, allocated,
    and the masks and min scores uploaded: ``(launch, (best, ranges))``,
    where ``launch()`` launches the kernel into those outputs on the
    current stream, raises on a refused launch and counts it."""
    G, _, Q = qvals.shape
    dev = genome.device
    n_windows = kw["n_windows"]
    best = torch.empty((G, 2, n_windows), dtype=torch.int32, device=dev)
    ranges = (
        torch.empty((G, 2, 2, n_windows), dtype=torch.int32, device=dev)
        if kw["emit_ranges"]
        else None
    )
    with torch.cuda.device(dev):
        q_dev = to_device(qvals, dev)
        ms_dev = to_device(min_scores, dev)

    def launch():
        lib = library("screen_multi")
        args = (
            genome.data_ptr(), genome.numel(), kw["base0"], kw["step"], kw["window"],
            n_windows, q_dev.data_ptr(), Q, G, ms_dev.data_ptr(), kw["match"],
            kw["mismatch"], kw["qgap"], kw["tgap"], int(bool(kw["pam_gate"])),
            best.data_ptr(), ranges.data_ptr() if ranges is not None else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        with torch.cuda.device(dev):
            if lanes is None:
                err = lib.calitas_screen_multi(*args)
            else:
                err = lib.calitas_screen_multi_lanes(*args, lanes)
        _raise_on(lib, err, "screen_multi")
        _count_launch("screen_multi")

    return launch, (best, ranges)


def _screen_multi(genome, qvals, min_scores, lanes, kw):
    qvals, min_scores = _multi_args(genome, qvals, min_scores, kw)
    if genome.device.type == "cpu":
        return screen_multi_reference(genome, qvals, min_scores, **kw)
    _check_q_len(qvals.shape[2], "multi-guide")
    launch, out = _multi_prepared(genome, qvals, min_scores, lanes, kw)
    if kw["n_windows"] > 0:
        launch()
    return out


def _screen_multi_launcher(genome: torch.Tensor, qvals: np.ndarray,
                           min_scores: np.ndarray, *, lanes=None, **kw):
    """A prepared :func:`screen_multi` (``lanes`` None) or
    :func:`_screen_multi_lanes` call on a CUDA tensor, for timing: the
    masks and min scores go to the card and the outputs are allocated
    once, here; the returned ``launch()`` only launches, into those
    outputs, on the current stream, so it can be captured in a CUDA
    graph.  Returns ``(launch, (best, ranges))``."""
    if genome.device.type != "cuda":
        raise ValueError(f"a prepared launch needs a CUDA tensor, got {genome.device}")
    _check_multi_lanes(lanes, np.shape(qvals)[-1])
    qvals, min_scores = _multi_args(genome, qvals, min_scores, kw)
    _check_q_len(qvals.shape[2], "multi-guide")
    if kw["n_windows"] < 1:
        raise ValueError("a prepared launch needs at least one window")
    return _multi_prepared(genome, qvals, min_scores, lanes, kw)


def _on_device(x, dev: torch.device, dtype: torch.dtype, what: str) -> torch.Tensor:
    """A host array (uploaded without blocking) or a tensor already on
    ``dev``, as a contiguous ``dtype`` tensor there."""
    if not isinstance(x, torch.Tensor):
        x = to_device(np.asarray(x), dev)
    elif x.device != dev:
        raise ValueError(f"{what} is on {x.device}, the targets on {dev}")
    return x.to(dtype).contiguous()


def screen_rows(
    qmasks,
    tmasks: torch.Tensor,
    lengths: torch.Tensor,
    min_scores=None,
    *,
    match: int,
    mismatch: int,
    qgap: int,
    tgap: int,
):
    """Final-row screen of the ``[B, T]`` uint8 target rows ``tmasks``
    with per-row ``lengths`` [B] int32: returns ``best`` [C, B] int32 and,
    with ``min_scores`` [B], ``ranges`` [C, 2, B] int32, else None
    (contract: :func:`screen_rows_reference`).  ``qmasks`` is ``[1, Q]``
    (one query shared by every row: ``_kernel``'s contract) or ``[2, B,
    Q]`` (each row's chain-A and chain-B queries: the pair screen).

    CUDA tensors launch the kernel on the current stream, with the lanes
    per row and chain the kernel's table gives the mode, Q and B
    (:func:`screen_rows_default_lanes`); CPU tensors run the plain
    version.  On CUDA, Q > 48 raises NotImplementedError, and a score set
    whose end shift ``Q * mismatch`` (or NEG_INF shifted by it) leaves
    int32 raises KernelError: the kernel refuses it, as the dual kernel
    does, and nothing falls back."""
    return _screen_rows(qmasks, tmasks, lengths, min_scores, None, dict(
        match=match, mismatch=mismatch, qgap=qgap, tgap=tgap))


def rows_lanes(q_len: int, per_row: bool) -> tuple:
    """The lane counts the row kernel is built for at query length
    ``q_len``, with a query per row (``per_row``) or one shared."""
    return tuple(L for L in ROWS_LANES[bool(per_row)] if L <= q_len)


def _check_rows_lanes(lanes, q_shape: tuple):
    if lanes is None:
        return
    Q, per_row = q_shape[-1], len(q_shape) == 3
    built = rows_lanes(Q, per_row)
    if lanes not in built:
        raise ValueError(f"lanes must be one of {built} at Q={Q} "
                         f"({'per-row' if per_row else 'shared'} query), got {lanes}")


def _screen_rows_lanes(qmasks, tmasks: torch.Tensor, lengths: torch.Tensor,
                       min_scores=None, *, lanes: int, **kw):
    """:func:`screen_rows` with ``lanes`` lanes per row and chain (one of
    :func:`rows_lanes`) instead of the table's choice, for timing and
    checking each lane count of the kernel.  Counts as a ``screen_rows``
    launch.  CPU tensors run the plain version."""
    _check_rows_lanes(lanes, tuple(qmasks.shape))
    return _screen_rows(qmasks, tmasks, lengths, min_scores, lanes, kw)


def screen_rows_default_lanes(q_len: int, n_rows: int, per_row: bool) -> int:
    """The lanes per row :func:`screen_rows` launches ``n_rows`` rows of a
    ``q_len``-base query with, one query per row (``per_row``) or one
    shared (the kernel's compile-time table).  Builds the kernels."""
    _check_q_len(q_len, "row")
    return library("screen_rows").calitas_screen_rows_default_lanes(
        q_len, n_rows, int(bool(per_row)))


def _rows_args(qmasks, tmasks, lengths, min_scores):
    """Checks a row screen's arguments; returns ``(per_row, q_np)``: the
    mode and the masks as a host array where they came as one."""
    if tmasks.dtype != torch.uint8 or tmasks.dim() != 2:
        raise ValueError(
            f"tmasks must be a [B, T] uint8 tensor, got {tmasks.dtype} "
            f"{tuple(tmasks.shape)}"
        )
    if not tmasks.is_contiguous():
        raise ValueError("tmasks must be contiguous")
    if tmasks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tmasks.device}")
    B = tmasks.shape[0]
    q_np = None if isinstance(qmasks, torch.Tensor) else np.asarray(qmasks)
    q_shape = tuple(qmasks.shape)
    per_row = len(q_shape) == 3
    if not (
        (len(q_shape) == 2 and q_shape[0] >= 1 and q_shape[1] >= 1)
        or (per_row and q_shape[0] >= 1 and q_shape[1] == B and q_shape[2] >= 1)
    ):
        raise ValueError(f"qmasks must be [C, Q] or [C, {B}, Q], got {q_shape}")
    if q_np is not None:
        _check_masks(q_np)
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lengths.shape)}")
    if min_scores is not None and tuple(np.shape(min_scores)) != (B,):
        raise ValueError(f"min_scores must be [{B}], got {np.shape(min_scores)}")
    return per_row, q_np


def _rows_prepared(qmasks, tmasks, lengths, min_scores, per_row, q_np, lanes, kw):
    """The outputs of one row-screen launch on CUDA tensors, allocated,
    and the lengths, masks and thresholds on the card: ``(launch, (best,
    ranges))``, where ``launch()`` launches the kernel into those outputs
    on the current stream, raises on a refused launch and counts it."""
    dev = tmasks.device
    B, T = tmasks.shape
    q_shape = tuple(qmasks.shape)
    C, Q = q_shape[0], q_shape[-1]
    if C != (2 if per_row else 1):
        raise ValueError(
            "the CUDA row screen takes one shared query [1, Q] or two "
            f"per-row chains [2, B, Q], got {q_shape}"
        )
    _check_q_len(Q, "row")
    best = torch.empty((C, B), dtype=torch.int32, device=dev)
    ranges = (
        None if min_scores is None
        else torch.empty((C, 2, B), dtype=torch.int32, device=dev)
    )
    with torch.cuda.device(dev):
        ln = _on_device(lengths, dev, torch.int32, "lengths")
        ms = None if min_scores is None else _on_device(
            min_scores, dev, torch.int32, "min_scores"
        )
        query = qrows = None
        if per_row:
            qrows = _on_device(qmasks, dev, torch.uint8, "qmasks")
        else:
            if q_np is None:
                q_np = qmasks.cpu().numpy()
                _check_masks(q_np)
            query = (ctypes.c_int * Q)(*(int(v) for v in q_np.reshape(-1)))

    def launch():
        lib = library("screen_rows")
        args = (
            tmasks.data_ptr(), T, T, B, ln.data_ptr(), query,
            None if qrows is None else qrows.data_ptr(), Q,
            None if ms is None else ms.data_ptr(), kw["match"], kw["mismatch"],
            kw["qgap"], kw["tgap"], best.data_ptr(),
            None if ranges is None else ranges.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        with torch.cuda.device(dev):
            if lanes is None:
                err = lib.calitas_screen_rows(*args)
            else:
                err = lib.calitas_screen_rows_lanes(*args, lanes)
        _raise_on(lib, err, "screen_rows")
        _count_launch("screen_rows")

    return launch, (best, ranges)


def _screen_rows(qmasks, tmasks, lengths, min_scores, lanes, kw):
    per_row, q_np = _rows_args(qmasks, tmasks, lengths, min_scores)
    if tmasks.device.type == "cpu":
        return screen_rows_reference(qmasks, tmasks, lengths, min_scores, **kw)
    launch, out = _rows_prepared(qmasks, tmasks, lengths, min_scores, per_row, q_np,
                                 lanes, kw)
    if tmasks.shape[0] > 0:
        launch()
    return out


def _screen_rows_launcher(qmasks, tmasks: torch.Tensor, lengths: torch.Tensor,
                          min_scores=None, *, lanes=None, **kw):
    """A prepared :func:`screen_rows` (``lanes`` None) or
    :func:`_screen_rows_lanes` call on a CUDA tensor, for timing: the
    lengths, masks and thresholds go to the card and the outputs are
    allocated once, here; the returned ``launch()`` only launches, into
    those outputs, on the current stream, so it can be captured in a CUDA
    graph.  Returns ``(launch, (best, ranges))``."""
    if tmasks.device.type != "cuda":
        raise ValueError(f"a prepared launch needs a CUDA tensor, got {tmasks.device}")
    _check_rows_lanes(lanes, tuple(qmasks.shape))
    per_row, q_np = _rows_args(qmasks, tmasks, lengths, min_scores)
    if tmasks.shape[0] < 1:
        raise ValueError("a prepared launch needs at least one row")
    return _rows_prepared(qmasks, tmasks, lengths, min_scores, per_row, q_np, lanes, kw)


class CudaScreenKernel(ScreenKernel):
    """The counterpart of ``calitas_tpu/ops/dp_pallas2.py::
    PallasScreenKernelV2``: the :class:`ScreenKernel` API with the maxima
    computed by :func:`screen_rows` in shared-query mode: the CUDA kernel
    on the card (the default device, which raises where torch sees none),
    its plain version when asked for ``"cpu"``."""

    @staticmethod
    def supports(q_len: int) -> bool:
        return q_len <= Q_MAX

    def _best(self, qmask: np.ndarray, tm, ln) -> torch.Tensor:
        best, _ = screen_rows(np.asarray(qmask)[None], tm, ln, **self._scores())
        return best[0]
