"""The CUDA screens (``csrc/screen_dual.cu``, ``csrc/screen_multi.cu``,
``csrc/screen_rows.cu``): build, wrappers, launch counters and the static
route between a kernel and its plain version.

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
:func:`build_all` starts one ``nvcc`` per source, all at once.
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

from calitas_tpu_torch.ops.dp_screen import (
    ScreenKernel,
    screen_dual_reference,
    screen_multi_reference,
    screen_rows_reference,
)

logger = logging.getLogger("calitas_tpu_torch.screen")

#: longest query the kernels are instantiated for (the reference's unroll
#: limit, calitas_tpu/ops/dp_pallas2.py:133-134)
Q_MAX = 48
#: most guides one screen_multi launch takes (the grid's y extent)
G_MAX = 65535

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {
    "screen_dual": _CSRC / "screen_dual.cu",
    "screen_multi": _CSRC / "screen_multi.cu",
    "screen_rows": _CSRC / "screen_rows.cu",
}
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)

#: kernel launches by kernel name; callers that need to show a kernel ran
#: call :func:`reset_launches` and read this afterwards
launches = {name: 0 for name in SOURCES}

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
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    key = hashlib.sha256(
        SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_all(names) -> dict:
    """The kernel libraries ``{name: path}``, compiling with one ``nvcc``
    per source, all started together, unless a build of this exact source
    and flag set exists.  Raises with nvcc's stderr on failure.  ptxas's
    register and spill report goes beside each as ``<lib>.log``."""
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
        raise RuntimeError("\n".join(failed))
    return libs


def _bind(lib: ctypes.CDLL, name: str) -> None:
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if name == "screen_dual":
        lib.calitas_screen_dual.argtypes = [
            vp, ll, ll, ll, i32, i32,  # genome, len, base0, step, window, n
            ctypes.POINTER(i32), i32,  # qvals, q_len
            i32, i32, i32, i32, i32, i32,  # scores, min_score, pam_gate
            vp, vp, vp,  # best, ranges, stream
        ]
        lib.calitas_screen_dual.restype = i32
    elif name == "screen_rows":
        lib.calitas_screen_rows.argtypes = [
            vp, ll, i32, i32, vp,  # tmasks, ld, T, n_rows, lengths
            ctypes.POINTER(i32), vp, i32,  # query (host), qrows, q_len
            vp, i32, i32, i32, i32,  # min_scores, scores
            vp, vp, vp,  # best, ranges, stream
        ]
        lib.calitas_screen_rows.restype = i32
    else:
        lib.calitas_screen_multi.argtypes = [
            vp, ll, ll, ll, i32, i32,  # genome, len, base0, step, window, n
            vp, i32, i32, vp,  # qvals, q_len, n_guides, min_scores
            i32, i32, i32, i32, i32,  # scores, pam_gate
            vp, vp, vp,  # best, ranges (0 = none), stream
        ]
        lib.calitas_screen_multi.restype = i32
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
                lib = ctypes.CDLL(str(path))
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
            "a kernel form is ROADMAP Queue 2 item 6"
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
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


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

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    the plain version.  Q > 48 on CUDA raises NotImplementedError."""
    qvals = np.asarray(qvals)
    _check_grid(genome, base0, step, n_windows, window)
    if qvals.ndim != 2 or qvals.shape[0] != 2 or qvals.shape[1] < 1:
        raise ValueError(f"qvals must be [2, Q] with Q >= 1, got {qvals.shape}")
    _check_masks(qvals)
    kw = dict(
        base0=base0, step=step, n_windows=n_windows, window=window,
        min_score=min_score, match=match, mismatch=mismatch, qgap=qgap,
        tgap=tgap, pam_gate=pam_gate,
    )
    if genome.device.type == "cpu":
        return screen_dual_reference(genome, qvals, **kw)
    Q = qvals.shape[1]
    _check_q_len(Q, "dual")
    dev = genome.device
    best = torch.empty((2, n_windows), dtype=torch.int32, device=dev)
    ranges = torch.empty((2, 2, n_windows), dtype=torch.int32, device=dev)
    if n_windows == 0:
        return best, ranges
    lib = library("screen_dual")
    q = (ctypes.c_int * (2 * Q))(*(int(v) for v in qvals.reshape(-1)))
    with torch.cuda.device(dev):
        err = lib.calitas_screen_dual(
            genome.data_ptr(), genome.numel(), base0, step, window, n_windows,
            q, Q, match, mismatch, qgap, tgap, min_score, int(bool(pam_gate)),
            best.data_ptr(), ranges.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
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
    tensors' device, so a launching thread's work stays in its order."""
    dev = dev_out[0].device
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
            event.synchronize()
        return finish(*(h.numpy() for h in host))

    return resolve


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

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    the plain version.  Q > 48 on CUDA raises NotImplementedError."""
    qvals = np.ascontiguousarray(qvals, dtype=np.int32)
    min_scores = np.ascontiguousarray(min_scores, dtype=np.int32)
    _check_grid(genome, base0, step, n_windows, window)
    if qvals.ndim != 3 or qvals.shape[1] != 2 or qvals.shape[2] < 1:
        raise ValueError(f"qvals must be [G, 2, Q] with Q >= 1, got {qvals.shape}")
    G, _, Q = qvals.shape
    if not 1 <= G <= G_MAX or min_scores.shape != (G,):
        raise ValueError(
            f"need 1..{G_MAX} guides with one min score each: qvals "
            f"{qvals.shape}, min_scores {min_scores.shape}"
        )
    _check_masks(qvals)
    kw = dict(
        base0=base0, step=step, n_windows=n_windows, window=window,
        match=match, mismatch=mismatch, qgap=qgap, tgap=tgap,
        pam_gate=pam_gate, emit_ranges=emit_ranges,
    )
    if genome.device.type == "cpu":
        return screen_multi_reference(genome, qvals, min_scores, **kw)
    _check_q_len(Q, "multi-guide")
    dev = genome.device
    best = torch.empty((G, 2, n_windows), dtype=torch.int32, device=dev)
    ranges = (
        torch.empty((G, 2, 2, n_windows), dtype=torch.int32, device=dev)
        if emit_ranges
        else None
    )
    if n_windows == 0:
        return best, ranges
    lib = library("screen_multi")
    with torch.cuda.device(dev):
        q_dev = to_device(qvals, dev)
        ms_dev = to_device(min_scores, dev)
        err = lib.calitas_screen_multi(
            genome.data_ptr(), genome.numel(), base0, step, window, n_windows,
            q_dev.data_ptr(), Q, G, ms_dev.data_ptr(), match, mismatch, qgap,
            tgap, int(bool(pam_gate)), best.data_ptr(),
            ranges.data_ptr() if ranges is not None else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "screen_multi")
    _count_launch("screen_multi")
    return best, ranges


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

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    the plain version.  Q > 48 on CUDA raises NotImplementedError."""
    if tmasks.dtype != torch.uint8 or tmasks.dim() != 2:
        raise ValueError(
            f"tmasks must be a [B, T] uint8 tensor, got {tmasks.dtype} "
            f"{tuple(tmasks.shape)}"
        )
    if not tmasks.is_contiguous():
        raise ValueError("tmasks must be contiguous")
    dev = tmasks.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    B, T = tmasks.shape
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
    kw = dict(match=match, mismatch=mismatch, qgap=qgap, tgap=tgap)
    if dev.type == "cpu":
        return screen_rows_reference(qmasks, tmasks, lengths, min_scores, **kw)
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
    if B == 0:
        return best, ranges
    lib = library("screen_rows")
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
        err = lib.calitas_screen_rows(
            tmasks.data_ptr(), T, T, B, ln.data_ptr(), query,
            None if qrows is None else qrows.data_ptr(), Q,
            None if ms is None else ms.data_ptr(), match, mismatch, qgap,
            tgap, best.data_ptr(), None if ranges is None else ranges.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "screen_rows")
    _count_launch("screen_rows")
    return best, ranges


class CudaScreenKernel(ScreenKernel):
    """The counterpart of ``calitas_tpu/ops/dp_pallas2.py::
    PallasScreenKernelV2``: the :class:`ScreenKernel` API with the maxima
    computed by :func:`screen_rows` in shared-query mode (the CUDA kernel
    on a CUDA device, its plain version on the CPU)."""

    @staticmethod
    def supports(q_len: int) -> bool:
        return q_len <= Q_MAX

    def _best(self, qmask: np.ndarray, tm, ln) -> torch.Tensor:
        best, _ = screen_rows(np.asarray(qmask)[None], tm, ln, **self._scores())
        return best[0]
