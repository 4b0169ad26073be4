"""The CUDA screens (``csrc/screen_dual.cu``, ``csrc/screen_multi.cu``):
build, wrappers and launch counters.

:func:`screen_dual` replaces ``calitas_tpu/ops/dp_pallas2.py::
_pallas_screen_dual`` (kernel ``_kernel2``) and :func:`screen_multi`
replaces ``_pallas_screen_multi`` (kernel ``_kernel_multi``).  A CUDA
tensor goes to the kernel or raises; a CPU tensor goes to the plain
PyTorch version in :mod:`~calitas_tpu_torch.ops.dp_screen`.  There is no
fallback between the two.

Each kernel is built from the repository's source with ``nvcc`` at first
use, into ``csrc/build/`` (git-ignored), keyed by a hash of the source
and flags, and loaded with ``ctypes`` through its plain C interface.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from calitas_tpu_torch.ops.dp_screen import (
    screen_dual_reference,
    screen_multi_reference,
)

#: longest query the kernels are instantiated for (the reference's unroll
#: limit, calitas_tpu/ops/dp_pallas2.py:133-134)
Q_MAX = 48
#: most guides one screen_multi launch takes (the grid's y extent)
G_MAX = 65535

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {
    "screen_dual": _CSRC / "screen_dual.cu",
    "screen_multi": _CSRC / "screen_multi.cu",
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
            "ROADMAP Queue 2 item 6"
        )


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
