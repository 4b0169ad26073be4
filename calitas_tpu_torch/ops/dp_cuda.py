"""The CUDA dual-chain screen (``csrc/screen_dual.cu``): build, wrapper
and launch counter.

:func:`screen_dual` replaces ``calitas_tpu/ops/dp_pallas2.py::
_pallas_screen_dual`` (kernel ``_kernel2``).  A CUDA tensor goes to the
kernel or raises; a CPU tensor goes to the plain PyTorch version,
:func:`~calitas_tpu_torch.ops.dp_screen.screen_dual_reference`.  There is
no fallback between the two.

The kernel is built from the repository's source with ``nvcc`` at first
use, into ``csrc/build/`` (git-ignored), keyed by a hash of the source
and flags, and loaded with ``ctypes`` through its plain C interface.
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

from calitas_tpu_torch.ops.dp_screen import screen_dual_reference

#: longest query the kernel is instantiated for (the reference's unroll
#: limit, calitas_tpu/ops/dp_pallas2.py:133-134)
Q_MAX = 48

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "screen_dual.cu"
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)

#: kernel launches made by :func:`screen_dual`; callers that need to show
#: the kernel ran reset it to 0 and read it afterwards
launches = 0

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def build() -> Path:
    """The kernel library, compiled with nvcc unless a build of this exact
    source and flag set exists.  Raises with nvcc's stderr on failure.
    ptxas's register and spill report goes beside it as ``<lib>.log``."""
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"screen_dual-{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {SOURCE}:\n"
            f"{proc.stderr}"
        )
    lib.with_name(lib.name + ".log").write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.calitas_screen_dual.argtypes = [
                vp, ll, ll, ll, i32, i32,  # genome, len, base0, step, window, n
                ctypes.POINTER(i32), i32,  # qvals, q_len
                i32, i32, i32, i32, i32, i32,  # scores, min_score, pam_gate
                vp, vp, vp,  # best, ranges, stream
            ]
            lib.calitas_screen_dual.restype = i32
            lib.calitas_cuda_error_string.argtypes = [i32]
            lib.calitas_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check_args(genome, qvals, base0, step, n_windows, window):
    if genome.dtype != torch.uint8 or genome.dim() != 1:
        raise ValueError(
            f"genome must be a 1-D uint8 tensor, got {genome.dtype} "
            f"{tuple(genome.shape)}"
        )
    if not genome.is_contiguous():
        raise ValueError("genome must be contiguous")
    if qvals.ndim != 2 or qvals.shape[0] != 2 or qvals.shape[1] < 1:
        raise ValueError(f"qvals must be [2, Q] with Q >= 1, got {qvals.shape}")
    if qvals.min() < 0 or qvals.max() > 15:
        raise ValueError("qvals must be 4-bit IUPAC masks")
    if window < 1 or step < 1 or base0 < 0 or n_windows < 0:
        raise ValueError(
            f"bad window grid: base0={base0} step={step} "
            f"n_windows={n_windows} window={window}"
        )
    if n_windows >= 2**31:
        raise ValueError(f"n_windows {n_windows} exceeds int32")


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
    global launches
    qvals = np.asarray(qvals)
    _check_args(genome, qvals, base0, step, n_windows, window)
    kw = dict(
        base0=base0, step=step, n_windows=n_windows, window=window,
        min_score=min_score, match=match, mismatch=mismatch, qgap=qgap,
        tgap=tgap, pam_gate=pam_gate,
    )
    if genome.device.type == "cpu":
        return screen_dual_reference(genome, qvals, **kw)
    if genome.device.type != "cuda":
        raise ValueError(f"unsupported device {genome.device}")
    Q = qvals.shape[1]
    if Q > Q_MAX:
        raise NotImplementedError(
            f"CUDA dual screen takes queries up to {Q_MAX} bases (got {Q}): "
            "ROADMAP Queue 2 item 6"
        )
    dev = genome.device
    best = torch.empty((2, n_windows), dtype=torch.int32, device=dev)
    ranges = torch.empty((2, 2, n_windows), dtype=torch.int32, device=dev)
    if n_windows == 0:
        return best, ranges
    lib = library()
    q = (ctypes.c_int * (2 * Q))(*(int(v) for v in qvals.reshape(-1)))
    with torch.cuda.device(dev):
        err = lib.calitas_screen_dual(
            genome.data_ptr(), genome.numel(), base0, step, window, n_windows,
            q, Q, match, mismatch, qgap, tgap, min_score, int(bool(pam_gate)),
            best.data_ptr(), ranges.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.calitas_cuda_error_string(err).decode()
        raise RuntimeError(f"screen_dual launch failed: CUDA error {err} ({msg})")
    launches += 1
    return best, ranges
