"""Native (C++) host engine: build-on-demand ctypes bindings.

The shared library is compiled from ``aligner.cpp`` on first use and
cached next to the source.  All callers fall back to the NumPy oracle
when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).parent
_LIB_PATH = _HERE / "libcalitas.so"
_SRCS = [_HERE / "aligner.cpp", _HERE / "variants.cpp"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

#: Expected C ABI version; must match calitas_abi_version() in
#: aligner.cpp.  Checked at load so a stale prebuilt .so whose mtime
#: postdates the sources (copied artifact, rsync -t) cannot load
#: silently with a mismatched buffer layout.
_ABI_VERSION = 5


def build(force: bool = False) -> Path:
    """Compile the shared library (g++ -O3)."""
    stale = force or not _LIB_PATH.exists() or any(
        _LIB_PATH.stat().st_mtime < s.stat().st_mtime for s in _SRCS
    )
    if stale:
        # Each process builds into its own file and renames it into
        # place: processes that build at once (test workers) never load a
        # half-written library, and a loaded one keeps its inode.
        tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            *[str(s) for s in _SRCS], "-o", str(tmp),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, _LIB_PATH)
        finally:
            tmp.unlink(missing_ok=True)
    return _LIB_PATH


def _abi_of(lib: ctypes.CDLL) -> int:
    """The loaded library's ABI version; -1 for pre-versioned builds."""
    try:
        fn = lib.calitas_abi_version
    except AttributeError:
        return -1
    fn.restype = ctypes.c_int32
    fn.argtypes = []
    return int(fn())


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building if needed; None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = build()
            lib = ctypes.CDLL(str(path))
            if _abi_of(lib) != _ABI_VERSION:
                # Stale artifact with a fresh mtime: unlink first so the
                # rebuild gets a new inode (overwriting a mapped .so in
                # place is UB; dlopen of the new inode returns a fresh
                # handle while the stale mapping stays parked).
                _LIB_PATH.unlink(missing_ok=True)
                build(force=True)
                lib = ctypes.CDLL(str(path))
                if _abi_of(lib) != _ABI_VERSION:
                    return None
        except Exception:
            return None
        i32 = ctypes.c_int32
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        charp = ctypes.c_char_p
        lib.dp_final_row.restype = i32
        lib.dp_final_row.argtypes = [u8p, i32, u8p, i32, i32, i32, i32, i32, i32p]
        lib.dp_align_multi.restype = i32
        lib.dp_align_multi.argtypes = [
            u8p, i32, u8p, i32,  # qmask, Q, tmask, T
            i32, i32, i32, i32,  # match, mismatch, qgap, tgap
            i32, i32,  # min_score, max_hits
            i32p, i32p, i32p,  # scores, ends, starts
            ctypes.c_void_p, i32,  # ops buffer, cap
            i32p, i32p,  # ops_off, ops_len
        ]
        # search_pass is called once per candidate-window strand pass;
        # ndpointer's from_param marshalling was ~half the per-call cost,
        # so all array arguments are raw pointers (callers pass
        # ``arr.ctypes.data`` of arrays they keep alive across the call).
        vp = ctypes.c_void_p
        lib.search_pass.restype = i32
        lib.search_pass.argtypes = [
            vp, i32, vp, i32,  # qmask, Q, tmask, T
            vp, vp, vp, i32,  # pams, pam_off, pam_len, n_pams
            i32, i32, i32, i32,  # match, mismatch, qgap, tgap
            i32, i32,  # pam_match, pam_mismatch
            i32,  # min_score
            i32, i32, i32, i32,  # max_guide_diffs, max_pam_mm, max_gap, max_total
            i32,  # max_out
            vp, vp, vp, vp, vp, vp,  # tstart,tend,score,pam_idx,gaps,edits
            vp, i32,  # ops buffer, cap
            vp, vp,  # ops_off, ops_len
        ]
        # finish_batch processes a whole chunk of candidate windows in one
        # call; raw pointers for the same reason as search_pass.
        i64 = ctypes.c_int64
        lib.finish_batch.restype = i32
        lib.finish_batch.argtypes = [
            vp, i32,  # qletters, Q
            vp, vp, vp, i32,  # pam_letters, pam_off, pam_len, n_pams
            i32,  # is5prime
            i32, i32, i32, i32,  # match, mismatch, qgap, tgap
            i32, i32,  # pam_match, pam_mismatch
            i32,  # min_score
            i32, i32, i32, i32,  # max_guide_diffs, max_pam_mm, max_gap, ext_total
            i32, i32,  # max_total_diffs, max_overlap
            vp, vp, vp, vp, vp,  # wbytes, woff, wlen, pass_mask, ranges
            i32,  # n_windows
            i32,  # max_out
            vp,  # out_meta
            vp, i64, vp, vp, vp,  # out_str, cap, off, plen, ulen
            vp, i64, vp, vp,  # out_cig, cap, off, len
        ]
        # finish_batch_render: finish_batch + full 34-column line
        # composition in native code (the production reference-pass path).
        lib.finish_batch_render.restype = i32
        lib.finish_batch_render.argtypes = [
            vp, i32,  # qletters, Q
            vp, vp, vp, i32,  # pam_letters, pam_off, pam_len, n_pams
            i32,  # is5prime
            i32, i32, i32, i32,  # match, mismatch, qgap, tgap
            i32, i32,  # pam_match, pam_mismatch
            i32,  # min_score
            i32, i32, i32, i32,  # max_guide_diffs, max_pam_mm, max_gap, ext_total
            i32, i32,  # max_total_diffs, max_overlap
            vp, vp, vp, vp, vp,  # wbytes, woff, wlen, pass_mask, ranges
            i32,  # n_windows
            vp, vp, vp, vp, vp,  # fbytes, foff, flen, fstart1, wstart1
            vp, i32,  # chrom, chrom_len
            vp, i32,  # guide_id
            vp, i32,  # unpadded guide
            vp, i32,  # genome build
            vp, i32,  # guide-length digits
            vp, i32,  # tail (aligner..time_stamp)
            i32,  # max_out
            vp,  # out_meta8
            vp, i64,  # out_lines, cap
            vp, vp,  # out_line_off, out_line_len
        ]
        # materialize_finish_render: raw context slices in -> rendered
        # lines out (N-trim, uppercase, range mapping and line rendering
        # all native; the worker's per-candidate Python is one mmap read).
        lib.materialize_finish_render.restype = i32
        lib.materialize_finish_render.argtypes = [
            vp, i32,  # qletters, Q
            vp, vp, vp, i32,  # pam_letters, pam_off, pam_len, n_pams
            i32,  # is5prime
            i32, i32, i32, i32,  # match, mismatch, qgap, tgap
            i32, i32,  # pam_match, pam_mismatch
            i32,  # min_score
            i32, i32, i32, i32,  # max_guide_diffs, max_pam_mm, max_gap, ext_total
            i32, i32,  # max_total_diffs, max_overlap
            vp, vp, vp, vp, vp, vp,  # cbytes, coff, clen, cstart1, wstart0, wraw_len
            vp, vp, i32,  # pass_mask, cranges, n_windows
            i32,  # min_window_len
            vp, i32,  # chrom
            vp, i32,  # guide_id
            vp, i32,  # unpadded guide
            vp, i32,  # genome build
            vp, i32,  # guide-length digits
            vp, i32,  # tail
            i32,  # max_out
            vp,  # out_meta8
            vp, i64,  # out_lines, cap
            vp, vp,  # out_line_off, out_line_len
        ]
        # materialize_finish_render_raw: contexts addressed directly in
        # the mmap'd FASTA file bytes (newlines stripped natively) — the
        # worker ships ONE buffer pointer + three offset/length arrays,
        # zero per-candidate Python.
        lib.materialize_finish_render_raw.restype = i32
        lib.materialize_finish_render_raw.argtypes = [
            vp, i32,  # qletters, Q
            vp, vp, vp, i32,  # pam_letters, pam_off, pam_len, n_pams
            i32,  # is5prime
            i32, i32, i32, i32,  # match, mismatch, qgap, tgap
            i32, i32,  # pam_match, pam_mismatch
            i32,  # min_score
            i32, i32, i32, i32,  # max_guide_diffs, max_pam_mm, max_gap, ext_total
            i32, i32,  # max_total_diffs, max_overlap
            vp, vp, vp, vp,  # fasta_bytes, raw_off, raw_len, cbase_len
            vp, vp, vp,  # cstart1, wstart0, wraw_len
            vp, vp, i32,  # pass_mask, cranges, n_windows
            i32,  # min_window_len
            vp, i32,  # chrom
            vp, i32,  # guide_id
            vp, i32,  # unpadded guide
            vp, i32,  # genome build
            vp, i32,  # guide-length digits
            vp, i32,  # tail
            i32,  # max_out
            vp,  # out_meta8
            vp, i64,  # out_lines, cap
            vp, vp,  # out_line_off, out_line_len
        ]
        # build_variant_windows: one call per block of same-chrom VCF
        # records; raw pointers like search_pass (callers keep the
        # arrays alive across the call).
        lib.build_variant_windows.restype = i32
        lib.build_variant_windows.argtypes = [
            vp, vp, vp, i32, i32, i32,  # blob, rec_start, rec_end, n, final, rec_base
            vp, i64, i64, i32,  # ref_bases, ref_len, padding, max_variants
            vp, i64, vp, vp, vp,  # bases, cap, woff, wlen, wstart
            vp, i64, vp, vp,  # cig, cap, cigoff, ciglen
            vp, vp, vp, vp,  # voff, vcnt, vrec, valt
            i32, i32,  # win_cap, vpair_cap
            vp, i32,  # warn, warn_cap
            vp, vp, vp,  # n_windows_out, n_vpairs_out, n_warn_out
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None
