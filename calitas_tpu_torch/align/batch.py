"""Batched native window finisher.

One ctypes call finishes a whole chunk of candidate windows: glocal DP,
PAM extension, intra-window dedup and the full GuideAlignment rendering
(padded strings, counters, guide-only coordinates) all happen in C++
(``native/aligner.cpp::finish_batch``).  Behavior is bit-identical to
``SequentialAligner.align`` (SequentialGuideAligner.scala:228-322) —
enforced by the differential fuzz in tests/test_batch_finish.py.

The production host-finish path of the TPU search is
:func:`finish_rendered` (native buffers straight to final TSV lines +
dedup keys at ~5 us/window of Python); :func:`finish_windows` decodes
the same buffers into :class:`GuideAlignment` objects and anchors the
line-for-line differential between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from calitas_tpu_torch.core.cigar import LazyCigar
from calitas_tpu_torch.core.guide import Guide
from calitas_tpu_torch.core.sequence import revcomp
from calitas_tpu_torch.align.guide_alignment import GuideAlignment

#: meta record layout emitted by finish_batch (aligner.cpp)
_META_COLS = 16


def max_target_span(Q: int, match: int, qgap: int, min_score: int, T: int) -> int:
    """Maximum target columns an above-``min_score`` guide alignment can
    consume: Q matches plus D_max guide-gap columns, each costing |qgap|
    out of the at-most ``match*Q`` budget (mirrors aligner.cpp's
    ``d_max`` derivation — the slice-DP exactness bound)."""
    surplus = match * Q - min_score
    if surplus <= 0:
        d = 0
    elif qgap < 0:
        d = surplus // -qgap
    else:
        d = T
    return Q + d


def chain_ranges_to_pass(
    cr: tuple, trim: int, T: int, span: int
) -> tuple[int, int, int, int]:
    """Convert screen-window chain end-column ranges into native pass
    ranges on the materialized window.

    ``cr`` = (loA, hiA, loB, hiB): 1-based inclusive qualifying
    end-column bounds in SCREEN window coordinates (chain A = DP query
    over the forward window = native pass 0; chain B = revcomp'd query).
    ``trim`` = leading bases N-trimmed from the screen window during
    materialization; ``T`` = materialized window length.

    Chain A maps by the trim shift.  Chain B alignments mirror to native
    pass 1 (DP query over the revcomp'd window): an alignment ENDING at
    forward column e starts at s >= e - span + 1, and its pass-1 end
    column is T + 1 - s — hence the span widening on the high side.
    Containment of every qualifying end makes the sliced finish exact."""
    loA, hiA, loB, hiB = cr
    lo0, hi0 = max(1, loA - trim), min(T, hiA - trim)
    lo1 = max(1, T + 1 - (hiB - trim))
    hi1 = min(T, T - (loB - trim) + span)
    if hi0 < lo0:
        lo0, hi0 = 1, 0  # no qualifying ends: native pass returns nothing
    if hi1 < lo1:
        lo1, hi1 = 1, 0
    return lo0, hi0, lo1, hi1


def cpp_pass_for(engine_pass: str, is5prime: bool) -> int:
    """Map an engine pass name ('fwd'/'rev') to the native pass index
    (0 = forward target order, 1 = revcomp).  For 5'-PAM guides the
    engine's fwd strand pass aligns against the revcomp'd target
    (SequentialGuideAligner.scala:260-293)."""
    if engine_pass == "fwd":
        return 1 if is5prime else 0
    return 0 if is5prime else 1


def _pack_query_pams(guide: Guide):
    """Encoded DP-orientation query + PAM arrays shared by every native
    finish call, or None when a PAM exceeds the native 63-base mismatch
    mask (callers then fall back to the Python engine, which handles any
    length)."""
    is5 = guide.pam_is_5prime
    query = guide.guide_rc if is5 else guide.guide_fw
    pams = guide.pams_rc if is5 else guide.pams_fw
    if any(len(p) > 63 for p in pams):
        return None
    qbytes = np.frombuffer(query.encode("ascii"), dtype=np.uint8)
    pam_bytes = [p.encode("ascii") for p in pams]
    pam_cat = np.frombuffer(b"".join(pam_bytes) or b"\0", dtype=np.uint8)
    n_pams = len(pam_bytes)
    pam_off = np.zeros(max(n_pams, 1), np.int32)
    pam_len = np.zeros(max(n_pams, 1), np.int32)
    off = 0
    for k, p in enumerate(pam_bytes):
        pam_off[k] = off
        pam_len[k] = len(p)
        off += len(p)
    max_pam_len = max((len(p) for p in pam_bytes), default=0)
    return (is5, query, pams, qbytes, pam_cat, pam_off, pam_len, n_pams,
            max_pam_len)


def _pack_seqs(seqs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate byte sequences -> (cat uint8, off int64, len int32)."""
    slen = np.array([len(b) for b in seqs], dtype=np.int32)
    soff = np.zeros(len(seqs), dtype=np.int64)
    if len(seqs) > 1:
        soff[1:] = np.cumsum(slen[:-1], dtype=np.int64)
    sbytes = np.empty(int(slen.sum()) or 1, dtype=np.uint8)
    for i, b in enumerate(seqs):
        sbytes[soff[i] : soff[i] + slen[i]] = (
            np.frombuffer(b, dtype=np.uint8) if isinstance(b, bytes) else b
        )
    return sbytes, soff, slen


def _pass_mask_for(passes_list, is5: bool, n: int) -> np.ndarray:
    """Engine pass tuples -> native pass bitmask per window (bit0 = cpp
    pass 0, bit1 = cpp pass 1)."""
    pass_mask = np.zeros(n, dtype=np.uint8)
    for i, ps in enumerate(passes_list):
        m = 0
        for p in ps:
            m |= 1 << cpp_pass_for(p, is5)
        pass_mask[i] = m
    return pass_mask


def _native_finish_raw(
    guide: Guide,
    aligner,  # SequentialAligner (scorer + min_guide_score)
    windows: Sequence[tuple[str, int, np.ndarray]],  # (chrom, start1, bases)
    passes_list: Sequence[tuple[str, ...]],
    ranges: Optional[np.ndarray],
    *,
    max_guide_diffs: int,
    max_pam_diffs: int,
    max_gaps_between_guide_and_pam: int,
    max_total_diffs: int,
    max_overlap: int,
):
    """One native finish_batch call; returns the raw result buffers (or
    None when the native library is missing)."""
    from calitas_tpu_torch import native

    lib = native.get_lib()
    if lib is None:
        return None

    qp = _pack_query_pams(guide)
    if qp is None:
        return None  # PAM too long for the native mask: Python engine
    is5, query, pams, qbytes, pam_cat, pam_off, pam_len, n_pams, \
        max_pam_len = qp
    Q = len(qbytes)

    n = len(windows)
    wbytes, woff, wlen = _pack_seqs([b for _, _, b in windows])
    pass_mask = _pass_mask_for(passes_list, is5, n)
    if ranges is None:
        ranges_arr = np.zeros((max(n, 1), 4), dtype=np.int32)
    else:
        ranges_arr = np.ascontiguousarray(ranges, dtype=np.int32)

    s = aligner.scorer
    min_score = aligner.min_guide_score(guide, max_guide_diffs)
    ext_total = max_guide_diffs + max_gaps_between_guide_and_pam + max_pam_diffs

    max_out = max(256, 4 * n)
    aln_width = Q + max_pam_len + max_gaps_between_guide_and_pam + 8
    while True:
        meta = np.empty((max_out, _META_COLS), dtype=np.int32)
        str_cap = max_out * 4 * aln_width
        cig_cap = max_out * 4 * aln_width
        out_str = np.empty(str_cap, dtype=np.uint8)
        out_cig = np.empty(cig_cap, dtype=np.uint8)
        str_off = np.empty(max_out, dtype=np.int64)
        plen = np.empty(max_out, dtype=np.int32)
        ulen = np.empty(max_out, dtype=np.int32)
        cig_off = np.empty(max_out, dtype=np.int64)
        cig_len = np.empty(max_out, dtype=np.int32)
        n_out = lib.finish_batch(
            qbytes.ctypes.data, Q,
            pam_cat.ctypes.data, pam_off.ctypes.data, pam_len.ctypes.data,
            n_pams,
            1 if is5 else 0,
            s.match_score, s.mismatch_score, s.query_gap_score,
            s.target_gap_score, s.pam_match_score, s.pam_mismatch_score,
            int(min_score),
            max_guide_diffs, max_pam_diffs, max_gaps_between_guide_and_pam,
            ext_total, max_total_diffs, max_overlap,
            wbytes.ctypes.data, woff.ctypes.data, wlen.ctypes.data,
            pass_mask.ctypes.data, ranges_arr.ctypes.data, n,
            max_out,
            meta.ctypes.data,
            out_str.ctypes.data, ctypes.c_int64(str_cap),
            str_off.ctypes.data, plen.ctypes.data, ulen.ctypes.data,
            out_cig.ctypes.data, ctypes.c_int64(cig_cap),
            cig_off.ctypes.data, cig_len.ctypes.data,
        )
        if n_out == -1:
            max_out *= 4
            continue
        if n_out < 0:
            raise AssertionError(f"native finish_batch error: {n_out}")
        break

    # Guide strings (incl. chosen PAM) come from a tiny set per run.
    guide_cache: dict[int, str] = {}

    def guide_str(pam_idx: int) -> str:
        gstr = guide_cache.get(pam_idx)
        if gstr is None:
            qp = query + (pams[pam_idx] if pam_idx >= 0 else "")
            gstr = revcomp(qp) if is5 else qp
            guide_cache[pam_idx] = gstr
        return gstr

    return (
        n_out, meta,
        # copy only the used prefixes (capacity is 4x-grown; the last
        # hit's strings are 3*plen + ulen bytes at str_off)
        out_str[
            : (int(str_off[n_out - 1]) + 3 * int(plen[n_out - 1])
               + int(ulen[n_out - 1])) if n_out else 0
        ].tobytes(),
        out_cig[
            : (int(cig_off[n_out - 1]) + int(cig_len[n_out - 1]))
            if n_out else 0
        ].tobytes(),
        str_off, plen,
        ulen, cig_off, cig_len, guide_str,
    )


def finish_windows(
    guide: Guide,
    aligner,
    windows: Sequence[tuple[str, int, np.ndarray]],
    passes_list: Sequence[tuple[str, ...]],
    ranges: Optional[np.ndarray] = None,  # int32 [n, 4]: lo0,hi0,lo1,hi1
    **limits,
) -> Optional[list[list[GuideAlignment]]]:
    """Finish a batch of windows; returns per-window GuideAlignment lists
    in the engine's order, or None when the native library is missing."""
    raw = _native_finish_raw(
        guide, aligner, windows, passes_list, ranges, **limits
    )
    if raw is None:
        return None
    (n_out, meta, str_view, cig_view, str_off, plen, ulen, cig_off,
     cig_len, guide_str) = raw
    n = len(windows)
    out: list[list[GuideAlignment]] = [[] for _ in range(n)]
    for k in range(n_out):
        (widx, strandc, pam_idx, score, s0, e0, gs, ge,
         mism, gapb, gmm, ggap, pmm, pgap, _kind, _r) = (
            int(x) for x in meta[k]
        )
        chrom, start1, _b = windows[widx]
        toff = start1 - 1
        so = int(str_off[k])
        pl = int(plen[k])
        pg = str_view[so : so + pl].decode("ascii")
        pa = str_view[so + pl : so + 2 * pl].decode("ascii")
        pt = str_view[so + 2 * pl : so + 3 * pl].decode("ascii")
        ut = str_view[so + 3 * pl : so + 3 * pl + int(ulen[k])].decode("ascii")
        cig = cig_view[int(cig_off[k]) : int(cig_off[k]) + int(cig_len[k])].decode(
            "ascii"
        )
        ga = GuideAlignment(
            guide=guide_str(pam_idx),
            chrom=chrom,
            start_offset=toff + s0,
            end_offset=toff + e0,
            guide_start_offset=toff + gs,
            guide_end_offset=toff + ge,
            strand="+" if strandc == 0 else "-",
            score=score,
            cigar=LazyCigar(cig),
            padded_guide=pg,
            padded_alignment=pa,
            padded_target=pt,
        )
        object.__setattr__(
            ga,
            "_counts",
            {
                "mismatches": mism,
                "gap_bases": gapb,
                "guide_mm": gmm,
                "guide_gaps": ggap,
                "pam_mm": pmm,
                "pam_gaps": pgap,
            },
        )
        object.__setattr__(ga, "_unpadded_target", ut)
        out[widx].append(ga)
    return out


def finish_rendered(
    guide: Guide,
    aligner,
    windows: Sequence[tuple[str, int, np.ndarray]],
    passes_list: Sequence[tuple[str, ...]],
    ranges: Optional[np.ndarray],
    consts: dict,  # prebuilt constant columns, see make_render_consts
    fetch,  # (chrom, start1, end1) -> N-padded uppercase bases
    **limits,
) -> Optional[list[list]]:
    """Finish a batch of windows straight into RenderedHit rows (the
    production reference-pass path): the native buffers are decoded
    directly into the final TSV line plus the dedup keys, skipping the
    per-row GuideAlignment and ReferenceHit objects entirely.

    Field-for-field identical to
    ``render_row(HitBuilder.build(aln), fields)`` — pinned by the
    differential fuzz in tests/test_batch_finish.py.  Variant-pass rows
    never come through here (they need variant columns), so the variant
    columns are always empty."""
    raw = _native_finish_raw(
        guide, aligner, windows, passes_list, ranges, **limits
    )
    if raw is None:
        return None
    (n_out, meta, str_view, cig_view, str_off, plen, ulen, cig_off,
     cig_len, guide_str) = raw
    from calitas_tpu_torch.search.hits import RenderedHit

    c_guide_id = consts["guide_id"]
    c_guide = consts["unpadded_guide"]
    c_build = consts["genome_build"]
    c_guide_len = consts["guide_len"]
    c_tail = consts["tail"]  # aligner..time_stamp, pre-joined
    pam_used_cache: dict[int, str] = {}

    out: list[list] = [[] for _ in range(len(windows))]
    for k in range(n_out):
        (widx, strandc, pam_idx, score, s0, e0, gs, ge,
         mism, gapb, gmm, ggap, pmm, _pgap, _kind, _r) = (
            int(x) for x in meta[k]
        )
        chrom, start1, _b = windows[widx]
        toff = start1 - 1
        cs = toff + gs
        ce = toff + ge
        sf = toff + s0
        ef = toff + e0
        pos = strandc == 0
        strand = "+" if pos else "-"
        so = int(str_off[k])
        pl = int(plen[k])
        pg = str_view[so : so + pl].decode("ascii")
        pa = str_view[so + pl : so + 2 * pl].decode("ascii")
        pt = str_view[so + 2 * pl : so + 3 * pl].decode("ascii")
        ut = str_view[so + 3 * pl : so + 3 * pl + int(ulen[k])].decode("ascii")
        cig = cig_view[
            int(cig_off[k]) : int(cig_off[k]) + int(cig_len[k])
        ].decode("ascii")
        pam_used = pam_used_cache.get(pam_idx)
        if pam_used is None:
            pam_used = "".join(c for c in guide_str(pam_idx) if c.islower())
            pam_used_cache[pam_idx] = pam_used

        # Flanks: one span fetch, slices per flank, rc on minus strand,
        # 5'/3' labels strand-swapped (HitBuilder.build semantics).
        lo1 = min(cs - 9, sf - 7)
        hi1 = max(ce + 10, ef + 8)
        span = fetch(chrom, lo1, hi1)

        def fl(a: int, b: int) -> str:
            sub = span[a - lo1 : b - lo1 + 1]
            return sub if pos else revcomp(sub)

        ten_l = fl(cs - 9, cs)
        ten_r = fl(ce + 1, ce + 10)
        eight_l = fl(sf - 7, sf)
        eight_r = fl(ef + 1, ef + 8)

        line = "\t".join((
            c_guide_id, c_guide, c_build, chrom, str(cs), str(ce), strand,
            ut,
            ten_l if pos else ten_r,
            ten_r if pos else ten_l,
            pam_used,
            "", "", "", "",  # variant_id/description/vcf/allele_frequency
            str(score), str(gmm), str(ggap), str(gmm + ggap), str(pmm),
            str(mism + gapb),
            pg, pa, pt,
            eight_l if pos else eight_r,
            eight_r if pos else eight_l,
            cig, c_guide_len, str(len(ut)), c_tail,
        )) + "\n"
        # ReferenceHit.end quirk preserved: guide-only start + full-cigar
        # length-on-target (= e0 - s0) - 1 (ReferenceHit.scala:135-138).
        out[widx].append(RenderedHit(
            c_guide_id, chrom, strand, None, cs, score, cs + (e0 - s0) - 1,
            line,
        ))
    return out


def finish_lines(
    guide: Guide,
    aligner,
    windows: Sequence[tuple[str, int, np.ndarray]],  # (chrom, start1, bases)
    passes_list: Sequence[tuple[str, ...]],
    ranges: Optional[np.ndarray],
    consts: dict,  # make_render_consts
    flank_srcs: Sequence[tuple[int, np.ndarray]],  # (fstart1, UPPER bases)
    **limits,
) -> Optional[list[list]]:
    """Finish a batch of same-chromosome windows straight into RenderedHit
    rows with the ENTIRE 34-column line composed in native code
    (``finish_batch_render``): flanks, counters, numbers and constant
    columns all render in C++; Python only slices the returned line
    buffer into per-row strings.  Line-for-line identical to
    :func:`finish_rendered` (pinned by tests/test_batch_finish.py).

    ``flank_srcs[i]`` = (genomic 1-based start, uppercase bases) covering
    at least [window_start - 10, window_end + 10] clamped to the contig;
    positions outside the source render as 'N' (the contig-edge padding
    of ReferenceHit.scala:261-266).
    """
    from calitas_tpu_torch import native

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "finish_batch_render"):
        return None
    n = len(windows)
    if n == 0:
        return []
    chrom0 = windows[0][0]
    if any(c != chrom0 for c, _, _ in windows):
        return None  # mixed chromosomes: caller falls back

    qp = _pack_query_pams(guide)
    if qp is None:
        return None  # PAM too long for the native mask: Python engine
    is5, query, pams, qbytes, pam_cat, pam_off, pam_len, n_pams, \
        max_pam_len = qp
    Q = len(qbytes)

    wbytes, woff, wlen = _pack_seqs([b for _, _, b in windows])
    wstart1 = np.array([s for _, s, _ in windows], dtype=np.int64)
    pass_mask = _pass_mask_for(passes_list, is5, n)
    if ranges is None:
        ranges_arr = np.zeros((max(n, 1), 4), dtype=np.int32)
    else:
        ranges_arr = np.ascontiguousarray(ranges, dtype=np.int32)

    fbytes, foff, flen = _pack_seqs([b for _, b in flank_srcs])
    fstart1 = np.array([s for s, _ in flank_srcs], dtype=np.int64)

    s = aligner.scorer
    min_score = aligner.min_guide_score(guide, limits["max_guide_diffs"])
    ext_total = (
        limits["max_guide_diffs"]
        + limits["max_gaps_between_guide_and_pam"]
        + limits["max_pam_diffs"]
    )

    chromb = chrom0.encode("ascii")
    c_id = consts["guide_id"].encode("ascii")
    c_guide = consts["unpadded_guide"].encode("ascii")
    c_build = consts["genome_build"].encode("ascii")
    c_glen = consts["guide_len"].encode("ascii")
    c_tail = consts["tail"].encode("ascii")

    aln_width = Q + max_pam_len + limits["max_gaps_between_guide_and_pam"] + 8
    const_len = (
        len(c_id) + len(c_guide) + len(c_build) + len(chromb) + len(c_glen)
        + len(c_tail)
    )
    line_width = const_len + 6 * aln_width + 120
    max_out = max(256, 4 * n)
    while True:
        meta = np.empty((max_out, 8), dtype=np.int64)
        lines_cap = max_out * line_width
        out_lines = np.empty(lines_cap, dtype=np.uint8)
        line_off = np.empty(max_out, dtype=np.int64)
        line_len = np.empty(max_out, dtype=np.int32)
        n_out = lib.finish_batch_render(
            qbytes.ctypes.data, Q,
            pam_cat.ctypes.data, pam_off.ctypes.data, pam_len.ctypes.data,
            n_pams,
            1 if is5 else 0,
            s.match_score, s.mismatch_score, s.query_gap_score,
            s.target_gap_score, s.pam_match_score, s.pam_mismatch_score,
            int(min_score),
            limits["max_guide_diffs"], limits["max_pam_diffs"],
            limits["max_gaps_between_guide_and_pam"],
            ext_total, limits["max_total_diffs"], limits["max_overlap"],
            wbytes.ctypes.data, woff.ctypes.data, wlen.ctypes.data,
            pass_mask.ctypes.data, ranges_arr.ctypes.data, n,
            fbytes.ctypes.data, foff.ctypes.data, flen.ctypes.data,
            fstart1.ctypes.data, wstart1.ctypes.data,
            chromb, len(chromb),
            c_id, len(c_id),
            c_guide, len(c_guide),
            c_build, len(c_build),
            c_glen, len(c_glen),
            c_tail, len(c_tail),
            max_out,
            meta.ctypes.data,
            out_lines.ctypes.data, ctypes.c_int64(lines_cap),
            line_off.ctypes.data, line_len.ctypes.data,
        )
        if n_out == -1:
            max_out *= 4
            continue
        if n_out < 0:
            raise AssertionError(f"native finish_batch_render error: {n_out}")
        break

    from calitas_tpu_torch.search.hits import RenderedHit

    _used = (
        int(line_off[n_out - 1]) + int(line_len[n_out - 1]) if n_out else 0
    )
    buf = out_lines[:_used].tobytes()
    c_guide_id = consts["guide_id"]
    out: list[list] = [[] for _ in range(n)]
    mv = meta[:n_out].tolist()
    lo = line_off[:n_out].tolist()
    ll = line_len[:n_out].tolist()
    for k in range(n_out):
        widx, strandc, cs, score, rh_end, _, _, _ = mv[k]
        o = lo[k]
        line = buf[o : o + ll[k]].decode("ascii")
        out[widx].append(RenderedHit(
            c_guide_id, chrom0, "+" if strandc == 0 else "-", None,
            cs, score, rh_end, line,
        ))
    return out


def materialize_finish_lines(
    guide: Guide,
    aligner,
    chrom: str,
    ctxs: Optional[Sequence[bytes]],  # raw (original-case) context slices
    cstart1: np.ndarray,  # int64 [n]: 1-based genomic pos of ctx[0]
    wstart0: np.ndarray,  # int64 [n]: 0-based genomic start of raw window
    wraw_len: np.ndarray,  # int32 [n]: raw window length
    passes_list: Sequence[tuple[str, ...]],
    cranges: Optional[np.ndarray],  # int32 [n, 4] screen bounds or None
    consts: dict,
    min_window_len: int,
    block: bool = False,
    raw_ctx: Optional[tuple] = None,  # (fasta buf, byte_off, byte_len, n_bases)
    **limits,
) -> Optional[list[list]]:
    """The fully-native finish: raw mmap context slices in, RenderedHit
    rows out.  N-trim, uppercase, screen-range mapping
    (chain_ranges_to_pass) and the complete line rendering all happen in
    ONE C++ call (``materialize_finish_render``); per-window results are
    line-identical to materialize_window + finish_rendered (pinned by
    tests/test_batch_finish.py).

    With ``raw_ctx`` (from :meth:`IndexedFasta.raw_spans`: the whole
    mmap'd FASTA as one uint8 view + per-window byte offsets/lengths and
    expected base counts) ``ctxs`` is ignored and the contexts are read
    — newline-stripped — directly from the file bytes in native code
    (``materialize_finish_render_raw``): zero per-candidate Python.

    With ``block=True`` the result is a single columnar
    :class:`~calitas_tpu_torch.search.hits.RenderedBlock` for the whole chunk
    (rows in emission order) — zero per-row Python objects; the parent's
    dedup reads the key arrays directly."""
    from calitas_tpu_torch import native

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "materialize_finish_render"):
        return None
    if raw_ctx is not None and not hasattr(
        lib, "materialize_finish_render_raw"
    ):
        return None
    n = len(raw_ctx[1]) if raw_ctx is not None else len(ctxs)
    if n == 0:
        return []

    qp = _pack_query_pams(guide)
    if qp is None:
        return None  # PAM too long for the native mask: Python engine
    is5, query, pams, qbytes, pam_cat, pam_off, pam_len, n_pams, \
        max_pam_len = qp
    Q = len(qbytes)

    if raw_ctx is not None:
        cbytes, coff, craw_len, clen = raw_ctx
        coff = np.ascontiguousarray(coff, dtype=np.int64)
        craw_len = np.ascontiguousarray(craw_len, dtype=np.int32)
        clen = np.ascontiguousarray(clen, dtype=np.int32)
    else:
        craw_len = None
        cbytes, coff, clen = _pack_seqs(list(ctxs))
    if isinstance(passes_list, np.ndarray):
        # Native pass-mask array straight from the screen's chain flags
        # (chain A = cpp pass 0, chain B = cpp pass 1 — same encoding).
        pass_mask = np.ascontiguousarray(passes_list, dtype=np.uint8)
    else:
        pass_mask = _pass_mask_for(passes_list, is5, n)
    if cranges is None:
        cr = np.full((n, 4), -1, dtype=np.int32)
    else:
        cr = np.ascontiguousarray(cranges, dtype=np.int32)

    s = aligner.scorer
    min_score = aligner.min_guide_score(guide, limits["max_guide_diffs"])
    ext_total = (
        limits["max_guide_diffs"]
        + limits["max_gaps_between_guide_and_pam"]
        + limits["max_pam_diffs"]
    )

    chromb = chrom.encode("ascii")
    c_id = consts["guide_id"].encode("ascii")
    c_guide = consts["unpadded_guide"].encode("ascii")
    c_build = consts["genome_build"].encode("ascii")
    c_glen = consts["guide_len"].encode("ascii")
    c_tail = consts["tail"].encode("ascii")
    aln_width = Q + max_pam_len + limits["max_gaps_between_guide_and_pam"] + 8
    const_len = (
        len(c_id) + len(c_guide) + len(c_build) + len(chromb) + len(c_glen)
        + len(c_tail)
    )
    line_width = const_len + 6 * aln_width + 120
    cs1 = np.ascontiguousarray(cstart1, dtype=np.int64)
    ws0 = np.ascontiguousarray(wstart0, dtype=np.int64)
    wrl = np.ascontiguousarray(wraw_len, dtype=np.int32)

    max_out = max(256, 4 * n)
    while True:
        meta = np.empty((max_out, 8), dtype=np.int64)
        lines_cap = max_out * line_width
        out_lines = np.empty(lines_cap, dtype=np.uint8)
        line_off = np.empty(max_out, dtype=np.int64)
        line_len = np.empty(max_out, dtype=np.int32)
        ctx_args = (
            (cbytes.ctypes.data, coff.ctypes.data, craw_len.ctypes.data,
             clen.ctypes.data)
            if raw_ctx is not None
            else (cbytes.ctypes.data, coff.ctypes.data, clen.ctypes.data)
        )
        fn = (
            lib.materialize_finish_render_raw
            if raw_ctx is not None
            else lib.materialize_finish_render
        )
        n_out = fn(
            qbytes.ctypes.data, Q,
            pam_cat.ctypes.data, pam_off.ctypes.data, pam_len.ctypes.data,
            n_pams,
            1 if is5 else 0,
            s.match_score, s.mismatch_score, s.query_gap_score,
            s.target_gap_score, s.pam_match_score, s.pam_mismatch_score,
            int(min_score),
            limits["max_guide_diffs"], limits["max_pam_diffs"],
            limits["max_gaps_between_guide_and_pam"],
            ext_total, limits["max_total_diffs"], limits["max_overlap"],
            *ctx_args,
            cs1.ctypes.data, ws0.ctypes.data, wrl.ctypes.data,
            pass_mask.ctypes.data, cr.ctypes.data, n,
            int(min_window_len),
            chromb, len(chromb),
            c_id, len(c_id),
            c_guide, len(c_guide),
            c_build, len(c_build),
            c_glen, len(c_glen),
            c_tail, len(c_tail),
            max_out,
            meta.ctypes.data,
            out_lines.ctypes.data, ctypes.c_int64(lines_cap),
            line_off.ctypes.data, line_len.ctypes.data,
        )
        if n_out == -1:
            max_out *= 4
            continue
        if n_out == -3 and raw_ctx is not None:
            # Raw-span base count mismatch (unexpected file geometry):
            # let the caller rebuild through the sliced-context path.
            return None
        if n_out < 0:
            raise AssertionError(
                f"native materialize_finish_render error: {n_out}"
            )
        break

    c_guide_id = consts["guide_id"]
    if block:
        from calitas_tpu_torch.search.hits import RenderedBlock

        m = meta[:n_out]
        offs = np.empty(n_out + 1, np.int64)
        offs[:n_out] = line_off[:n_out]
        offs[n_out] = (
            (line_off[n_out - 1] + line_len[n_out - 1]) if n_out else 0
        )
        nbytes = int(offs[n_out])
        return RenderedBlock(
            c_guide_id, chrom,
            np.where(m[:, 1] == 0, np.uint8(43), np.uint8(45)),  # '+'/'-'
            m[:, 2].astype(np.int64), m[:, 3].astype(np.int64),
            m[:, 4].astype(np.int64), offs,
            out_lines[:nbytes].tobytes(),
        )

    from calitas_tpu_torch.search.hits import RenderedHit

    _used = (
        int(line_off[n_out - 1]) + int(line_len[n_out - 1]) if n_out else 0
    )
    buf = out_lines[:_used].tobytes()
    out: list[list] = [[] for _ in range(n)]
    mv = meta[:n_out].tolist()
    lo = line_off[:n_out].tolist()
    ll = line_len[:n_out].tolist()
    for k in range(n_out):
        widx, strandc, cs, score, rh_end, _, _, _ = mv[k]
        o = lo[k]
        line = buf[o : o + ll[k]].decode("ascii")
        out[widx].append(RenderedHit(
            c_guide_id, chrom, "+" if strandc == 0 else "-", None,
            cs, score, rh_end, line,
        ))
    return out


def make_render_consts(builder, guide: Guide) -> dict:
    """The constant output columns of a reference-pass row, prebuilt once
    per worker (mirrors the constant fields of HitBuilder.build)."""
    return {
        "guide_id": builder.guide_id,
        "unpadded_guide": guide.guide,
        "genome_build": builder.genome_build,
        "guide_len": str(len(guide.guide)),
        "tail": "\t".join((
            builder.aligner_id, builder.aligner_version,
            builder.aligner_search_pam, builder.arguments,
            builder.timestamp,
        )),
    }
