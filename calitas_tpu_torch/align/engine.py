"""SequentialAligner: guide+PAM alignment orchestration.

Reimplements the full observable behavior of the reference's
``SequentialGuideAligner`` (SequentialGuideAligner.scala:170-537):

  1. guide-only glocal DP on both strands, arranged so the PAM site is at
     the right-hand end of the query (the DP guarantees completeness per
     alignment *end*, not start — :255-259);
  2. ungapped PAM extension with 0..maxExtraGap gap offsets, best per PAM
     (:433-492);
  3. intra-window overlap dedup ordered by (score desc, fewer gaps), with
     ``edits <= max_total_diffs`` applied as a post-filter (:315-322).

The DP itself is pluggable: the default is the exact NumPy oracle; the
TPU search path screens windows on-device first and only runs this code on
candidate windows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from calitas_tpu_torch.core.cigar import Cigar, CigarElem
from calitas_tpu_torch.core.guide import Guide
from calitas_tpu_torch.core.scoring import Defaults, Scorer, derive_scorer, worst_guide_diff_score
from calitas_tpu_torch.core.sequence import (
    encode_query,
    encode_target,
    revcomp_bytes,
    revcomp_padded,
    revcomp,
    to_bytes,
)
from calitas_tpu_torch.align.alignment import Alignment
from calitas_tpu_torch.align.guide_alignment import GuideAlignment, SORT_KEY
from calitas_tpu_torch.align.oracle import glocal_align_multi

import threading

_TLS = threading.local()

#: a pass bound that says nothing: the pass must run unaided (the pair
#: screen's value for an unscreenable pair, ops/pair_screen.py)
NO_SCREEN = -(2**30)


def a2r_region(
    guide_length: int, pos: int, window_size, seq_len: int
) -> tuple[int, int]:
    """The AlignToReference search region around a locus: 1-based closed
    [start, end] (AlignToReference.scala:95-99).  ONE definition shared
    by the engine, the device pair screen and the worker — the screened
    window and the aligned window must stay byte-identical or the
    all-hits exact-skip silently drops hits."""
    padding = (window_size // 2) if window_size is not None else guide_length * 2
    return max(pos - padding, 1), min(pos + padding, seq_len)


class _Light:
    """Pre-dedup alignment record: the dedup-relevant values computed from
    the cigar, deferring padded-string construction to survivors."""

    __slots__ = ("alignment", "strand", "kind", "start_offset", "end_offset",
                 "score", "gap_bases", "edits")

    def __init__(self, alignment, strand, kind, start_offset, end_offset):
        self.alignment = alignment
        self.strand = strand
        self.kind = kind
        self.start_offset = start_offset
        self.end_offset = end_offset
        self.score = alignment.score
        gaps = 0
        edits = 0
        for e in alignment.cigar:
            if e.op in "ID":
                gaps += e.length
                edits += e.length
            elif e.op == "X":
                edits += e.length
        self.gap_bases = gaps
        self.edits = edits

    def overlap(self, other) -> int:
        o = min(self.end_offset, other.end_offset) - max(
            self.start_offset, other.start_offset
        )
        return o if o > 0 else 0


#: (score desc, fewer gap bases) — GuideAlignment.scala:125-129
_LIGHT_SORT_KEY = lambda r: (-r.score, r.gap_bases)


class SequentialAligner:
    def __init__(
        self,
        ref=None,  # optional indexed FASTA (calitas_tpu_torch.io.fasta.IndexedFasta)
        mismatch_net_cost: int = Defaults.MISMATCH_NET_COST,
        genome_gap_net_cost: int = Defaults.GENOME_GAP_NET_COST,
        guide_gap_net_cost: int = Defaults.GUIDE_GAP_NET_COST,
        pam_mismatch_net_cost: int = Defaults.PAM_MISMATCH_NET_COST,
    ):
        self.ref = ref
        self.scorer: Scorer = derive_scorer(
            mismatch_net_cost=mismatch_net_cost,
            genome_gap_net_cost=genome_gap_net_cost,
            guide_gap_net_cost=guide_gap_net_cost,
            pam_mismatch_net_cost=pam_mismatch_net_cost,
        )
        self.worst_guide_diff_score = worst_guide_diff_score(
            mismatch_net_cost, genome_gap_net_cost, guide_gap_net_cost
        )

    # ------------------------------------------------------------------ DP

    def min_guide_score(self, guide: Guide, max_guide_diffs: int) -> int:
        """Minimum score of any alignment wanted from the guide-only DP
        (SequentialGuideAligner.scala:239-243)."""
        return (
            self.scorer.match_score * guide.protospacer_length
            + self.worst_guide_diff_score * max_guide_diffs
        )

    def _dp(self, query: bytes, target: bytes, min_score: int) -> list[Alignment]:
        return glocal_align_multi(
            query=query,
            target=target,
            qmask=encode_query(query),
            tmask=encode_target(target),
            scorer=self.scorer,
            min_score=min_score,
        )

    # ------------------------------------------------------------- align()

    def align(
        self,
        guide: Guide,
        target,
        target_name: str = "n/a",
        target_offset: int = 0,
        *,
        max_guide_diffs: int,
        max_gaps_between_guide_and_pam: int,
        max_pam_diffs: int,
        max_total_diffs: int,
        max_overlap: int = 0,
        precomputed: Optional[dict] = None,
        passes: tuple = ("fwd", "rev"),
    ) -> list[GuideAlignment]:
        """All acceptable alignments of guide(+PAMs) to target, deduped.

        ``precomputed`` optionally supplies device-computed DP results keyed
        by pass name ('fwd'/'rev') to skip the host DP (same contract as
        ``_dp``).  ``passes`` restricts which strand passes run: a skipped
        pass contributes no alignments, which is output-identical whenever
        the caller knows (e.g. from the device screen) that the pass has no
        above-threshold end columns."""
        target_b = bytes(to_bytes(target))
        L = len(target_b)
        min_score = self.min_guide_score(guide, max_guide_diffs)
        # Use the sum of the three diff limits during extension; apply
        # max_total_diffs only as a post-filter (:245-249).
        max_diffs_filtering = (
            max_guide_diffs + max_gaps_between_guide_and_pam + max_pam_diffs
        )
        rc_target_b = bytes(revcomp_bytes(np.frombuffer(target_b, dtype=np.uint8)))

        def run(query: str, pams: Sequence[str], tgt: bytes, key: str) -> list[Alignment]:
            if key not in passes:
                return []
            qb = query.encode("ascii")
            if precomputed is not None and key in precomputed:
                alns = precomputed[key]
            else:
                native = self._native_search_pass(
                    qb, pams, tgt,
                    min_score=min_score,
                    max_guide_diffs=max_guide_diffs,
                    max_pam_mismatches=max_pam_diffs,
                    max_gap_before_extending=max_gaps_between_guide_and_pam,
                    max_total_diffs=max_diffs_filtering,
                )
                if native is not None:
                    return native
                alns = self._dp(qb, tgt, min_score)
            return self._extend_and_filter_right(
                alns,
                [p.encode("ascii") for p in pams],
                tgt,
                max_guide_diffs=max_guide_diffs,
                max_pam_mismatches=max_pam_diffs,
                max_gap_before_extending=max_gaps_between_guide_and_pam,
                max_total_diffs=max_diffs_filtering,
            )

        # Each pass yields light records carrying only what the intra-window
        # dedup needs (score, gap/edit counts from the cigar, genomic span);
        # the full GuideAlignment (padded strings, flips) is built only for
        # dedup survivors.  Counters from the cigar are identical to
        # padded-string counts ('~' columns are exactly the I/D bases, '.'
        # exactly the X bases).
        if guide.pam_is_5prime:
            # Align revcomp(guide) so the PAM lands on the right (:260-293).
            fs = run(guide.guide_rc, guide.pams_rc, rc_target_b, "fwd")
            rs = run(guide.guide_rc, guide.pams_rc, target_b, "rev")
            fwd = [
                _Light(a, "+", "5fwd",
                       target_offset + L - (a.target_start - 1 + a.cigar.length_on_target),
                       target_offset + L - (a.target_start - 1))
                for a in fs
            ]
            rev = [
                _Light(a, "-", "5rev",
                       target_offset + a.target_start - 1,
                       target_offset + a.target_end)
                for a in rs
            ]
        else:
            # 3'-PAM or PAM-less (:294-313).
            fs = run(guide.guide_fw, guide.pams_fw, target_b, "fwd")
            rs = run(guide.guide_fw, guide.pams_fw, rc_target_b, "rev")
            fwd = [
                _Light(a, "+", "3fwd",
                       target_offset + a.target_start - 1,
                       target_offset + a.target_end)
                for a in fs
            ]
            rev = [
                _Light(a, "-", "3rev",
                       target_offset + L - a.target_end,
                       target_offset + L - (a.target_start - 1))
                for a in rs
            ]

        # Intra-window dedup (:315-322): fwd then rev, each sorted
        # (score desc, fewer gaps; stable), keep if within max_total_diffs
        # and no kept same-strand alignment overlaps by more than max_overlap.
        kept: list[_Light] = []
        for alns in (fwd, rev):
            for rec in sorted(alns, key=_LIGHT_SORT_KEY):
                if rec.edits <= max_total_diffs and not any(
                    k.strand == rec.strand and k.overlap(rec) > max_overlap
                    for k in kept
                ):
                    kept.append(rec)

        # Materialize survivors with the full padded-string construction.
        retval: list[GuideAlignment] = []
        for rec in kept:
            a = rec.alignment
            if rec.kind == "5fwd":
                ga = _to_guide_alignment(a, target_name, 0, "+")
                ga = ga.copy(
                    guide=revcomp(ga.guide),
                    cigar=ga.cigar.reverse(),
                    padded_guide=revcomp_padded(ga.padded_guide),
                    padded_alignment=ga.padded_alignment[::-1],
                    padded_target=revcomp_padded(ga.padded_target),
                    start_offset=target_offset + L - ga.end_offset,
                    end_offset=target_offset + L - ga.start_offset,
                    guide_start_offset=target_offset + L - ga.guide_end_offset,
                    guide_end_offset=target_offset + L - ga.guide_start_offset,
                )
            elif rec.kind == "5rev":
                ga = _to_guide_alignment(a, target_name, target_offset, "+")
                ga = ga.copy(
                    guide=revcomp(ga.guide),
                    cigar=ga.cigar.reverse(),
                    strand="-",
                    padded_guide=revcomp_padded(ga.padded_guide),
                    padded_alignment=ga.padded_alignment[::-1],
                    padded_target=revcomp_padded(ga.padded_target),
                )
            elif rec.kind == "3fwd":
                ga = _to_guide_alignment(a, target_name, target_offset, "+")
            else:  # 3rev
                ga = _to_guide_alignment(a, target_name, 0, "+")
                ga = ga.copy(
                    strand="-",
                    start_offset=target_offset + L - ga.end_offset,
                    guide_start_offset=target_offset + L - ga.guide_end_offset,
                    end_offset=target_offset + L - ga.start_offset,
                    guide_end_offset=target_offset + L - ga.guide_start_offset,
                )
            assert ga.start_offset == rec.start_offset
            assert ga.end_offset == rec.end_offset
            retval.append(ga)
        return retval

    # -------------------------------------------------------- convenience

    def max_pam_bonus(self, guide: Guide) -> int:
        """Upper bound on what PAM extension can add to a DP score: every
        extended base scores at most pam_match and gaps only subtract."""
        pams = guide.pams_rc if guide.pam_is_5prime else guide.pams_fw
        if not pams:
            return 0
        return max(len(p) for p in pams) * max(self.scorer.pam_match_score, 0)

    def align_best(
        self,
        guide: Guide,
        target,
        max_gaps_between_guide_and_pam: int = Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM,
        pass_dp_bounds: Optional[dict] = None,
    ) -> GuideAlignment:
        """Best glocal alignment with all limits maxed out
        (SequentialGuideAligner.scala:333-345).

        ``pass_dp_bounds`` optionally supplies device-computed guide-DP
        maxima per pass ({'fwd': int, 'rev': int}); the rev pass is then
        skipped when it provably cannot beat the fwd result (fwd wins
        ties, so <= suffices): rev's final score is at most its DP
        maximum plus :meth:`max_pam_bonus`.  Output-identical."""
        kwargs = dict(
            max_guide_diffs=guide.protospacer_length,
            max_gaps_between_guide_and_pam=max_gaps_between_guide_and_pam,
            max_pam_diffs=guide.pam_length,
            max_total_diffs=guide.protospacer_length
            + max_gaps_between_guide_and_pam
            + guide.pam_length,
        )
        if pass_dp_bounds is None:
            alns = self.align(guide, target, **kwargs)
            return max(alns, key=lambda a: a.score)  # first max wins ties
        fwd = self.align(guide, target, passes=("fwd",), **kwargs)
        rev_bound = pass_dp_bounds.get("rev", NO_SCREEN)
        if fwd and rev_bound != NO_SCREEN:
            best_fwd = max(a.score for a in fwd)
            if rev_bound + self.max_pam_bonus(guide) <= best_fwd:
                return max(fwd, key=lambda a: a.score)
        rev = self.align(guide, target, passes=("rev",), **kwargs)
        # fwd alignments precede rev ones exactly as in a combined pass
        # (intra-window dedup never crosses strands), so first-max-wins
        # tie-breaking is preserved.
        return max(fwd + rev, key=lambda a: a.score)

    def align_to_ref(
        self,
        guide: Guide,
        chrom: str,
        pos: int,
        window_size: Optional[int] = None,
        *,
        max_guide_diffs: int,
        max_gaps_between_guide_and_pam: int,
        max_pam_diffs: int,
        max_total_diffs: int,
        max_overlap: int = 0,
        passes: tuple = ("fwd", "rev"),
    ) -> list[GuideAlignment]:
        """Align around chrom:pos in a +/- padding window
        (SequentialGuideAligner.scala:359-387).  ``passes`` restricts the
        strand passes exactly as :meth:`align` (output-identical whenever
        the skipped pass has no above-threshold end columns)."""
        if self.ref is None:
            raise ValueError("Cannot perform alignments to ref without a ref fasta!")
        seq_len = self.ref.sequence_length(chrom)
        if seq_len is None:
            raise ValueError(f"Unknown chromosome: {chrom}")
        region_start, region_end = a2r_region(
            guide.length, pos, window_size, seq_len
        )
        target = self.ref.get_subsequence(chrom, region_start, region_end)
        return sorted(
            self.align(
                guide,
                target,
                target_name=chrom,
                target_offset=region_start - 1,
                max_guide_diffs=max_guide_diffs,
                max_gaps_between_guide_and_pam=max_gaps_between_guide_and_pam,
                max_pam_diffs=max_pam_diffs,
                max_total_diffs=max_total_diffs,
                max_overlap=max_overlap,
                passes=passes,
            ),
            key=SORT_KEY,
        )

    def align_to_ref_best(
        self,
        guide: Guide,
        chrom: str,
        pos: int,
        window_size: Optional[int] = None,
        max_gaps_between_guide_and_pam: int = Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM,
        pass_dp_bounds: Optional[dict] = None,
    ) -> GuideAlignment:
        kwargs = dict(
            max_guide_diffs=guide.protospacer_length,
            max_gaps_between_guide_and_pam=max_gaps_between_guide_and_pam,
            max_pam_diffs=guide.pam_length,
            max_total_diffs=guide.protospacer_length
            + max_gaps_between_guide_and_pam
            + guide.pam_length,
            max_overlap=0,
        )
        if pass_dp_bounds is not None:
            # Device bound: when the rev pass provably cannot reach the
            # fwd best (strict < — the post-sort tie-break is not
            # fwd-first here), return the fwd-only result; otherwise
            # fall through to the ordinary both-pass call.
            rev_bound = pass_dp_bounds.get("rev", NO_SCREEN)
            if rev_bound != NO_SCREEN:
                fwd = self.align_to_ref(
                    guide, chrom, pos, window_size, passes=("fwd",), **kwargs
                )
                if fwd and rev_bound + self.max_pam_bonus(guide) < max(
                    a.score for a in fwd
                ):
                    return fwd[0]
                # Bound not exclusive: add ONLY the rev pass and merge.
                # Stable-sorting fwd+rev reproduces the combined-pass
                # order exactly (intra-window dedup never crosses
                # strands; fwd alignments precede rev on ties), so the
                # fwd DP is never recomputed.
                rev = self.align_to_ref(
                    guide, chrom, pos, window_size, passes=("rev",), **kwargs
                )
                merged = sorted(fwd + rev, key=SORT_KEY)
                if merged:
                    return merged[0]
        return self.align_to_ref(guide, chrom, pos, window_size, **kwargs)[0]

    # ------------------------------------------------------- PAM extension

    def _extend_and_filter_right(
        self,
        alns: list[Alignment],
        pams: list[bytes],
        target: bytes,
        *,
        max_guide_diffs: int,
        max_pam_mismatches: int,
        max_gap_before_extending: int,
        max_total_diffs: int,
    ) -> list[Alignment]:
        """Extend alignments to the right with the PAM; at most one output
        per (alignment, PAM), preferring fewer gaps between guide and PAM
        (SequentialGuideAligner.scala:433-492)."""
        with_diffs = [(a, a.cigar.diff_bases()) for a in alns]

        if not pams or (len(pams) == 1 and len(pams[0]) == 0):
            return [a for a, d in with_diffs if d <= max_guide_diffs]

        out: list[Alignment] = []
        for aln, guide_diffs in with_diffs:
            if guide_diffs > max_guide_diffs:
                continue
            terminal_gap = aln.cigar.last.length if aln.cigar.last.is_indel else 0
            max_extra_gap = min(
                max_gap_before_extending - terminal_gap, max_total_diffs - guide_diffs
            )
            for pam in pams:
                pam_len = len(pam)
                # Find the best-scoring extension offset first (earliest
                # offset wins ties, as in maxBy); build the cigar only once.
                best_offset = -1
                best_score = None
                best_ops: str = ""
                for offset in range(0, max_extra_gap + 1):
                    # target_end is 1-based so it is the 0-based offset of
                    # the base after the alignment.
                    t_off = aln.target_end + offset
                    pam_mm_limit = min(
                        max_pam_mismatches, max_total_diffs - guide_diffs - offset
                    )
                    if t_off + pam_len > len(target) or pam_mm_limit < 0:
                        continue
                    score = 0
                    n_mm = 0
                    ops: list[str] = []
                    for i in range(pam_len):
                        addend = self.scorer.score_pairing(
                            chr(pam[i]), chr(target[t_off + i])
                        )
                        score += addend
                        if addend > 0:
                            ops.append("=")
                        else:
                            ops.append("X")
                            n_mm += 1
                    if n_mm > pam_mm_limit:
                        continue
                    total = score + offset * self.scorer.query_gap_score
                    if best_score is None or total > best_score:
                        best_score = total
                        best_offset = offset
                        best_ops = "".join(ops)
                if best_score is not None:
                    from itertools import groupby

                    elems = list(aln.cigar.elems)
                    if best_offset > 0:
                        elems.append(CigarElem("D", best_offset))
                    elems.extend(
                        CigarElem(op, sum(1 for _ in grp))
                        for op, grp in groupby(best_ops)
                    )
                    out.append(
                        aln.copy(
                            query=aln.query + pam,
                            query_start=1,
                            cigar=Cigar(elems).coalesce(),
                            score=aln.score + best_score,
                        )
                    )
        return out


def _to_guide_alignment(
    alignment: Alignment,
    target_name: str = "n/a",
    target_offset: int = 0,
    target_strand: str = ".",
) -> GuideAlignment:
    """Alignment (1-based closed) -> GuideAlignment (0-based open)
    (SequentialGuideAligner.scala:505-524)."""
    padded_guide, align_string, padded_target = alignment.padded_strings()
    return GuideAlignment.create(
        guide=alignment.query.decode("ascii"),
        chrom=target_name,
        start_offset=target_offset + alignment.target_start - 1,
        end_offset=target_offset + alignment.target_end,
        strand=target_strand,
        score=alignment.score,
        cigar=alignment.cigar,
        padded_guide=padded_guide,
        padded_alignment=align_string,
        padded_target=padded_target,
    )


def _native_search_pass_impl(
    aligner: "SequentialAligner",
    query: bytes,
    pams: "Sequence[str]",
    target: bytes,
    *,
    min_score: int,
    max_guide_diffs: int,
    max_pam_mismatches: int,
    max_gap_before_extending: int,
    max_total_diffs: int,
) -> "Optional[list[Alignment]]":
    """C++ full-pass fast path: DP + PAM extension in native code; returns
    extended Alignments identical to the Python path, or None when the
    native library is unavailable."""
    import ctypes
    from itertools import groupby

    from calitas_tpu_torch import native

    lib = native.get_lib()
    if lib is None:
        return None
    s = aligner.scorer
    # The query/PAM arrays are guide-constant across the thousands of
    # candidate windows of a search: cache them (and their raw pointers —
    # ndpointer marshalling per call was ~half the host-finish cost).
    qcache = getattr(_TLS, "pass_query_cache", None)
    if qcache is None:
        qcache = _TLS.pass_query_cache = {}
    qkey = (query, tuple(pams))
    ent = qcache.get(qkey)
    if ent is None:
        qmask = np.ascontiguousarray(encode_query(query))
        pam_bytes = [p.encode("ascii") for p in pams]
        pam_masks = np.ascontiguousarray(
            np.concatenate([encode_query(p) for p in pam_bytes])
            if pam_bytes
            else np.zeros(0, np.uint8)
        )
        pam_off = np.zeros(max(len(pam_bytes), 1), np.int32)
        pam_len = np.zeros(max(len(pam_bytes), 1), np.int32)
        off = 0
        for k, p in enumerate(pam_bytes):
            pam_off[k] = off
            pam_len[k] = len(p)
            off += len(p)
        # Arrays are kept in the entry so the cached pointers stay valid.
        ent = qcache[qkey] = (
            qmask, pam_bytes, pam_masks, pam_off, pam_len,
            qmask.ctypes.data, pam_masks.ctypes.data,
            pam_off.ctypes.data, pam_len.ctypes.data,
        )
    (qmask, pam_bytes, pam_masks, pam_off, pam_len,
     qmask_ptr, pam_masks_ptr, pam_off_ptr, pam_len_ptr) = ent
    tmask = encode_target(target)
    Q, T = len(qmask), len(tmask)
    if Q == 0 or T == 0:
        return []

    max_out = 128
    while True:
        # Reusable per-thread output buffers (allocation + ctypes setup was
        # a measurable fraction of the per-candidate cost).
        key = (max_out, Q + 64)
        bufs = getattr(_TLS, "bufs", None)
        if bufs is None:
            bufs = _TLS.bufs = {}
        if key not in bufs:
            ops_cap = max_out * (Q + 64)
            arrs = tuple(np.empty(max_out, np.int32) for _ in range(8))
            ops_buf = ctypes.create_string_buffer(ops_cap)
            bufs[key] = (
                arrs,
                tuple(a.ctypes.data for a in arrs),
                ops_buf,
                ctypes.addressof(ops_buf),
                ops_cap,
            )
        arrs, arr_ptrs, ops_buf, ops_ptr, ops_cap = bufs[key]
        (tstart, tend, score, pam_idx, gaps, edits, ops_off, ops_len) = arrs
        n = lib.search_pass(
            qmask_ptr, Q,
            tmask.ctypes.data, T,
            pam_masks_ptr, pam_off_ptr, pam_len_ptr, len(pam_bytes),
            s.match_score, s.mismatch_score, s.query_gap_score, s.target_gap_score,
            s.pam_match_score, s.pam_mismatch_score,
            int(min_score),
            max_guide_diffs, max_pam_mismatches,
            max_gap_before_extending, max_total_diffs,
            max_out,
            arr_ptrs[0], arr_ptrs[1], arr_ptrs[2], arr_ptrs[3],
            arr_ptrs[4], arr_ptrs[5],
            ops_ptr, ops_cap, arr_ptrs[6], arr_ptrs[7],
        )
        if n == -1:
            max_out *= 4
            continue
        if n < 0:
            raise AssertionError(f"native search_pass error: {n}")
        break

    raw = ops_buf.raw
    out: list[Alignment] = []
    for k in range(n):
        op_str = raw[ops_off[k] : ops_off[k] + ops_len[k]].decode("ascii")
        cigar = Cigar(
            tuple(
                CigarElem(op, sum(1 for _ in grp)) for op, grp in groupby(op_str)
            )
        )
        pidx = int(pam_idx[k])
        q = query if pidx < 0 else query + pam_bytes[pidx]
        out.append(
            Alignment(
                query=q,
                target=target,
                query_start=1,
                target_start=int(tstart[k]),
                cigar=cigar,
                score=int(score[k]),
            )
        )
    return out


SequentialAligner._native_search_pass = _native_search_pass_impl
