"""ReferenceHit: the 34-column standardized hit table, its builder, the
dictionary-order sort and the global overlap dedup.

Parity contract: ReferenceHit.scala (all of it) and
SearchReference.scala:653-675 (SURVEY.md §2.7/§2.8).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

from calitas_tpu_torch.version import aligner_version
from calitas_tpu_torch.core.cigar import Cigar, length_on_target_str
from calitas_tpu_torch.core.guide import Guide
from calitas_tpu_torch.core.sequence import revcomp
from calitas_tpu_torch.align.guide_alignment import GuideAlignment
from calitas_tpu_torch.io.fasta import IndexedFasta, SequenceDictionary

#: version string in the reference's yyyyMMdd-sha format (EditasMetric.scala:13)
ALIGNER_VERSION = aligner_version()


@dataclass(frozen=True)
class ReferenceHit:
    """One row of the standardized output table.  Field order here IS the
    column order (ReferenceHit.scala:99-132; README.md:100-137)."""

    guide_id: str
    unpadded_guide_sequence: str
    genome_build: str
    chromosome: str
    coordinate_start: int  # guide-only, 0-based open, PAM excluded
    coordinate_end: int
    strand: str
    unpadded_target_sequence: str
    ten_bases_5_prime: str
    ten_bases_3_prime: str
    pam_used: Optional[str]
    variant_id: Optional[str]
    variant_description: Optional[str]
    variant_vcf: Optional[str]
    allele_frequency: Optional[float]
    score: int
    guide_mm: int
    guide_gaps: int
    guide_mm_plus_gaps: int
    pam_mm: int
    total_mm_plus_gaps: int
    padded_guide: str
    padded_alignment: str
    padded_target: str
    padded_extra_8_bases_5_prime: str
    padded_extra_8_bases_3_prime: str
    cigar: str
    unpadded_guide_sequence_length: int
    unpadded_target_sequence_length: int
    aligner: str
    aligner_version: str
    aligner_search_pam: str
    aligner_other_parameters: str
    time_stamp: str

    @property
    def end(self) -> int:
        """End computed from start + cigar length-on-target, 1-based-closed
        style (ReferenceHit.scala:135-138; htsjdk CoordMath.getEnd).
        Cached: the global dedup compares ends repeatedly on large tables."""
        try:
            return object.__getattribute__(self, "_end")
        except AttributeError:
            pass
        end = self.coordinate_start + length_on_target_str(self.cigar) - 1
        object.__setattr__(self, "_end", end)
        return end

    def overlap(self, other: "ReferenceHit") -> int:
        """Genomic overlap between the full alignments of two hits
        (ReferenceHit.scala:141-144)."""
        if self.chromosome != other.chromosome:
            return 0
        return max(
            0,
            min(self.end, other.end)
            - max(self.coordinate_start, other.coordinate_start),
        )


class RenderedHit:
    """A pre-rendered output row: the finished TSV line plus the fields
    the global dedup/sort reads, eagerly.  Duck-types ReferenceHit —
    any other field access lazily parses the line back into a full
    ReferenceHit (io/tsv.py::parse_row, the exact render inverse).

    The finish workers ship these instead of full dataclasses: the
    parent's per-row cost is then one small tuple unpickle, and the
    writer concatenates lines."""

    __slots__ = (
        "guide_id", "chromosome", "strand", "variant_description",
        "coordinate_start", "score", "end", "_line", "_full",
    )

    def __init__(
        self, guide_id, chromosome, strand, variant_description,
        coordinate_start, score, end, line,
    ):
        self.guide_id = guide_id
        self.chromosome = chromosome
        self.strand = strand
        self.variant_description = variant_description
        self.coordinate_start = coordinate_start
        self.score = score
        self.end = end
        self._line = line
        self._full = None

    @classmethod
    def of(cls, hit: ReferenceHit, line: str) -> "RenderedHit":
        r = cls(
            hit.guide_id, hit.chromosome, hit.strand,
            hit.variant_description, hit.coordinate_start, hit.score,
            hit.end, line,
        )
        r._full = hit
        return r

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        full = self._full
        if full is None:
            from calitas_tpu_torch.io.tsv import parse_row

            full = parse_row(self._line, ReferenceHit)
            self._full = full
        return getattr(full, name)

    def __reduce__(self):
        return (
            RenderedHit,
            (
                self.guide_id, self.chromosome, self.strand,
                self.variant_description, self.coordinate_start,
                self.score, self.end, self._line,
            ),
        )


class RenderedBlock:
    """A chunk of reference-pass rows in columnar form: ONE object per
    worker chunk (a lines blob + numpy key arrays) instead of one
    RenderedHit per row.  IPC cost and parent-side key extraction become
    per-chunk instead of per-row; the global dedup reads the arrays
    directly and only dedup SURVIVORS materialize as RenderedHit.

    Reference-pass only: ``variant_description`` is None for every row
    (variant-pass rows carry variant columns and flow as objects)."""

    __slots__ = (
        "guide_id", "chromosome", "strands", "starts", "scores", "ends",
        "line_offs", "blob",
    )

    def __init__(self, guide_id, chromosome, strands, starts, scores, ends,
                 line_offs, blob):
        self.guide_id = guide_id
        self.chromosome = chromosome
        self.strands = strands        # uint8, ord('+') / ord('-')
        self.starts = starts          # int64 coordinate_start
        self.scores = scores          # int64 score
        self.ends = ends              # int64 ReferenceHit.end
        self.line_offs = line_offs    # int64 [n+1] offsets into blob
        self.blob = blob              # bytes: concatenated TSV lines

    def __len__(self) -> int:
        return len(self.starts)

    def line(self, i: int) -> str:
        return self.blob[
            self.line_offs[i] : self.line_offs[i + 1]
        ].decode("ascii")

    def row(self, i: int) -> RenderedHit:
        return RenderedHit(
            self.guide_id, self.chromosome,
            "+" if self.strands[i] == 43 else "-", None,
            int(self.starts[i]), int(self.scores[i]), int(self.ends[i]),
            self.line(i),
        )

    def __iter__(self):
        return (self.row(i) for i in range(len(self.starts)))


def iter_rows(hits) -> "Iterator":
    """Iterate row objects over a mixed list of rows and RenderedBlocks."""
    for h in hits:
        if type(h) is RenderedBlock:
            yield from h
        else:
            yield h


def count_rows(hits) -> int:
    return sum(len(h) if type(h) is RenderedBlock else 1 for h in hits)


_EN_DAYS = ("Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun")
_EN_MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun",
              "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")


def now_timestamp() -> str:
    """UTC run-start timestamp, format ``EEE MMM dd HH:mm:ss z yyyy``
    (ReferenceHit.scala:169-173).  English names are hard-coded — Java's
    Date.toString is locale-independent, so an embedding process that
    sets LC_TIME must not change this column (strftime %a/%b would)."""
    t = time.gmtime()
    return (
        f"{_EN_DAYS[t.tm_wday]} {_EN_MONTHS[t.tm_mon - 1]} "
        f"{t.tm_mday:02d} {t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d} "
        f"UTC {t.tm_year}"
    )


def md5_of_file(path: str | Path) -> str:
    digest = hashlib.md5()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(64 * 1024), b""):
            digest.update(chunk)
    return digest.hexdigest()


class HitBuilder:
    """Builds ReferenceHit rows from GuideAlignments
    (ReferenceHit.scala:148-255).  Heavy one-time work (reference open, VCF
    MD5, timestamp) happens in the constructor so the builder can be
    ``copy()``-d cheaply with new guides."""

    def __init__(
        self,
        guide_id: str,
        guide: Guide,
        ref: IndexedFasta,
        vcf: Optional[str | Path],
        aligner_id: str,
        arguments: str,
        *,
        _vcf_id: Optional[str] = None,
        _timestamp: Optional[str] = None,
        _aligner_version: Optional[str] = None,
    ):
        self.guide_id = guide_id
        self.guide = guide
        self.ref = ref
        self.aligner_id = aligner_id
        self.arguments = arguments
        self.timestamp = _timestamp if _timestamp is not None else now_timestamp()
        # Run-scoped: workers render rows with the PARENT's version
        # string (a worker's own import may postdate a mid-run commit).
        self.aligner_version = (
            _aligner_version if _aligner_version is not None else ALIGNER_VERSION
        )
        if _vcf_id is not None:
            self.vcf_id: Optional[str] = _vcf_id
        elif vcf is not None:
            self.vcf_id = f"{Path(vcf).name}:{md5_of_file(vcf)}"
        else:
            self.vcf_id = None
        self.aligner_search_pam = ",".join(guide.pams_5prime + guide.pams_3prime)
        dictionary = ref.dictionary
        self.genome_build = (
            dictionary.assembly if dictionary and dictionary.assembly else "unknown"
        )

    def copy(self, guide_id: str, guide: Guide) -> "HitBuilder":
        b = HitBuilder(
            guide_id=guide_id,
            guide=guide,
            ref=self.ref,
            vcf=None,
            aligner_id=self.aligner_id,
            arguments=self.arguments,
            _vcf_id=self.vcf_id,
            _timestamp=self.timestamp,
            _aligner_version=self.aligner_version,
        )
        return b

    def build(self, aln: GuideAlignment, variants: Sequence = ()) -> ReferenceHit:
        # Variant columns only for variants inside the alignment span
        # (ReferenceHit.scala:211).
        vs = [
            v
            for v in variants
            if aln.start_offset <= v.pos - 1 <= aln.end_offset
        ]

        neg = aln.is_negative_strand
        # One span fetch serves all four flanks (same semantics as four
        # _fetch calls — N-padding past contig ends, uppercase, rc per
        # flank): random-access reads per hit were a measurable share of
        # the batched finish.
        lo1 = min(aln.guide_start_offset - 9, aln.start_offset - 7)
        hi1 = max(aln.guide_end_offset + 10, aln.end_offset + 8)
        span = None  # fetched on first flank that isn't window-sourced

        def flank(s1: int, e1: int) -> str:
            nonlocal span
            if span is None:
                span = self._fetch(aln.chrom, lo1, hi1, False)
            sub = span[s1 - lo1 : e1 - lo1 + 1]
            return revcomp(sub) if neg else sub

        need_ref_flanks = (
            aln.left_of_guide_10bp is None
            or aln.right_of_guide_10bp is None
            or aln.left_of_full_aln_8bp is None
            or aln.right_of_full_aln_8bp is None
        )
        ten_left = ten_right = eight_left = eight_right = ""
        if need_ref_flanks:
            ten_left = flank(aln.guide_start_offset - 9, aln.guide_start_offset)
            ten_right = flank(aln.guide_end_offset + 1, aln.guide_end_offset + 10)
            eight_left = flank(aln.start_offset - 7, aln.start_offset)
            eight_right = flank(aln.end_offset + 1, aln.end_offset + 8)

        pam_used = "".join(c for c in aln.guide if c.islower()) or None
        pos_strand = aln.is_positive_strand

        return ReferenceHit(
            guide_id=self.guide_id,
            unpadded_guide_sequence=self.guide.guide,
            genome_build=self.genome_build if not vs else f"{self.genome_build}+variants",
            chromosome=aln.chrom,
            coordinate_start=aln.guide_start_offset,
            coordinate_end=aln.guide_end_offset,
            strand=aln.strand,
            unpadded_target_sequence=aln.unpadded_target_without_pam,
            ten_bases_5_prime=(
                aln.left_of_guide_10bp
                if aln.left_of_guide_10bp is not None
                else (ten_left if pos_strand else ten_right)
            ),
            ten_bases_3_prime=(
                aln.right_of_guide_10bp
                if aln.right_of_guide_10bp is not None
                else (ten_right if pos_strand else ten_left)
            ),
            pam_used=pam_used,
            # An all-empty id join (single '.'-ID variant) normalizes to
            # None: the rendered column is "" either way (the JAR's
            # Some("") also prints ""), and None keeps parse_row an
            # exact inverse of render_row (CLAUDE.md invariant).
            variant_id=(";".join(v.id for v in vs) or None) if vs else None,
            variant_description=";".join(v.display_string for v in vs) if vs else None,
            variant_vcf=self.vcf_id if vs else None,
            allele_frequency=min((v.af for v in vs), default=None) if vs else None,
            score=aln.score,
            guide_mm=aln.guide_mismatches,
            guide_gaps=aln.guide_gap_bases,
            guide_mm_plus_gaps=aln.guide_mms_plus_gaps,
            pam_mm=aln.pam_mismatches,
            total_mm_plus_gaps=aln.edits,
            padded_guide=aln.padded_guide,
            padded_alignment=aln.padded_alignment,
            padded_target=aln.padded_target,
            padded_extra_8_bases_5_prime=(
                aln.left_of_full_aln_8bp
                if aln.left_of_full_aln_8bp is not None
                else (eight_left if pos_strand else eight_right)
            ),
            padded_extra_8_bases_3_prime=(
                aln.right_of_full_aln_8bp
                if aln.right_of_full_aln_8bp is not None
                else (eight_right if pos_strand else eight_left)
            ),
            cigar=str(aln.cigar),
            unpadded_guide_sequence_length=len(self.guide.guide),
            unpadded_target_sequence_length=len(aln.unpadded_target_without_pam),
            aligner=self.aligner_id,
            aligner_version=self.aligner_version,
            aligner_search_pam=self.aligner_search_pam,
            aligner_other_parameters=self.arguments,
            time_stamp=self.timestamp,
        )

    def _fetch(self, chrom: str, start: int, end: int, rc: bool) -> str:
        """Fetch bases 1-based closed, N-padding past contig ends
        (ReferenceHit.scala:261-266)."""
        length = self.ref.sequence_length(chrom)
        adj_start = max(1, start)
        adj_end = min(length, end)
        if adj_end >= adj_start:
            mid = self.ref.get_subsequence(chrom, adj_start, adj_end).decode("ascii")
        else:
            mid = ""
        bases = "N" * (adj_start - start) + mid + "N" * (end - adj_end)
        return revcomp(bases).upper() if rc else bases.upper()


def sort_hits(
    hits: Sequence[ReferenceHit], dictionary: Optional[SequenceDictionary]
) -> list[ReferenceHit]:
    """Sort by (dict sequence index, coordinate_start, strand, -score);
    lexicographic chromosome fallback (ReferenceHit.scala:276-287).

    Large tables sort via a stable np.lexsort over attribute arrays —
    the same ordering (incl. insertion-stability on full-key ties) as
    the tuple-key sort, ~4x faster at the 1M-row scale multi-guide
    genome runs produce."""
    import numpy as np

    n = len(hits)
    if dictionary is not None:
        idx = dictionary.index
        key = lambda h: (idx(h.chromosome), h.coordinate_start, h.strand, -h.score)
    else:
        idx = None
        key = lambda h: (h.chromosome, h.coordinate_start, h.strand, -h.score)
    if n < 4096:  # numpy setup doesn't amortize on small tables
        return sorted(hits, key=key)
    chroms = [h.chromosome for h in hits]
    if idx is not None:
        uniq = {c: idx(c) for c in set(chroms)}
        chrom_key = np.fromiter((uniq[c] for c in chroms), np.int64, n)
    else:
        chrom_key = np.array(chroms)
    start = np.fromiter((h.coordinate_start for h in hits), np.int64, n)
    # strands are the single bytes "+" (43) < "-" (45): ord-compare IS
    # the string compare
    strand = np.fromiter((ord(h.strand) for h in hits), np.uint8, n)
    neg_score = np.fromiter((-h.score for h in hits), np.int64, n)
    order = np.lexsort((neg_score, strand, start, chrom_key))
    return [hits[i] for i in order]


def remove_overlaps(
    hits: Sequence[ReferenceHit],
    max_overlap: int,
    dictionary: Optional[SequenceDictionary],
) -> list[ReferenceHit]:
    """Canonical best-per-locus global dedup (SearchReference.scala:653-675).

    Hits are grouped by (chromosome, strand, variant_description), each
    group sorted in dictionary order and scanned: while the next hit
    overlaps the current by >= max_overlap (note >= here vs > intra-window)
    with a <= score, it is dropped; the current hit is emitted only if the
    next survivor doesn't overlap it.

    Large tables dispatch to a vectorized path that produces the exact
    same keepers in the exact same order (``_remove_overlaps_vector``);
    ``max_overlap <= 0`` makes every same-group pair "overlap" under the
    clamped-``>=`` rule, which defeats positional segmentation, so the
    vector path only segments when it is positive.
    """
    if len(hits) >= 8192:
        return _remove_overlaps_vector(hits, max_overlap, dictionary)
    return _remove_overlaps_scan(hits, max_overlap, dictionary)


def _remove_overlaps_scan(
    hits: Sequence[ReferenceHit],
    max_overlap: int,
    dictionary: Optional[SequenceDictionary],
) -> list[ReferenceHit]:
    """The direct group-sort-scan dedup (small tables; vector-path oracle)."""
    keepers: list[ReferenceHit] = []
    groups: dict[tuple, list[ReferenceHit]] = {}
    for h in hits:
        # guide_id is part of the key so multi-guide runs never dedup one
        # guide's hits against another's (constant — hence identical to the
        # reference's key — in single-guide runs).
        key = (h.guide_id, h.chromosome, h.strand, h.variant_description or "")
        groups.setdefault(key, []).append(h)

    for hs in groups.values():
        ordered = sort_hits(hs, dictionary)
        n = len(ordered)
        # The scan compares (start, end, score) only; hits in a group
        # share a chromosome, so overlap() reduces to clamped interval
        # intersection on plain ints (method calls dominated the scan
        # at 100k-row scale).
        starts = [h.coordinate_start for h in ordered]
        ends = [h.end for h in ordered]
        scores = [h.score for h in ordered]
        i = 0
        while i < n:
            s0 = starts[i]
            e0 = ends[i]
            sc0 = scores[i]
            k = i
            i += 1
            while i < n:
                ov = (e0 if e0 < ends[i] else ends[i]) - (
                    s0 if s0 > starts[i] else starts[i]
                )
                if ov < 0:
                    ov = 0
                if ov >= max_overlap and scores[i] <= sc0:
                    i += 1
                else:
                    break
            if i >= n:
                keepers.append(ordered[k])
            else:
                ov = (e0 if e0 < ends[i] else ends[i]) - (
                    s0 if s0 > starts[i] else starts[i]
                )
                if ov < 0:
                    ov = 0
                if ov < max_overlap:
                    keepers.append(ordered[k])
    return keepers


def _remove_overlaps_vector(
    hits: Sequence[ReferenceHit],
    max_overlap: int,
    dictionary: Optional[SequenceDictionary],
) -> list[ReferenceHit]:
    """Vectorized global dedup, bit-identical to the scan implementation.

    The dictionary never affects the result: within a group the chromosome
    is constant, so the per-group sort order reduces to (start, -score)
    regardless of it (the parameter is kept for signature parity).
    """
    kept_idx, _, _ = _dedup_kept_indices(hits, max_overlap)
    return [hits[j] for j in kept_idx]


def _dedup_kept_indices(hits, max_overlap: int):
    """Core of the vectorized dedup: returns (kept_idx, start, score) —
    the original indices of the keepers in scan-keeper order, plus the
    full start/score key arrays for reuse by the final sort.

    One stable ``np.lexsort`` replaces the per-group tuple sorts: the
    outermost key is the group id assigned in first-appearance order (the
    dict-insertion order the scan path iterates groups in), and within a
    group — chromosome and strand fixed — the sort_hits order reduces to
    ``(start, -score)``.  The sequential drop-chain scan then only has to
    run inside segments that can actually interact: a chain from k can
    reach i only if ``start[i] + max_overlap <= end[k]``, so positions
    where ``start[i] + max_overlap`` exceeds the group's running max end
    are hard barriers.  On genome-scale tables almost every segment is a
    single hit, which the numpy mask keeps wholesale.
    """
    import numpy as np

    n = len(hits)
    keymap: dict = {}
    add = keymap.setdefault
    gid = np.fromiter(
        (
            add(
                (h.guide_id, h.chromosome, h.strand, h.variant_description or ""),
                len(keymap),
            )
            for h in hits
        ),
        np.int64,
        n,
    )
    start = np.fromiter((h.coordinate_start for h in hits), np.int64, n)
    end = np.fromiter((h.end for h in hits), np.int64, n)
    score = np.fromiter((h.score for h in hits), np.int64, n)
    return _dedup_core(gid, start, end, score, max_overlap)


def _dedup_core(gid, start, end, score, max_overlap: int):
    """The array core of the vectorized dedup (see _dedup_kept_indices):
    group ids must be numbered in first-appearance order of the hit
    traversal — that numbering is what makes the kept order (and with it
    full-key tie resolution in the final sort) identical to the scan."""
    import numpy as np

    n = len(gid)
    # int32 sort keys are ~30% faster; scores always fit, coordinates do
    # unless a contig exceeds 2^31 bases.  gid itself stays int64: the
    # cummax lift below multiplies it past int32 range.
    score = score.astype(np.int32)
    if n and int(start.max()) < 2**31:
        start = start.astype(np.int32)

    order = np.lexsort((-score, start, gid.astype(np.int32)))
    g = gid[order]
    s = start[order]
    e = end[order]
    sc = score[order]

    brk = np.empty(n, bool)
    brk[0] = True
    brk[1:] = g[1:] != g[:-1]
    if max_overlap > 0:
        # Per-group running max of end from one global accumulate: lift
        # each group's ends by gid * K (K > any end) so a later group's
        # values always dominate an earlier group's running max.
        lift = g * (int(e.max()) + 1)
        cummax_e = np.maximum.accumulate(e + lift) - lift
        brk[1:] |= s[1:] + max_overlap > cummax_e[:-1]

    keep = np.zeros(n, bool)
    seg_starts = np.flatnonzero(brk)
    seg_ends = np.append(seg_starts[1:], n)
    singles = seg_ends - seg_starts == 1
    keep[seg_starts[singles]] = True
    for a, b in zip(seg_starts[~singles].tolist(), seg_ends[~singles].tolist()):
        starts = s[a:b].tolist()
        ends = e[a:b].tolist()
        scores = sc[a:b].tolist()
        m = b - a
        i = 0
        while i < m:
            s0 = starts[i]
            e0 = ends[i]
            sc0 = scores[i]
            k = i
            i += 1
            while i < m:
                ov = (e0 if e0 < ends[i] else ends[i]) - (
                    s0 if s0 > starts[i] else starts[i]
                )
                if ov < 0:
                    ov = 0
                if ov >= max_overlap and scores[i] <= sc0:
                    i += 1
                else:
                    break
            if i >= m:
                keep[a + k] = True
            else:
                ov = (e0 if e0 < ends[i] else ends[i]) - (
                    s0 if s0 > starts[i] else starts[i]
                )
                if ov < 0:
                    ov = 0
                if ov < max_overlap:
                    keep[a + k] = True
    return order[keep], start, score


def dedup_and_sort(
    hits: Sequence,
    max_overlap: int,
    dictionary: Optional[SequenceDictionary],
) -> list[ReferenceHit]:
    """``sort_hits(remove_overlaps(...))`` fused over one set of attribute
    arrays — the production ``_finalize`` path; ~2x the two-call sequence
    at the 1M-row scale because keepers are never materialized as an
    intermediate list and the sort keys are extracted once.

    ``hits`` may mix row objects with :class:`RenderedBlock` columnar
    chunks (the reference-pass production transport): block key arrays
    feed the dedup directly and only dedup survivors materialize as
    RenderedHit."""
    has_blocks = any(type(h) is RenderedBlock for h in hits)
    if has_blocks:
        return _dedup_and_sort_mixed(hits, max_overlap, dictionary)
    if len(hits) < 8192:
        return sort_hits(remove_overlaps(hits, max_overlap, dictionary), dictionary)
    import numpy as np

    n = len(hits)
    kept_idx, start, score = _dedup_kept_indices(hits, max_overlap)
    chroms = [h.chromosome for h in hits]
    if dictionary is not None:
        uniq = {c: dictionary.index(c) for c in set(chroms)}
        chrom_key = np.fromiter((uniq[c] for c in chroms), np.int32, n)
    else:
        chrom_key = np.array(chroms)
    strand = np.fromiter((ord(h.strand) for h in hits), np.uint8, n)
    k = kept_idx
    # stable within kept order == sort_hits applied to the keeper list
    final = k[np.lexsort((-score[k], strand[k], start[k], chrom_key[k]))]
    return [hits[j] for j in final]


def _mixed_dedup_arrays(
    hits: Sequence,
    max_overlap: int,
    dictionary: Optional[SequenceDictionary],
):
    """The dedup+sort core over a mixed rows/RenderedBlock list: returns
    ``(final, strand, src, local, blocks, objects)`` where ``final`` is
    the keeper row order (global sort applied) and (src, local) address
    each keeper's source block/object.  Key arrays come straight from
    the blocks (group ids still numbered in first-appearance traversal
    order, so the result is bit-identical to flattening every block into
    RenderedHits first — pinned by tests/test_rendered_hit.py)."""
    import numpy as np

    n = count_rows(hits)
    if n == 0:
        return None
    gid = np.empty(n, np.int64)
    start = np.empty(n, np.int64)
    end = np.empty(n, np.int64)
    score = np.empty(n, np.int64)
    strand = np.empty(n, np.uint8)
    # row j -> its source: src[j] >= 0 indexes blocks, -1 = object row
    src = np.empty(n, np.int32)
    local = np.empty(n, np.int64)
    blocks: list = []
    objects: list = []
    chrom_segs: list = []  # (pos, count, chrom) runs for chrom_key
    keymap: dict = {}
    add = keymap.setdefault
    pos = 0
    for h in hits:
        if type(h) is RenderedBlock:
            m = len(h)
            if m == 0:
                continue
            sl = slice(pos, pos + m)
            strands = h.strands
            # group keys in first-appearance order WITHIN the block (the
            # scan path's dict-insertion order over the flattened rows)
            plus = strands == 43
            idx_p = int(np.argmax(plus)) if plus.any() else -1
            idx_m = int(np.argmax(~plus)) if (~plus).any() else -1
            kp = km = 0
            for strand_ch, idx in sorted(
                (("+", idx_p), ("-", idx_m)), key=lambda t: t[1]
            ):
                if idx < 0:
                    continue
                k = add((h.guide_id, h.chromosome, strand_ch, ""), len(keymap))
                if strand_ch == "+":
                    kp = k
                else:
                    km = k
            gid[sl] = np.where(plus, kp, km)
            start[sl] = h.starts
            end[sl] = h.ends
            score[sl] = h.scores
            strand[sl] = strands
            src[sl] = len(blocks)
            local[sl] = np.arange(m)
            blocks.append(h)
            chrom_segs.append((pos, m, h.chromosome))
            pos += m
        else:
            gid[pos] = add(
                (h.guide_id, h.chromosome, h.strand,
                 h.variant_description or ""),
                len(keymap),
            )
            start[pos] = h.coordinate_start
            end[pos] = h.end
            score[pos] = h.score
            strand[pos] = ord(h.strand)
            src[pos] = -1
            local[pos] = len(objects)
            objects.append(h)
            chrom_segs.append((pos, 1, h.chromosome))
            pos += 1

    kept_idx, start32, score32 = _dedup_core(gid, start, end, score, max_overlap)

    if dictionary is not None:
        uniq = {c: dictionary.index(c) for (_p, _m, c) in chrom_segs}
        chrom_key = np.empty(n, np.int32)
        for p, m, c in chrom_segs:
            chrom_key[p : p + m] = uniq[c]
    else:  # lexicographic chromosome fallback (no dictionary)
        chrom_key = np.concatenate(
            [np.repeat(np.array([c]), m) for (_p, m, c) in chrom_segs]
        )
    k = kept_idx
    final = k[np.lexsort((-score32[k], strand[k], start32[k], chrom_key[k]))]
    return final, strand, src, local, blocks, objects


def _dedup_and_sort_mixed(
    hits: Sequence,
    max_overlap: int,
    dictionary: Optional[SequenceDictionary],
) -> list[ReferenceHit]:
    import numpy as np  # noqa: F401 (kept for symmetry with callers)

    res = _mixed_dedup_arrays(hits, max_overlap, dictionary)
    if res is None:
        return []
    final, _strand, src, local, blocks, objects = res
    out = []
    src_l = src[final].tolist()
    loc_l = local[final].tolist()
    for bid, li in zip(src_l, loc_l):
        out.append(objects[li] if bid < 0 else blocks[bid].row(li))
    return out


def dedup_sort_serialize(
    hits: Sequence,
    max_overlap: int,
    dictionary: Optional[SequenceDictionary],
) -> tuple[bytes, int, int]:
    """Fused dedup + dictionary sort + body rendering: returns
    ``(body, n_keepers, n_fwd)`` with ``body`` byte-identical to writing
    ``dedup_and_sort``'s keepers through MetricWriter (header excluded).

    Block-sourced keepers serialize as raw blob slices — no per-row
    Python objects at all (~3 us/row saved at genome scale); object rows
    render through the same single rendering path the writer uses."""
    from calitas_tpu_torch.io.tsv import fields_of, render_row

    _REFERENCE_HIT_FIELDS = fields_of(ReferenceHit)
    has_blocks = any(type(h) is RenderedBlock for h in hits)
    if not has_blocks:
        keepers = dedup_and_sort(hits, max_overlap, dictionary)
        fields = _REFERENCE_HIT_FIELDS
        pieces = []
        n_fwd = 0
        for h in keepers:
            line = getattr(h, "_line", None)
            if line is None:
                line = render_row(h, fields)
            pieces.append(line.encode("utf-8"))
            n_fwd += h.strand == "+"
        return b"".join(pieces), len(keepers), n_fwd
    res = _mixed_dedup_arrays(hits, max_overlap, dictionary)
    if res is None:
        return b"", 0, 0
    final, strand, src, local, blocks, objects = res
    n_fwd = int((strand[final] == 43).sum())
    fields = _REFERENCE_HIT_FIELDS
    pieces = []
    src_l = src[final].tolist()
    loc_l = local[final].tolist()
    for bid, li in zip(src_l, loc_l):
        if bid < 0:
            h = objects[li]
            line = getattr(h, "_line", None)
            if line is None:
                line = render_row(h, fields)
            pieces.append(line.encode("utf-8"))
        else:
            b = blocks[bid]
            o = b.line_offs
            pieces.append(b.blob[int(o[li]) : int(o[li + 1])])
    return b"".join(pieces), len(final), n_fwd
