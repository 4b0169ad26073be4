"""GuideAlignment: per-alignment value object with the counters that feed
the output columns.

Parity contract: GuideAlignment.scala (all of it; SURVEY.md §2.4).
Coordinates are 0-based open-ended.  The alignment is always kept in guide
orientation: for '-' strand hits the target strings are reverse
complemented, the guide as-is.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import cmp_to_key
from typing import Optional

from calitas_tpu_torch.core.cigar import Cigar
from calitas_tpu_torch.align.alignment import GAP_CHAR


@dataclass(frozen=True)
class GuideAlignment:
    guide: str  # guide sequence incl. PAM if given (case significant)
    chrom: str
    start_offset: int  # 0-based first aligned base of guide+PAM
    end_offset: int  # 0-based offset after the last aligned base of guide+PAM
    guide_start_offset: int  # like start_offset but PAM excluded
    guide_end_offset: int
    strand: str  # '+', '-' or '.'
    score: int
    cigar: Cigar
    padded_guide: str
    padded_alignment: str
    padded_target: str
    left_of_guide_10bp: Optional[str] = None
    right_of_guide_10bp: Optional[str] = None
    left_of_full_aln_8bp: Optional[str] = None
    right_of_full_aln_8bp: Optional[str] = None

    def __post_init__(self) -> None:
        if len(self.padded_guide) != len(self.padded_alignment):
            raise ValueError("Padded guide and alignment string are different lengths.")
        if len(self.padded_target) != len(self.padded_alignment):
            raise ValueError("Padded target and alignment string are different lengths.")
        if self.strand not in "+-.":
            raise ValueError("Strand must be one of [+-.].")

    @staticmethod
    def create(
        guide: str,
        chrom: str,
        start_offset: int,
        end_offset: int,
        strand: str,
        score: int,
        cigar: Cigar,
        padded_guide: str,
        padded_alignment: str,
        padded_target: str,
    ) -> "GuideAlignment":
        """Factory that derives the guide-only (PAM-excluded) coordinates
        from the padded strings (GuideAlignment.scala:21-31)."""
        ups = [i for i, c in enumerate(padded_guide) if c.isupper()]
        padded_start = ups[0]
        padded_end = ups[-1]
        left_delta = sum(1 for c in padded_target[:padded_start] if c.isalpha())
        right_delta = sum(1 for c in padded_target[padded_end + 1 :] if c.isalpha())
        if strand == "+":
            gs, ge = start_offset + left_delta, end_offset - right_delta
        elif strand == "-":
            gs, ge = start_offset + right_delta, end_offset - left_delta
        else:
            raise ValueError(f"Cannot derive guide coordinates for strand {strand!r}")
        assert gs >= start_offset and ge <= end_offset
        return GuideAlignment(
            guide=guide,
            chrom=chrom,
            start_offset=start_offset,
            end_offset=end_offset,
            guide_start_offset=gs,
            guide_end_offset=ge,
            strand=strand,
            score=score,
            cigar=cigar,
            padded_guide=padded_guide,
            padded_alignment=padded_alignment,
            padded_target=padded_target,
        )

    def copy(self, **kw) -> "GuideAlignment":
        return replace(self, **kw)

    # -- predicates ---------------------------------------------------------

    @property
    def is_positive_strand(self) -> bool:
        return self.strand in "+."

    @property
    def is_negative_strand(self) -> bool:
        return not self.is_positive_strand

    # -- global counters (computed once, cached on the frozen instance) -----

    def _cached_counts(self) -> dict:
        try:
            return object.__getattribute__(self, "_counts")
        except AttributeError:
            pass
        counts = {
            "mismatches": self.padded_alignment.count("."),
            "gap_bases": self.padded_alignment.count(GAP_CHAR),
            "guide_mm": self._count(lower=False, both_sides=False, mms=True, gaps=False),
            "guide_gaps": self._count(lower=False, both_sides=False, mms=False, gaps=True),
            "pam_mm": self._count(lower=True, both_sides=True, mms=True, gaps=False),
            "pam_gaps": self._count(lower=True, both_sides=True, mms=False, gaps=True),
        }
        object.__setattr__(self, "_counts", counts)
        return counts

    @property
    def mismatches(self) -> int:
        return self._cached_counts()["mismatches"]

    @property
    def gap_bases(self) -> int:
        return self._cached_counts()["gap_bases"]

    @property
    def edits(self) -> int:
        return self.mismatches + self.gap_bases

    # -- guide / PAM attribution (GuideAlignment.scala:139-163) -------------

    @property
    def guide_mismatches(self) -> int:
        return self._cached_counts()["guide_mm"]

    @property
    def guide_gap_bases(self) -> int:
        return self._cached_counts()["guide_gaps"]

    @property
    def guide_mms_plus_gaps(self) -> int:
        # mm+gaps == mm count + gap count for the same region (the two
        # column conditions are disjoint), matching the reference's
        # combined count() call
        return self.guide_mismatches + self.guide_gap_bases

    @property
    def pam_mismatches(self) -> int:
        return self._cached_counts()["pam_mm"]

    @property
    def pam_gap_bases(self) -> int:
        return self._cached_counts()["pam_gaps"]

    @property
    def pam_mms_plus_gaps(self) -> int:
        return self.pam_mismatches + self.pam_gap_bases

    def _count(self, lower: bool, both_sides: bool, mms: bool, gaps: bool) -> int:
        """Count gaps/mismatches in regions of lower- or upper-case guide.

        A gap column whose guide char is ``-`` attributes by the case of
        neighboring non-dash guide chars: PAM gaps require lowercase (or
        ``-``) on *both* sides, guide gaps need one side.  Consequence: a
        gap between guide and PAM counts as a guide gap
        (GuideAlignment.scala:139-163; test GuideAlignmentTest.scala:106-123).
        """
        n = 0
        pg = self.padded_guide
        pa = self.padded_alignment
        for i, ac in enumerate(pa):
            gc = pg[i]
            if mms and ac == "." and gc.islower() == lower:
                n += 1
            elif gaps and ac == GAP_CHAR:
                if gc != "-" and gc.islower() == lower:
                    n += 1
                else:
                    prev = _previous_non_dash(i, pg)
                    nxt = _next_non_dash(i, pg)
                    if both_sides:
                        ok = (prev == "-" or prev.islower() == lower) and (
                            nxt == "-" or nxt.islower() == lower
                        )
                    else:
                        ok = (prev.isalpha() and prev.islower() == lower) or (
                            nxt.isalpha() and nxt.islower() == lower
                        )
                    if ok:
                        n += 1
        return n

    # -- derived strings ----------------------------------------------------

    @property
    def unpadded_target_without_pam(self) -> str:
        """Target letters under the uppercase span of the padded guide
        (GuideAlignment.scala:111-115)."""
        try:  # precomputed by the native batch finisher
            return object.__getattribute__(self, "_unpadded_target")
        except AttributeError:
            pass
        ups = [i for i, c in enumerate(self.padded_guide) if c.isupper()]
        span = self.padded_target[ups[0] : ups[-1] + 1]
        return "".join(c for c in span if c.isalpha())

    # -- ordering / overlap -------------------------------------------------

    def overlap(self, other: "GuideAlignment") -> int:
        if self.chrom != other.chrom:
            return 0
        o = min(self.end_offset, other.end_offset) - max(
            self.start_offset, other.start_offset
        )
        return o if o > 0 else 0

    def compare(self, other: "GuideAlignment") -> int:
        """Highest score first; fewer gap bases on ties
        (GuideAlignment.scala:125-129)."""
        r = other.score - self.score
        if r == 0:
            r = self.gap_bases - other.gap_bases
        return r


SORT_KEY = cmp_to_key(GuideAlignment.compare)


def _previous_non_dash(i: int, s: str) -> str:
    """First non-dash char at or before index i; if none, returns s[0]
    (which may be a dash) — quirk preserved (GuideAlignment.scala:168-172)."""
    while i > 0 and s[i] == "-":
        i -= 1
    return s[i]


def _next_non_dash(i: int, s: str) -> str:
    while i < len(s) - 1 and s[i] == "-":
        i += 1
    return s[i]
