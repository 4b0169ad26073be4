"""CIGAR representation used by the alignment engine.

Covers the subset of the fgbio ``Cigar`` / htsjdk ``CigarOperator`` contract
that the reference relies on (SURVEY.md §2.9.2): operators ``= X M I D``,
``coalesce``, ``reverse``, ``length_on_query`` / ``length_on_target``, and
round-tripping through the standard string form.

Conventions (match the reference throughout):
  - ``I`` consumes query only (an inserted query base; gap in the target).
  - ``D`` consumes target only (a deleted/skipped target base; gap in the
    query) — e.g. the gap between guide and PAM is emitted as ``D``
    (SequentialGuideAligner.scala:474).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

# operators that consume query / target bases
_CONSUMES_QUERY = frozenset("=XMI")
_CONSUMES_TARGET = frozenset("=XMD")
# Only the ops the framework emits/consumes (reference: fgbio Cigar over
# '= X M I D').  SAM's S/H/N/P never appear in guide alignments; N in
# particular consumes reference bases, which the length accounting here
# does not model — rejecting keeps externally-edited tables from
# silently corrupting end coordinates.
_VALID_OPS = frozenset("=XMID")
_INDELS = frozenset("ID")


@dataclass(frozen=True)
class CigarElem:
    op: str
    length: int

    def __post_init__(self) -> None:
        if self.op not in _VALID_OPS:
            raise ValueError(f"Invalid cigar operator: {self.op!r}")
        if self.length <= 0:
            raise ValueError(f"Invalid cigar element length: {self.length}")

    @property
    def length_on_query(self) -> int:
        return self.length if self.op in _CONSUMES_QUERY else 0

    @property
    def length_on_target(self) -> int:
        return self.length if self.op in _CONSUMES_TARGET else 0

    @property
    def is_indel(self) -> bool:
        return self.op in _INDELS

    def __str__(self) -> str:
        return f"{self.length}{self.op}"


class Cigar:
    """An immutable sequence of CigarElems."""

    __slots__ = ("elems",)

    def __init__(self, elems: Iterable[CigarElem] | str = ()):
        if isinstance(elems, str):
            self.elems: tuple[CigarElem, ...] = tuple(_parse(elems))
        else:
            self.elems = tuple(elems)

    def __iter__(self) -> Iterator[CigarElem]:
        return iter(self.elems)

    def __len__(self) -> int:
        return len(self.elems)

    def __bool__(self) -> bool:
        return bool(self.elems)

    def __getitem__(self, i):
        return self.elems[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Cigar) and self.elems == other.elems

    def __hash__(self) -> int:
        return hash(self.elems)

    def __str__(self) -> str:
        return "".join(str(e) for e in self.elems)

    def __repr__(self) -> str:
        return f"Cigar({str(self)!r})"

    @property
    def last(self) -> CigarElem:
        return self.elems[-1]

    @property
    def length_on_query(self) -> int:
        return sum(e.length_on_query for e in self.elems)

    @property
    def length_on_target(self) -> int:
        return sum(e.length_on_target for e in self.elems)

    def coalesce(self) -> "Cigar":
        """Merge adjacent elements with the same operator."""
        out: list[CigarElem] = []
        for e in self.elems:
            if out and out[-1].op == e.op:
                out[-1] = CigarElem(e.op, out[-1].length + e.length)
            else:
                out.append(e)
        return Cigar(out)

    def reverse(self) -> "Cigar":
        return Cigar(tuple(reversed(self.elems)))

    def diff_bases(self) -> int:
        """Total length of non-``=`` elements — the reference's per-alignment
        "diffs" count (SequentialGuideAligner.scala:441-443)."""
        return sum(e.length for e in self.elems if e.op != "=")


class LazyCigar(Cigar):
    """A Cigar that defers parsing its string form until elements are
    actually needed.  The batched native finish emits cigar strings and
    most downstream consumers only re-render (`str`) or measure them —
    parsing every row's cigar into element objects was a measurable
    share of the per-hit cost."""

    __slots__ = ("_raw",)

    def __init__(self, raw: str):
        self._raw = raw

    @property
    def elems(self) -> tuple[CigarElem, ...]:  # type: ignore[override]
        slot = Cigar.__dict__["elems"]
        try:
            return slot.__get__(self)
        except AttributeError:
            e = tuple(_parse(self._raw))
            slot.__set__(self, e)
            return e

    def __str__(self) -> str:
        return self._raw

    def __reduce__(self):
        # The default protocol would restore the parsed elements through
        # the read-only ``elems`` property and fail; the raw string is the
        # whole state.  Finish workers return alignments holding these.
        return (LazyCigar, (self._raw,))


def length_on_target_str(s: str) -> int:
    """``Cigar(s).length_on_target`` without materializing elements.

    The global overlap dedup recomputes alignment ends across the whole
    hit table (ReferenceHit.scala:135-138); parsing element objects there
    dominated dedup time on 100k+-row tables."""
    total = 0
    n = 0
    for ch in s:
        if "0" <= ch <= "9":
            n = n * 10 + (ord(ch) - 48)
        else:
            if n == 0:
                raise ValueError(f"Malformed cigar string: {s!r}")
            if ch in _CONSUMES_TARGET:
                total += n
            elif ch not in _VALID_OPS:
                raise ValueError(f"Invalid cigar operator: {ch!r}")
            n = 0
    if n != 0:
        raise ValueError(f"Malformed cigar string: {s!r}")
    return total


def _parse(s: str) -> Iterator[CigarElem]:
    n = 0
    for ch in s:
        if ch.isdigit():
            n = n * 10 + int(ch)
        else:
            if n == 0:
                raise ValueError(f"Malformed cigar string: {s!r}")
            yield CigarElem(ch, n)
            n = 0
    if n != 0:
        raise ValueError(f"Malformed cigar string: {s!r}")
