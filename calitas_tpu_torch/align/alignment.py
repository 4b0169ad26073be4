"""The DP-level alignment record.

Mirrors the observable contract of fgbio's ``Alignment`` as used by the
reference (SURVEY.md §2.9.1): 1-based closed coordinates, a cigar over
``= X I D``, a score, and ``paddedString(gapChar)`` rendering.

Conventions: ``I`` consumes query (gap in target), ``D`` consumes target
(gap in query).  In Glocal mode the query is always fully aligned
(query_start == 1) and the target locally (target_start..target_end is the
consumed span, 1-based closed).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from calitas_tpu_torch.core.cigar import Cigar
from calitas_tpu_torch.core.sequence import MASK_TABLE

GAP_CHAR = "~"  # SequentialGuideAligner.scala:15


@dataclass(frozen=True)
class Alignment:
    query: bytes  # query bytes (case significant: lowercase = PAM)
    target: bytes  # the full target the alignment is against
    query_start: int  # 1-based
    target_start: int  # 1-based
    cigar: Cigar
    score: int

    @property
    def target_end(self) -> int:
        """1-based closed end, derived from the cigar (as in fgbio, so PAM
        extension updates it implicitly via the new cigar)."""
        return self.target_start + self.cigar.length_on_target - 1

    def copy(self, **kw) -> "Alignment":
        return replace(self, **kw)

    def padded_strings(self, gap_char: str = GAP_CHAR) -> tuple[str, str, str]:
        return padded_strings(
            self.query, self.target, self.query_start, self.target_start,
            self.cigar, gap_char,
        )


def padded_strings(
    query: bytes,
    target: bytes,
    query_start: int,
    target_start: int,
    cigar: Cigar,
    gap_char: str = GAP_CHAR,
) -> tuple[str, str, str]:
    """Render (padded_query, alignment_line, padded_target).

    Sequences are padded with ``-``; the alignment line uses ``|`` for
    match, ``.`` for mismatch and ``gap_char`` for gaps — the rendering the
    reference gets from fgbio ``Alignment.paddedString``
    (SequentialGuideAligner.scala:511; README.md:126).
    """
    q: list[str] = []
    a: list[str] = []
    t: list[str] = []
    qi = query_start - 1
    ti = target_start - 1
    for elem in cigar:
        n = elem.length
        if elem.op in "=XM":
            qs = query[qi : qi + n].decode("ascii")
            ts = target[ti : ti + n].decode("ascii")
            q.append(qs)
            t.append(ts)
            if elem.op == "=":
                a.append("|" * n)
            elif elem.op == "X":
                a.append("." * n)
            else:  # M: decide per base by compatibility
                a.append(
                    "".join(
                        "|" if MASK_TABLE[query[qi + i]] & MASK_TABLE[target[ti + i]] else "."
                        for i in range(n)
                    )
                )
            qi += n
            ti += n
        elif elem.op == "I":  # consumes query; gap in target
            q.append(query[qi : qi + n].decode("ascii"))
            a.append(gap_char * n)
            t.append("-" * n)
            qi += n
        elif elem.op == "D":  # consumes target; gap in query
            q.append("-" * n)
            a.append(gap_char * n)
            t.append(target[ti : ti + n].decode("ascii"))
            ti += n
        else:
            raise ValueError(f"Unsupported op in padded rendering: {elem.op}")
    return "".join(q), "".join(a), "".join(t)
