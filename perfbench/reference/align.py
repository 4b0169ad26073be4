"""Upstream CALITAS's scoring and hit semantics, written plainly in NumPy.

Scores come from the net costs as upstream derives them: a guide base
matching scores ``|mismatch| / 2`` and mismatching the negative of the
rest; a genome base against a gap in the guide scores ``-|guide gap|``; a
guide base against a gap in the genome scores ``-|genome gap| + match``; a
PAM base scores ``+-|pam mismatch| / 2``.  Bases are IUPAC masks; a target
``N`` mismatches everything.

A row of the table is an alignment of the guide string (protospacer upper
case, PAM lower case) to the genome, written in the guide's orientation
(``padded_guide`` over ``padded_target``).  :func:`check_row` holds a row
against the genome the harness made: its target bases, its CIGAR, counts and
score as those columns imply, the request's limits, and optimality: the
guide part scores the best glocal score of the protospacer ending at the
same genome base (the guide fully aligned, its far end free), and the PAM
part is the best ungapped PAM placement after it within the limits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

IUPAC = {
    "A": 1, "C": 2, "G": 4, "T": 8, "U": 8, "R": 5, "Y": 10, "S": 6, "W": 9,
    "K": 12, "M": 3, "B": 14, "D": 13, "H": 11, "V": 7, "N": 15,
}
#: byte -> IUPAC mask of a guide base (either case)
GUIDE_MASK = np.zeros(256, dtype=np.int64)
#: byte -> IUPAC mask of a genome base: N, and any byte that is no base
#: (the ``#`` past a contig's ends), is 0 and mismatches everything
TARGET_MASK = np.zeros(256, dtype=np.int64)
for _ch, _m in IUPAC.items():
    for _c in (_ch, _ch.lower()):
        GUIDE_MASK[ord(_c)] = _m
        TARGET_MASK[ord(_c)] = 0 if _ch == "N" else _m

_COMPLEMENT = bytes.maketrans(b"ACGTNacgtn#", b"TGCANtgcan#")

#: byte that :class:`Genome`-like fetchers put past a contig's ends
OFF_CONTIG = "#"


def revcomp(s: str) -> str:
    return s.encode().translate(_COMPLEMENT)[::-1].decode()


def compatible(g: str, t: str) -> bool:
    return bool(GUIDE_MASK[ord(g)] & TARGET_MASK[ord(t)])


@dataclass(frozen=True)
class Scores:
    """Raw column scores derived from upstream's net costs."""

    match: int
    mismatch: int
    guide_gap: int  # a genome base against a gap in the guide (CIGAR D)
    genome_gap: int  # a guide base against a gap in the genome (CIGAR I)
    pam_match: int
    pam_mismatch: int

    @classmethod
    def from_net_costs(cls, guide_mismatch_net_cost: int, pam_mismatch_net_cost: int,
                       genome_gap_net_cost: int, guide_gap_net_cost: int) -> "Scores":
        match = abs(guide_mismatch_net_cost) // 2
        pam_match = abs(pam_mismatch_net_cost) // 2
        return cls(
            match=match,
            mismatch=-(abs(guide_mismatch_net_cost) - match),
            guide_gap=-abs(guide_gap_net_cost),
            genome_gap=-abs(genome_gap_net_cost) + match,
            pam_match=pam_match,
            pam_mismatch=-(abs(pam_mismatch_net_cost) - pam_match),
        )


def column_score(g: str, t: str, s: Scores) -> int:
    if g == "-":
        return s.guide_gap
    if t == "-":
        return s.genome_gap
    ok = compatible(g, t)
    if g.islower():
        return s.pam_match if ok else s.pam_mismatch
    return s.match if ok else s.mismatch


def columns_score(guide: str, target: str, s: Scores) -> int:
    """Score of an alignment given as two padded strings of equal length."""
    return sum(column_score(g, t, s) for g, t in zip(guide, target))


def cigar_of(guide: str, target: str) -> str:
    ops = []
    for g, t in zip(guide, target):
        op = "D" if g == "-" else "I" if t == "-" else "=" if compatible(g, t) else "X"
        if ops and ops[-1][1] == op:
            ops[-1][0] += 1
        else:
            ops.append([1, op])
    return "".join(f"{n}{op}" for n, op in ops)


#: a score no alignment reaches: the DP's value where an alignment may not go
_WALL = -(1 << 40)


def glocal_best(queries: np.ndarray, targets: np.ndarray, s: Scores) -> np.ndarray:
    """Best score of aligning each query whole to a suffix-anchored piece of
    its target: the alignment ends at the target's last base and may start
    anywhere after the last :data:`OFF_CONTIG` byte (the edge of upstream's
    window or of the contig).  ``queries`` [R, Q] and ``targets`` [R, W] are
    byte arrays (upper-case guide bases; genome bases); returns [R] int64.
    The DP runs one query base at a time over every row and column at once;
    the gap in the guide (a run of genome bases) is a running maximum along
    the target."""
    return glocal_ends(queries, targets, s)[:, -1]


def glocal_ends(queries: np.ndarray, targets: np.ndarray, s: Scores) -> np.ndarray:
    """:func:`glocal_best` at every end: ``[R, W + 1]``, column ``c`` the
    best score of an alignment ending at target base ``c - 1``."""
    qm = GUIDE_MASK[queries]
    tm = TARGET_MASK[targets]
    R, W = tm.shape
    wall = np.zeros((R, W + 1), dtype=bool)
    wall[:, 1:] = targets == ord(OFF_CONTIG)
    walled = bool(wall.any())
    # without walls every value lies within (W + Q) * 200 of 0
    dtype = np.int32 if not walled and W < 1 << 23 else np.int64
    gap_run = np.arange(W + 1, dtype=dtype) * dtype(s.guide_gap)
    column = {}  # a query column's mask -> its match scores along the targets
    prev = np.zeros((R, W + 1), dtype=dtype)  # no query base yet: free start
    for i in range(qm.shape[1]):
        q = qm[:, i : i + 1]
        key = q.tobytes()
        if key not in column:
            column[key] = np.where((q & tm) != 0, s.match, s.mismatch).astype(dtype)
        diag = prev[:, :-1] + column[key]
        if walled:
            diag[wall[:, 1:]] = _WALL  # a wall's base is not there to align to
        base = np.empty_like(prev)
        base[:, 0] = prev[:, 0] + s.genome_gap
        np.maximum(diag, prev[:, 1:] + dtype(s.genome_gap), out=base[:, 1:])
        # cur[j] = max over k <= j of base[k] + (j - k) * guide_gap
        base -= gap_run
        cur = np.maximum.accumulate(base, axis=1)
        cur += gap_run
        if walled:
            base += gap_run
            cur[wall] = base[wall]  # nor to skip: before the edge only guide bases go
        prev = cur
    return prev


@dataclass(frozen=True)
class Limits:
    max_guide_diffs: int
    max_pam_mismatches: int
    max_gaps_between_guide_and_pam: int
    max_total_diffs: int
    max_overlap: int
    window: int  # upstream's window size; windows start every ``step(guide)`` bases

    def step(self, guide: str) -> int:
        """Upstream's window step: the window less the guide string's length
        and the limits' room (SearchReference.scala:528-530)."""
        return self.window - (len(guide) + self.max_guide_diffs
                              + self.max_gaps_between_guide_and_pam - 1)


def windows_holding(a: int, b: int, length: int, window: int, step: int) -> list:
    """Upstream's windows of a ``length``-base contig that hold [a, b):
    ``(start, end)``, starts ``0, step, ...`` below ``length - 1``."""
    k0 = max(0, -(-(b - window) // step))
    k1 = min(a // step, (length - 2) // step)
    return [(k * step, min(k * step + window, length)) for k in range(k0, k1 + 1)]


#: the columns of the table the reference reads
COLUMNS = (
    "guide_id", "unpadded_guide_sequence", "chromosome", "coordinate_start",
    "coordinate_end", "strand", "unpadded_target_sequence", "score", "guide_mm",
    "guide_gaps", "guide_mm_plus_gaps", "pam_mm", "total_mm_plus_gaps",
    "padded_guide", "padded_alignment", "padded_target", "cigar",
)


def length_on_target(cigar: str) -> int:
    n, total = 0, 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + int(ch)
        else:
            total += n if ch in "=XDM" else 0
            n = 0
    return total


@dataclass
class RowJob:
    """What :func:`check_row` leaves for the batched DP: the row's guide part
    must score the best glocal score over one of ``contexts`` (each ending
    at the row's last guide base, PAM on the right, cut at the edge of one
    upstream window that holds the row and whose best PAM placement is the
    row's)."""

    index: int
    query: bytes  # the protospacer, PAM on the right
    contexts: list  # bytes: genome bases ending at the guide part's last base
    guide_part_score: int


def check_row(row: dict, guide: str, fetch, length: int, s: Scores, lim: Limits,
              dp_width: int):
    """Faults of one row, and its :class:`RowJob` (None when the row is
    already at fault).  ``guide`` is the request's guide string; ``fetch(contig,
    a, b)`` gives the harness's genome bases of [a, b) as a str, with
    :data:`OFF_CONTIG` outside the contig (None for an unknown contig), and
    ``length`` is the contig's length.  Upstream aligns each window of the
    contig on its own, so a row is optimal within a window that holds it."""
    pg, pt = row["padded_guide"], row["padded_target"]
    if len(pg) != len(pt) or not pg:
        return ["padded strings differ in length"], None
    if pg.replace("-", "") != guide:
        return [f"padded guide {pg} is not the guide {guide}"], None
    try:
        cs, ce = int(row["coordinate_start"]), int(row["coordinate_end"])
        score = int(row["score"])
        counts = {k: int(row[k]) for k in ("guide_mm", "guide_gaps", "guide_mm_plus_gaps",
                                          "pam_mm", "total_mm_plus_gaps")}
    except ValueError:
        return ["a number column does not parse"], None
    strand = row["strand"]
    if strand not in "+-" or len(strand) != 1 or not 0 <= cs < ce:
        return [f"strand {strand!r} or coordinates {cs}-{ce} invalid"], None
    faults = []
    target = pt.replace("-", "")
    lot = len(target)
    pam5 = guide[0].islower()
    margin = lot + dp_width + 16
    a, b = cs - margin, ce + margin
    fwd = fetch(row["chromosome"], a, b)
    if fwd is None:
        return [f"unknown contig {row['chromosome']}"], None
    g_or = fwd if strand == "+" else revcomp(fwd)
    p0, p1 = margin, margin + (ce - cs)
    span = (p0, p0 + lot) if not pam5 else (p1 - lot, p1)
    if g_or[span[0] : span[1]] != target:
        faults.append("target bases differ from the genome")
    if g_or[p0:p1] != row["unpadded_target_sequence"]:
        faults.append("unpadded target differs from the genome")
    # counts, score, CIGAR and alignment line as the padded strings imply
    mm = [t != "-" and g != "-" and not compatible(g, t) for g, t in zip(pg, pt)]
    gaps = [g == "-" or t == "-" for g, t in zip(pg, pt)]
    guide_mm = sum(m for m, g in zip(mm, pg) if g.isupper())
    pam_mm = sum(m for m, g in zip(mm, pg) if g.islower())
    n_gaps = sum(gaps)
    implied = {"guide_mm": guide_mm, "guide_gaps": n_gaps,
               "guide_mm_plus_gaps": guide_mm + n_gaps, "pam_mm": pam_mm,
               "total_mm_plus_gaps": guide_mm + n_gaps + pam_mm}
    faults += [f"{k} {counts[k]} != {v}" for k, v in implied.items() if counts[k] != v]
    if columns_score(pg, pt, s) != score:
        faults.append(f"score {score} != {columns_score(pg, pt, s)} of its alignment")
    if cigar_of(pg, pt) != row["cigar"]:
        faults.append(f"cigar {row['cigar']} != {cigar_of(pg, pt)}")
    line = "".join("~" if gp else "." if m else "|" for gp, m in zip(gaps, mm))
    if line != row["padded_alignment"]:
        faults.append("padded alignment line differs")
    # PAM on the right: the orientation in which upstream's DP runs
    r_g, r_t = (pg, pt) if not pam5 else (pg[::-1], pt[::-1])
    r_or = g_or if not pam5 else g_or[::-1]
    r_start = span[0] if not pam5 else len(g_or) - span[1]
    upper = [i for i, ch in enumerate(r_g) if ch.isupper()]
    lower = [i for i, ch in enumerate(r_g) if ch.islower()]
    if not upper or (lower and lower[0] < upper[-1]):
        return faults + ["PAM not on one side of the protospacer"], None
    last = upper[-1]
    first_pam = lower[0] if lower else len(r_g)
    between = r_g[last + 1 : first_pam]
    if set(between) - {"-"} or "-" in r_t[first_pam:]:
        return faults + ["gap inside the PAM"], None
    r_mm = mm if not pam5 else mm[::-1]
    r_gaps = gaps if not pam5 else gaps[::-1]
    inner_diffs = sum(r_mm[i] or r_gaps[i] for i in range(last + 1))
    if inner_diffs > lim.max_guide_diffs:
        faults.append(f"{inner_diffs} guide diffs > {lim.max_guide_diffs}")
    if len(between) > lim.max_gaps_between_guide_and_pam:
        faults.append(f"{len(between)} gap bases before the PAM > "
                      f"{lim.max_gaps_between_guide_and_pam}")
    if pam_mm > lim.max_pam_mismatches:
        faults.append(f"{pam_mm} PAM mismatches > {lim.max_pam_mismatches}")
    if implied["total_mm_plus_gaps"] > lim.max_total_diffs:
        faults.append(f"{implied['total_mm_plus_gaps']} diffs > {lim.max_total_diffs}")
    if faults:
        return faults, None
    j = r_start + sum(ch != "-" for ch in r_t[: last + 1]) - 1  # last guide base
    terminal = len(r_t[: last + 1]) - len(r_t[: last + 1].rstrip("-"))
    row_pam = len(between) * s.guide_gap + columns_score(r_g[first_pam:], r_t[first_pam:], s)
    # the alignment's genome span, and the windows that hold it
    fa = cs - margin + (span[0] if strand == "+" else len(g_or) - span[1])
    contexts = []
    for ws, we in windows_holding(fa, fa + lot, length, lim.window, lim.step(guide)):
        lo, hi = max(ws - a, 0), min(we - a, len(fwd))
        w_fwd = OFF_CONTIG * lo + fwd[lo:hi] + OFF_CONTIG * (len(fwd) - hi)
        w_or = w_fwd if strand == "+" else revcomp(w_fwd)
        w_r = w_or if not pam5 else w_or[::-1]
        # the PAM part: the best ungapped PAM placement after the guide part
        if lower and _best_pam(w_r, j, r_g[first_pam:], terminal, inner_diffs, s,
                               lim) != row_pam:
            continue
        contexts.append(w_r[j - dp_width + 1 : j + 1].encode())  # the margin keeps it whole
    if not contexts:
        return [f"no window holds the alignment with its PAM part ({row_pam}) the best"], None
    query = "".join(ch for ch in r_g[: last + 1] if ch != "-")
    guide_part = columns_score(r_g[: last + 1], r_t[: last + 1], s)
    return [], RowJob(-1, query.encode(), contexts, guide_part)


def _best_pam(r_or: str, j: int, pam: str, terminal: int, guide_diffs: int, s: Scores,
              lim: Limits):
    """Upstream's PAM extension after a guide part ending at ``j``: for each
    gap of ``o`` genome bases up to the allowance left, the PAM placed
    ungapped after it, within the mismatches left; the best score, or None."""
    best = None
    extra = min(lim.max_gaps_between_guide_and_pam - terminal,
                lim.max_total_diffs - guide_diffs)
    for o in range(extra + 1):
        site = r_or[j + 1 + o : j + 1 + o + len(pam)]
        if len(site) < len(pam) or OFF_CONTIG in site:
            break
        mism = sum(not compatible(g, t) for g, t in zip(pam, site))
        if mism > min(lim.max_pam_mismatches, lim.max_total_diffs - guide_diffs - o):
            continue
        sc = o * s.guide_gap + columns_score(pam, site, s)
        best = sc if best is None else max(best, sc)
    return best


def parse_table(text: str):
    """``(rows as dicts, missing columns)`` of a TSV table with a header."""
    lines = text.split("\n")
    header = lines[0].split("\t") if lines else []
    missing = [c for c in COLUMNS if c not in header]
    idx = {c: header.index(c) for c in COLUMNS if c in header}
    rows = []
    for line in lines[1:]:
        if not line:
            continue
        f = line.split("\t")
        rows.append({c: (f[i] if i < len(f) else "") for c, i in idx.items()})
    return rows, missing
