"""The one generator of traffic: a list of guides drawn from ``--seed``, each
with its own site and edited copies planted in the genome.

A traffic file (``perfbench/traffic/<name>.json``) gives the guide's shape
(protospacer length, PAM, PAM side), the per-request limits passed to
``ResidentSearcher.search`` (``search``), upstream's defaults that the
reference applies besides (``max_overlap``; ``max_total_diffs`` is upstream's
sum of the three limits), how many guides the list holds, and the edited
copies planted of each guide (``plants``: mismatches, guide bulges, genome
bulges, genome bases between protospacer and PAM, PAM mismatches).
``guides_per_request`` (default 1) sends that many guides of the list in one
request, as one ``guide_specs`` group; the list's length is a multiple of it.
Every guide of a file has the file's one shape, so a group is one screen
group of the program (one DP-query length, step and PAM).

Each guide's protospacer is the genome's own bases at a seeded position, and
a PAM that the guide accepts is written beside it there: its site.  Each
edited copy is written at another seeded position, on the strand that
alternates from copy to copy.  Edits fall inside the protospacer, two bases
or more from its ends.  Sites lie ``margin`` bases or more from a contig's
ends and ``spacing`` bases or more from each other.  Every seed gives the same
sizes, in other places and with other bases.

``edge_plants`` are edited copies placed across the edge of one of
upstream's windows, so that only one window holds them whole: across the
start of window ``m`` (only window ``m - 1`` holds the site) or across the
end of window ``m - 1`` (only window ``m`` does), or the one and the other
from guide to guide (``alternate``), where ``m`` is a seeded multiple of
``grid`` windows.  A ``grid`` of the screen's batch of windows
puts the site where one batch, and at times one segment, of the screen ends
and the next begins; a ``grid`` of 1 at any step of the window grid.  Each
request also names a ``reference_search`` slice of that many bases around
such an edge, in which the reference searches the genome itself
(:func:`perfbench.reference.check.search_slice`).
"""

from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass, field

import numpy as np

from perfbench.harness.genome import bases
from perfbench.reference.align import IUPAC, columns_score, revcomp

_BASES = "ACGT"


@dataclass
class Guide:
    id: str
    string: str  # protospacer upper case, PAM lower case, as the search takes it
    protospacer: str
    #: (contig, strand, start, end, score): the protospacer's genome span and
    #: the planted alignment's score
    plants: list = field(default_factory=list)
    #: (contig, start, end) of each slice the reference searches on its own
    slices: list = field(default_factory=list)


@dataclass
class Traffic:
    guides: list
    #: the guides of set-up's search, one group: ``warmup`` where a request
    #: holds one guide, else ``warmup0`` ... ``warmup{G-1}``
    warmup: list
    writes: dict  # {contig: [(start, bytes)]}: the planted sites, forward strand

    @property
    def groups(self) -> list:
        """The requests' groups of guides, in the list's order."""
        g = len(self.warmup)
        return [self.guides[i : i + g] for i in range(0, len(self.guides), g)]


def guides_per_request(spec: dict) -> int:
    """The traffic's ``guides_per_request``; raises where the list's
    ``guides`` are not a whole number of such groups."""
    g = spec.get("guides_per_request", 1)
    if not isinstance(g, int) or g < 1 or spec["guides"] % g:
        raise ValueError(f"traffic {spec.get('name')!r}: guides_per_request {g!r} has to be "
                         f"a whole number of 1 or more that divides its {spec['guides']} guides")
    return g


def rng_for(seed: int, salt: str) -> np.random.Generator:
    h = hashlib.blake2b(f"{salt}:{seed}".encode(), digest_size=16).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


def _compatible_bases(code: str) -> str:
    return "".join(b for b in _BASES if IUPAC[code.upper()] & IUPAC[b])


def design(protospacer: str, pam: str, pam5: bool, edit: dict, rng) -> tuple:
    """One planted site: ``(guide columns, target columns, lead, length)`` in
    the guide's orientation, padded with ``-``, for the edits ``edit`` of the
    protospacer and its PAM; ``lead`` genome bases come before the
    protospacer's ``length``."""
    q = len(protospacer)
    n_mm = edit.get("mismatches", 0)
    n_del = edit.get("guide_bulges", 0)  # a guide base the genome lacks
    n_ins = edit.get("genome_bulges", 0)  # a genome base the guide lacks
    inner = rng.choice(np.arange(2, q - 2), n_mm + n_del + n_ins, replace=False)
    mm, dele, ins = set(inner[:n_mm]), set(inner[n_mm : n_mm + n_del]), set(inner[n_mm + n_del :])
    g_cols, t_cols = [], []
    for i, b in enumerate(protospacer):
        if i in dele:
            g_cols.append(b), t_cols.append("-")
        elif i in mm:
            g_cols.append(b), t_cols.append(rng.choice([x for x in _BASES if x != b]))
        else:
            g_cols.append(b), t_cols.append(b)
        if i in ins:
            g_cols.append("-"), t_cols.append(rng.choice(list(_BASES)))
    gap = edit.get("gap", 0)
    gap_cols = (["-"] * gap, [rng.choice(list(_BASES)) for _ in range(gap)])
    free = [k for k, c in enumerate(pam) if _compatible_bases(c) != _BASES]
    wrong = set(rng.choice(free, edit.get("pam_mismatches", 0), replace=False)) if free else set()
    pam_t = []
    for k, c in enumerate(pam):
        ok = _compatible_bases(c)
        pool = [x for x in _BASES if x not in ok] if k in wrong else list(ok)
        pam_t.append(rng.choice(pool))
    length = sum(t != "-" for t in t_cols)
    if pam5:
        return (list(pam) + gap_cols[0] + g_cols, pam_t + gap_cols[1] + t_cols,
                len(pam) + gap, length)
    return (g_cols + gap_cols[0] + list(pam), t_cols + gap_cols[1] + pam_t, 0, length)


class _Places:
    """Seeded site positions, ``margin`` from contig ends, ``spacing`` apart."""

    def __init__(self, contigs, margin: int, spacing: int, rng):
        self.contigs = [c for c in contigs if c.length > 2 * margin + 10 * spacing]
        w = np.array([c.length for c in self.contigs], dtype=np.float64)
        self.p = w / w.sum()
        self.margin, self.spacing, self.rng = margin, spacing, rng
        self.taken: dict = {}

    def contig(self):
        return self.contigs[self.rng.choice(len(self.contigs), p=self.p)]

    def take(self, c, start: int, length: int) -> bool:
        """Claims ``[start, start + length)`` on ``c`` if it keeps the margin
        and the spacing."""
        if start < self.margin or start + length > c.length - self.margin:
            return False
        taken = self.taken.setdefault(c.name, [])
        k = bisect.bisect_left(taken, start)
        near = taken[max(k - 1, 0) : k + 1]
        if any(abs(s - start) < self.spacing for s in near):
            return False
        taken.insert(k, start)
        return True

    def draw(self, length: int):
        while True:
            c = self.contig()
            start = int(self.rng.integers(self.margin, c.length - self.margin - length))
            if self.take(c, start, length):
                return c, start

    def edge(self, grid: int, step: int, window: int):
        """``(contig, m)``: a seeded window index ``m``, a multiple of
        ``grid`` (of 1 where no contig holds two grids of windows), whose
        edges keep the margin."""
        def tops(g):
            return [((c.length - self.margin - window) // step + 1) // g for c in self.contigs]

        top = tops(grid)
        if max(top) < 1:
            grid, top = 1, tops(1)
        for _ in range(10_000):
            k = self.rng.choice(len(self.contigs), p=self.p)
            if top[k] >= 1:
                m = grid * int(self.rng.integers(1, top[k] + 1))
                if m * step >= self.margin:
                    return self.contigs[k], m
        raise ValueError(f"no window edge of {grid} windows keeps the margin")


def make_traffic(contigs, spec: dict, seed: int, scores, window: int) -> Traffic:
    """The guides of traffic ``spec`` over the genome ``contigs``
    (:func:`perfbench.harness.genome.layout`) for ``seed``; ``scores`` is the
    reference's :class:`~perfbench.reference.align.Scores` and ``window``
    upstream's window size."""
    per_request = guides_per_request(spec)
    rng = rng_for(seed, "traffic")
    shape = spec["guide"]
    q, pam, pam5 = shape["protospacer"], shape["pam"], shape["pam_side"] == "5prime"
    places = _Places(contigs, spec["margin"], spec["spacing"], rng)
    writes: dict = {}

    def plant(guide: Guide, edit: dict, strand: str, at=None, place=None):
        g_cols, t_cols, lead, ptl = design(guide.protospacer, pam, pam5, edit, rng)
        site = "".join(t for t in t_cols if t != "-")
        if at is not None:
            contig, start = at
        elif place is not None:
            contig, start = place(len(site))
        else:
            contig, start = places.draw(len(site))
        writes.setdefault(contig.name, []).append(
            (start, (site if strand == "+" else revcomp(site)).encode()))
        if strand == "+":
            p0 = start + lead
        else:
            p0 = start + len(site) - lead - ptl
        guide.plants.append((contig.name, strand, p0, p0 + ptl,
                             columns_score("".join(g_cols), "".join(t_cols), scores)))

    def new_guide(gid: str) -> Guide:
        plen = len(pam)
        contig, pos = places.draw(q + plen)
        proto_at = pos + plen if pam5 else pos
        protospacer = bases(contig, proto_at, q).decode()
        guide = Guide(gid, pam + protospacer if pam5 else protospacer + pam, protospacer)
        plant(guide, {}, "+", at=(contig, pos))
        return guide

    lim = spec["search"]
    step_of = {}

    def across(edge: dict, step: int, i: int):
        """A placement across a window edge (see the module's doc) for the
        ``i``-th guide."""
        crosses = edge["crosses"]
        if crosses == "alternate":
            crosses = ("window_start", "window_end")[i % 2]

        def place(length: int):
            for _ in range(10_000):
                c, m = places.edge(edge["grid"], step, window)
                at = m * step if crosses == "window_start" else (m - 1) * step + window
                start = at - int(rng.integers(4, length - 3))
                if places.take(c, start, length):
                    return c, start
            raise ValueError(f"no room for {spec['guides']} guides' sites across edges "
                             f"of {edge['grid']} windows")

        return place

    guides = []
    for i in range(spec["guides"]):
        guide = new_guide(f"g{i:04d}")
        step = step_of.setdefault(len(guide.string), window - (
            len(guide.string) + lim["max_guide_diffs"]
            + lim["max_gaps_between_guide_and_pam"] - 1))
        flip = int(rng.integers(2))
        for k, edit in enumerate(spec["plants"]):
            plant(guide, edit, "+-"[(k + flip) % 2])
        for k, edge in enumerate(spec.get("edge_plants", [])):
            plant(guide, edge["edit"], "+-"[(k + flip + 1) % 2], place=across(edge, step, i))
        search = spec.get("reference_search")
        if search:
            c, m = places.edge(search["grid"], step, window)
            half = search["bases"] // 2
            guide.slices.append((c.name, max(m * step - half, 0), min(m * step + half, c.length)))
            c = places.contig()
            guide.slices.append((c.name, max(c.length - search["tail_bases"], 0), c.length))
        guides.append(guide)
    ids = ["warmup"] if per_request == 1 else [f"warmup{k}" for k in range(per_request)]
    return Traffic(guides, [new_guide(i) for i in ids], writes)
