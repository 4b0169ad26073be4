"""The reference on a small hand-built genome."""

import numpy as np
import pytest

from perfbench.reference.align import (
    Limits,
    Scores,
    check_row,
    columns_score,
    glocal_best,
    glocal_ends,
    revcomp,
    windows_holding,
)
from perfbench.reference.check import DP_SLACK, check_request, search_slice, split_by_guide

S = Scores.from_net_costs(-120, -260, -122, -121)
LIM = Limits(3, 1, 3, 7, 10, window=1000)
GUIDE = "GACGCATAAAGATGAGACGCnrg"
PROTO = GUIDE[:20]
RNG = np.random.default_rng(5)
CHR1 = "".join(RNG.choice(list("ACGT"), 5000))
# a genome bulge (T after base 11) and a PAM at 1000; the guide's reverse
# complement with an AGG PAM at 3000
SITE = "GACGCATAAAGTATGAGACGC" + "GGG"
CHR1 = CHR1[:1000] + SITE + CHR1[1000 + len(SITE):]
CHR1 = CHR1[:3000] + revcomp(PROTO + "AGG") + CHR1[3023:]
GENOME = {"chr1": CHR1}
LENGTHS = {"chr1": len(CHR1)}


def fetch(name, a, b):
    if name not in GENOME:
        return None
    g = GENOME[name]
    lo, hi = max(a, 0), min(b, len(g))
    return "#" * (lo - a) + g[lo:hi] + "#" * (b - hi)


def row(**over):
    r = dict(guide_id="g1", unpadded_guide_sequence=PROTO, chromosome="chr1",
             coordinate_start="1000", coordinate_end="1021", strand="+",
             unpadded_target_sequence="GACGCATAAAGTATGAGACGC", score="1469",
             guide_mm="0", guide_gaps="1", guide_mm_plus_gaps="1", pam_mm="0",
             total_mm_plus_gaps="1", padded_guide="GACGCATAAAG-ATGAGACGCnrg",
             padded_alignment="|||||||||||~||||||||||||",
             padded_target="GACGCATAAAGTATGAGACGCGGG", cigar="11=1D12=")
    r.update(over)
    return r


def minus_row(**over):
    r = row(coordinate_start="3003", coordinate_end="3023", strand="-",
            unpadded_target_sequence=PROTO, score="1590", guide_gaps="0",
            guide_mm_plus_gaps="0", total_mm_plus_gaps="0", padded_guide=GUIDE,
            padded_alignment="|" * 23, padded_target=PROTO + "AGG", cigar="23=")
    r.update(over)
    return r


def table(rows):
    cols = list(row())
    return "\n".join(["\t".join(cols)] + ["\t".join(r[c] for c in cols) for r in rows]) + "\n"


def test_scores_follow_upstreams_net_costs():
    assert (S.match, S.mismatch, S.guide_gap, S.genome_gap, S.pam_match, S.pam_mismatch) == (
        60, -60, -121, -62, 130, -130)
    assert columns_score("GACGCATAAAG-ATGAGACGCnrg", "GACGCATAAAGTATGAGACGCGGG", S) == 1469


@pytest.mark.parametrize("make", [row, minus_row])
def test_a_sound_row_passes(make):
    faults, job = check_row(make(), GUIDE, fetch, len(CHR1), S, LIM, 20 + 6 + DP_SLACK)
    assert faults == []
    best = glocal_best(np.frombuffer(job.query, np.uint8)[None],
                       np.frombuffer(job.contexts[0], np.uint8)[None], S)
    assert best[0] == job.guide_part_score


@pytest.mark.parametrize("change", [
    dict(score="1470"), dict(cigar="11=1I12="), dict(guide_gaps="0"),
    dict(coordinate_start="1001", coordinate_end="1022"), dict(strand="-"),
    dict(padded_target="GACGCATAAAGTATGAGACGCGGA"),
])
def test_an_altered_row_is_a_fault(change):
    faults, _job = check_row(row(**change), GUIDE, fetch, len(CHR1), S, LIM, 38)
    assert faults


def test_a_suboptimal_row_is_a_fault():
    # the same site aligned with a mismatch and a gap in the genome instead
    # of the genome's extra base: a valid alignment, not the best one
    r = row(score="1348", guide_mm="1", guide_gaps="1", guide_mm_plus_gaps="2",
            total_mm_plus_gaps="2", padded_guide="GACGCATAAAGA-TGAGACGCnrg",
            padded_alignment="|||||||||||.~|||||||||||",
            padded_target="GACGCATAAAGTATGAGACGCGGG", cigar="11=1X1D11=")
    out = check_request(table([r, minus_row()]), "g1", GUIDE, [], fetch, LENGTHS, {"chr1": 0}, S, LIM)
    assert out["rows_wrong"] == 1


def test_planted_sites_order_and_overlaps():
    plants = [("chr1", "+", 1000, 1021, 1469), ("chr1", "-", 3003, 3023, 1590)]
    good = table([row(), minus_row()])
    out = check_request(good, "g1", GUIDE, plants, fetch, LENGTHS, {"chr1": 0}, S, LIM)
    assert (out["rows_wrong"], out["planted_missed"], out["table_faults"]) == (0, 0, 0)
    dropped = check_request(table([row()]), "g1", GUIDE, plants, fetch, LENGTHS, {"chr1": 0}, S, LIM)
    assert dropped["planted_missed"] == 1
    swapped = check_request(table([minus_row(), row()]), "g1", GUIDE, plants, fetch,
                            LENGTHS, {"chr1": 0}, S, LIM)
    assert swapped["table_faults"] == 1
    twice = check_request(table([row(), row(), minus_row()]), "g1", GUIDE, plants, fetch,
                          LENGTHS, {"chr1": 0}, S, LIM)
    assert twice["table_faults"] == 1
    other = check_request(good.replace("g1\t", "g2\t"), "g1", GUIDE, plants, fetch,
                          LENGTHS, {"chr1": 0}, S, LIM)
    assert other["rows_wrong"] == 2 and other["planted_missed"] == 2


def test_windows_holding_an_alignment():
    # step 972 (window 1000, a 23-base guide string at -d 3 -g 3)
    assert LIM.step(GUIDE) == 972
    assert windows_holding(1000, 1024, 5000, 1000, 972) == [(972, 1972)]
    assert windows_holding(980, 1000, 5000, 1000, 972) == [(0, 1000), (972, 1972)]
    assert windows_holding(4990, 4999, 5000, 1000, 972) == [(4860, 5000)]
    assert windows_holding(0, 1001, 5000, 1000, 972) == []


def test_a_window_edge_cuts_the_alignment():
    # a wall before the last 20 bases leaves no room for the 20-base query
    # but with gaps: the best then spends one guide base on a genome gap
    q = "ACGTACGTACGTACGTACGT"
    t = "#" * 5 + q[1:]
    best = glocal_best(np.array([list(q.encode())], np.uint8),
                       np.array([list(t.encode())], np.uint8), S)
    assert best[0] == 19 * S.match + S.genome_gap


def _glocal_loop(q: str, t: str) -> int:
    """The DP cell by cell: the query whole, ending at the target's end."""
    from perfbench.reference.align import compatible

    H = [[0] * (len(t) + 1)]
    for i, qc in enumerate(q, 1):
        rowi = [H[i - 1][0] + S.genome_gap]
        for j, tc in enumerate(t, 1):
            rowi.append(max(H[i - 1][j - 1] + (S.match if compatible(qc, tc) else S.mismatch),
                            H[i - 1][j] + S.genome_gap, rowi[j - 1] + S.guide_gap))
        H.append(rowi)
    return H[-1][-1]


def test_glocal_best_equals_the_cell_by_cell_dp():
    rng = np.random.default_rng(11)
    qs = ["".join(rng.choice(list("ACGT"), 8)) for _ in range(40)]
    ts = ["".join(rng.choice(list("ACGTN"), 14)) for _ in range(40)]
    ts[0] = "TTTTTT" + qs[0]  # an exact hit ending at the end
    best = glocal_best(np.array([list(q.encode()) for q in qs], np.uint8),
                       np.array([list(t.encode()) for t in ts], np.uint8), S)
    assert best[0] == 8 * S.match
    assert list(best) == [_glocal_loop(q, t) for q, t in zip(qs, ts)]


def test_glocal_ends_equal_the_cell_by_cell_dp_at_every_end():
    rng = np.random.default_rng(12)
    q = "".join(rng.choice(list("ACGT"), 7))
    t = "".join(rng.choice(list("ACGTN"), 30)) + q
    ends = glocal_ends(np.array([list(q.encode())], np.uint8),
                       np.array([list(t.encode())], np.uint8), S)[0]
    assert ends.dtype == np.int32 and ends[-1] == 7 * S.match
    assert list(ends[1:]) == [_glocal_loop(q, t[:j]) for j in range(1, len(t) + 1)]


def test_the_reference_search_finds_the_sites_and_a_missing_row():
    found = search_slice(GUIDE, CHR1, S, LIM)

    def holds(spans, strand, a, b):
        return any(st == strand and x <= a and b <= y for st, x, y in spans)

    assert len(found) == 2 and holds(found, "+", 1000, 1024) and holds(found, "-", 3000, 3023)
    # a 5' PAM guide, once on each strand
    proto = "".join(RNG.choice(list("ACGT"), 23))
    g = CHR1[:500] + "TTTA" + proto + CHR1[527:2000] + revcomp("TTTC" + proto) + CHR1[2027:]
    found5 = search_slice("tttv" + proto, g, S, LIM)
    assert holds(found5, "+", 500, 527) and holds(found5, "-", 2000, 2027)
    slices = [("chr1", 0, len(CHR1))]
    good = check_request(table([row(), minus_row()]), "g1", GUIDE, [], fetch, LENGTHS,
                         {"chr1": 0}, S, LIM, slices)
    assert good["searched"] == len(found) and good["searched_missed"] == 0
    dropped = check_request(table([minus_row()]), "g1", GUIDE, [], fetch, LENGTHS,
                            {"chr1": 0}, S, LIM, slices)
    assert dropped["searched_missed"] == 1


def test_a_group_table_splits_by_guide_in_order():
    g2 = row(guide_id="g2", coordinate_start="2000", coordinate_end="2021")
    rows = [row(), g2, minus_row(), minus_row(guide_id="g2", coordinate_start="4000")]
    tables, foreign, notes = split_by_guide(table(rows), ("g1", "g2", "g3"))
    assert foreign == 0 and notes == []
    assert tables["g1"] == table([row(), minus_row()])
    assert tables["g2"] == table([g2, minus_row(guide_id="g2", coordinate_start="4000")])
    assert tables["g3"] == table([])
    plants = [("chr1", "+", 1000, 1021, 1469), ("chr1", "-", 3003, 3023, 1590)]
    out = check_request(tables["g1"], "g1", GUIDE, plants, fetch, LENGTHS, {"chr1": 0}, S, LIM)
    assert (out["rows_wrong"], out["planted_missed"], out["table_faults"]) == (0, 0, 0)
    missed = check_request(tables["g3"], "g3", GUIDE, plants, fetch, LENGTHS, {"chr1": 0}, S,
                           LIM)
    assert missed["planted_missed"] == 2


def test_a_row_of_a_guide_outside_the_group_is_a_table_fault():
    tables, foreign, notes = split_by_guide(table([row(), row(guide_id="g9")]), ("g1", "g2"))
    assert foreign == 1 and "g9" in notes[0]
    assert tables["g1"] == table([row()]) and tables["g2"] == table([])
    bare = "chromosome\tscore\nchr1\t1\n"
    tables, foreign, _notes = split_by_guide(bare, ("g1", "g2"))
    assert foreign == 0 and tables == {"g1": bare, "g2": bare}
    out = check_request(bare, "g1", GUIDE, [], fetch, LENGTHS, {"chr1": 0}, S, LIM)
    assert out["table_faults"] == 1
