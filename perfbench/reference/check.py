"""The comparison that decides ``correct``: every table the window returned,
held against the reference (:mod:`perfbench.reference.align`).

Three layers are covered.  The screen, which decides which windows reach the
finish: every site the traffic planted (the guide's own site and its edited
copies at each diff level, on both strands, some across the edges of
upstream's windows and of the screen's batches) must come back as a row on
its strand that overlaps it by ``max_overlap`` bases or more and scores at
least the planted alignment; and so must every site that the reference finds
by searching the request's slices of the genome itself (:func:`search_slice`).  The host finish: every row is checked by
:func:`~perfbench.reference.align.check_row`.  The dedup, sort and
serialization: the table has the columns, the request's guide on every row,
upstream's order (contig in dictionary order, start, strand, score
descending), and no two neighbouring rows of one contig and strand overlap by
``max_overlap`` bases or more.  A group's table is split by its
``guide_id`` column (:func:`split_by_guide`) and each guide's part is held to
that guide.

Each number compared is a count whose limit is 0.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from perfbench.reference.align import (
    GUIDE_MASK,
    TARGET_MASK,
    Limits,
    Scores,
    check_row,
    glocal_best,
    glocal_ends,
    length_on_target,
    parse_table,
    revcomp,
)

#: genome bases of the DP context before a row's last guide base, beyond the
#: protospacer: room for every gap the limits allow and more
DP_SLACK = 12


def split_by_guide(table: str, guide_ids) -> tuple:
    """``({guide id: table}, foreign rows, notes)`` of a group's table: each
    guide's rows under the header, in the table's order.  A row whose
    ``guide_id`` is none of ``guide_ids`` is foreign; a table without that
    column goes whole to every guide, whose check finds the columns missing."""
    lines = table.split("\n")
    header = lines[0].split("\t")
    if "guide_id" not in header:
        return dict.fromkeys(guide_ids, table), 0, []
    col = header.index("guide_id")
    parts = {g: [lines[0]] for g in guide_ids}
    foreign, notes = 0, []
    for line in lines[1:]:
        if not line:
            continue
        f = line.split("\t")
        gid = f[col] if col < len(f) else ""
        if gid in parts:
            parts[gid].append(line)
        else:
            foreign += 1
            if len(notes) < 5:
                notes.append(f"row of guide {gid!r} in the table of {','.join(guide_ids)}")
    return {g: "\n".join(ls) + "\n" for g, ls in parts.items()}, foreign, notes


def check_request(table: str, guide_id: str, guide: str, plants, fetch, lengths: dict,
                  contig_order: dict, scores: Scores, lim: Limits, slices=()) -> dict:
    """Counts of faults of one request's table: ``rows_wrong``,
    ``planted_missed``, ``searched_missed``, ``table_faults``, with ``rows``,
    ``planted`` and ``searched`` (loci the reference found) checked and up to
    five fault descriptions under ``notes``.  ``plants`` are ``(contig,
    strand, start, end, score)`` of the protospacer's genome span and the
    planted alignment's score; ``slices`` are ``(contig, start, end)`` that
    the reference searches on its own (:func:`search_slice`); ``lengths``
    and ``contig_order`` map each contig to its length and its place in the
    dictionary."""
    searched = []
    for contig, a, b in slices:
        searched += [(contig, strand, a + x, a + y, None)
                  for strand, x, y in search_slice(guide, fetch(contig, a, b), scores, lim)]
    out = {"rows": 0, "rows_wrong": 0, "planted": len(plants), "planted_missed": 0,
           "searched": len(searched), "searched_missed": 0, "table_faults": 0, "notes": []}
    rows, missing = parse_table(table)
    if missing:
        out["table_faults"] += 1
        out["planted_missed"] = len(plants)
        out["searched_missed"] = len(searched)
        out["notes"].append(f"{guide_id}: missing columns {missing}")
        return out
    out["rows"] = len(rows)
    protospacer = "".join(ch for ch in guide if ch.isupper())
    width = len(protospacer) + 2 * lim.max_guide_diffs + DP_SLACK
    bad = set()
    jobs = []
    for i, row in enumerate(rows):
        faults = []
        if row["guide_id"] != guide_id or row["unpadded_guide_sequence"] != protospacer:
            faults.append(f"row of guide {row['guide_id']} in the table of {guide_id}")
        else:
            more, job = check_row(row, guide, fetch, lengths.get(row["chromosome"], 0),
                                  scores, lim, width)
            faults += more
            if job is not None:
                job.index = i
                jobs.append(job)
        if faults:
            bad.add(i)
            if len(out["notes"]) < 5:
                out["notes"].append(f"{guide_id} {row['chromosome']}:{row['coordinate_start']}"
                                    f"{row['strand']}: {'; '.join(faults)}")
    for query in {j.query for j in jobs}:
        group = [(j, c) for j in jobs if j.query == query for c in j.contexts]
        best = glocal_best(
            np.frombuffer(query * len(group), dtype=np.uint8).reshape(len(group), -1),
            np.frombuffer(b"".join(c for _j, c in group), dtype=np.uint8)
            .reshape(len(group), -1), scores)
        found = defaultdict(list)
        for (job, _c), b in zip(group, best):
            found[job.index].append(int(b))
        for job in (j for j in jobs if j.query == query):
            if job.guide_part_score not in found[job.index]:
                bad.add(job.index)
                if len(out["notes"]) < 5:
                    row = rows[job.index]
                    out["notes"].append(
                        f"{guide_id} {row['chromosome']}:{row['coordinate_start']}"
                        f"{row['strand']}: guide part scores {job.guide_part_score}, "
                        f"the best alignments ending there {found[job.index]}")
    out["rows_wrong"] = len(bad)
    out["table_faults"] += _order_faults(rows, contig_order, lim.max_overlap, out["notes"])
    out["planted_missed"] = _missed(rows, bad, plants, lim.max_overlap, guide_id, out["notes"])
    out["searched_missed"] = _missed(rows, bad, searched, lim.max_overlap, guide_id, out["notes"])
    return out


def _int(x, default=-1):
    try:
        return int(x)
    except ValueError:
        return default


def _order_faults(rows, contig_order, max_overlap, notes) -> int:
    faults = 0
    keys = [(contig_order.get(r["chromosome"], -1), _int(r["coordinate_start"]),
             r["strand"], -_int(r["score"])) for r in rows]
    for k0, k1 in zip(keys, keys[1:]):
        if k1 < k0:
            faults += 1
            if len(notes) < 5:
                notes.append(f"rows out of order: {k0} before {k1}")
    last = {}
    for r in rows:
        key = (r["chromosome"], r["strand"])
        start = _int(r["coordinate_start"])
        end = start + length_on_target(r["cigar"]) - 1
        if key in last:
            p_start, p_end = last[key]
            if min(p_end, end) - max(p_start, start) >= max_overlap:
                faults += 1
                if len(notes) < 5:
                    notes.append(f"rows at {key[0]}:{p_start} and {start}{key[1]} overlap")
        last[key] = (start, end)
    return faults


def _missed(rows, bad, plants, max_overlap, guide_id, notes) -> int:
    by_site = defaultdict(list)
    for i, r in enumerate(rows):
        if i not in bad:
            by_site[r["chromosome"], r["strand"]].append(
                (_int(r["coordinate_start"]), _int(r["coordinate_end"]), _int(r["score"])))
    missed = 0
    for contig, strand, start, end, score in plants:
        found = any(min(e, end) - max(s, start) >= max_overlap
                    and (score is None or sc >= score)
                    for s, e, sc in by_site[contig, strand])
        if not found:
            missed += 1
            if len(notes) < 5:
                what = "planted site" if score is not None else "site the reference found"
                notes.append(f"{guide_id}: {what} {contig}:{start}-{end}{strand} "
                             f"(score {score}) has no row")
    return missed


def search_slice(guide: str, fwd: str, s: Scores, lim: Limits) -> list:
    """The loci of a slice of the genome that the table must hold, found by
    the reference on its own: ``(strand, start, end)``, relative to the
    slice's forward bases ``fwd``, of each stretch of guide-part ends at
    which the protospacer aligns glocally with ``max_guide_diffs`` or fewer
    diffs and a PAM follows at once within the mismatches allowed.

    A diff costs between ``lo`` and ``hi`` against a full match, so a score
    of ``Q * match - d * hi`` or more is an alignment of ``d`` diffs or
    fewer, and one of ``d + 1`` diffs scores less (checked below).  Every
    alignment so found, PAM included, fits the overlap of two of upstream's
    windows, so some window holds it whole; the row upstream reports there
    (its best alignment ending at that base) is within the limits, and its
    overlap dedup keeps a row over it.  Ends near the slice's edges are left
    out."""
    pam5 = guide[0].islower()
    r_guide = guide if not pam5 else guide[::-1]
    query = "".join(ch for ch in r_guide if ch.isupper())
    pam = "".join(ch for ch in r_guide if ch.islower())
    q, p, d = len(query), len(pam), lim.max_guide_diffs
    lo = min(s.match - s.mismatch, s.match - s.genome_gap, -s.guide_gap)
    hi = max(s.match - s.mismatch, s.match - s.genome_gap, -s.guide_gap)
    if (d + 1) * lo <= d * hi or lim.max_total_diffs < d + lim.max_pam_mismatches:
        raise ValueError("the limits do not separate d diffs from d + 1 by score")
    threshold = q * s.match - d * hi
    pam_room = min(lim.max_pam_mismatches, lim.max_total_diffs - d)
    n = len(fwd)
    edge = q + d + p + 8
    out = []
    for strand in "+-":
        g_or = fwd if strand == "+" else revcomp(fwd)
        r = g_or if not pam5 else g_or[::-1]
        rb = np.frombuffer(r.encode(), dtype=np.uint8)
        ends = glocal_ends(np.frombuffer(query.encode(), dtype=np.uint8)[None, :],
                           rb[None, :], s)[0, 1:]
        j = np.arange(edge, n - edge)
        ok = ends[j] >= threshold
        mism = np.zeros(len(j), dtype=np.int64)
        for k, ch in enumerate(pam):
            mism += (GUIDE_MASK[ord(ch)] & TARGET_MASK[rb[j + 1 + k]]) == 0
        hits = j[ok & (mism <= pam_room)]
        spans = []
        for e in hits.tolist():  # r-coordinates of the core: [e - q + 1, e + p]
            a, b = e - q + 1, e + p
            if spans and a <= spans[-1][1]:
                spans[-1][1] = b
            else:
                spans.append([a, b])
        for a, b in spans:
            if pam5:  # r runs against g_or
                a, b = n - 1 - b, n - 1 - a
            if strand == "-":  # g_or runs against fwd
                a, b = n - 1 - b, n - 1 - a
            out.append((strand, a, b + 1))
    return out
