"""Multi-host orchestration of genome searches: whole-contig shards and
their merge.

A copy of ``calitas_tpu/parallel/multihost.py`` (imports renamed).  The
genome is partitioned across processes by whole contigs (a contig is the
natural shard unit: the global dedup groups by (guide, chromosome,
strand, variant_description), so no dedup group ever spans two shards).
Each process runs its contig subset with the ordinary single-process
engine (``SearchReference --process-index I --process-count N``) and
writes its own hit table.  Merging is then exact: concatenate the rows,
run the same dictionary sort, and the table is row-identical to a
single-process run (``MergeHitTables``).  The merge is host code; hit
tables are small.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

from calitas_tpu_torch.io.fasta import SequenceDictionary
from calitas_tpu_torch.io.tsv import MetricWriter, open_output, read_metrics
from calitas_tpu_torch.search.hits import ReferenceHit, sort_hits


def host_contig_partition(
    contigs: Sequence[tuple[str, int]], process_index: int, process_count: int
) -> list[str]:
    """Greedy longest-first balanced partition of contigs over hosts;
    deterministic for a given dictionary."""
    order = sorted(contigs, key=lambda c: (-c[1], c[0]))
    loads = [0] * process_count
    mine: list[str] = []
    for name, length in order:
        h = min(range(process_count), key=lambda i: (loads[i], i))
        loads[h] += length
        if h == process_index:
            mine.append(name)
    return mine


def merge_host_outputs(
    hit_files: Sequence[str | Path],
    dictionary: Optional[SequenceDictionary],
    output: Optional[str | Path],
) -> int:
    """Merge per-host standard hit tables into the canonical global table.

    Each host ran the ordinary tool over its contig subset, so its table
    already contains the globally-deduped keepers for its dedup groups
    (groups are per-chromosome and never span hosts).  The merge is
    therefore exactly: concatenate + global dictionary sort — provably
    row-identical to a single-host run.  Returns the rows written."""
    hits: list[ReferenceHit] = []
    for f in hit_files:
        hits.extend(read_metrics(f, ReferenceHit))
    ordered = sort_hits(hits, dictionary)
    out_fh = open_output(output)
    writer = MetricWriter(out_fh, ReferenceHit)
    writer.write_all(ordered)
    writer.close()
    import sys

    if out_fh is not sys.stdout:
        out_fh.close()
    return len(ordered)
