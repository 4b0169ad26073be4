"""AlignToReference: glocal alignment of queries to windows at known loci.

Port of ``calitas_tpu/tools/align_to_reference.py`` (AlignToReference.scala):
a TSV of (id?, query, chrom, position) in; either all three of
(max_guide_diffs, max_pam_mismatches, max_overlap) are given (all-hits
mode) or none (best mode); results are sorted and written per 10k-row
batch.  Engines:
  - ``host``: the batched native finish of ``parallel/host_pool.py``.
  - ``gpu``: each batch's locus windows go through the pair screen
    (``ops/pair_screen.py``: the CUDA row screen in per-row-query mode, or
    its plain version with ``device="cpu"``) before the same finish.  In
    all-hits mode the screen's verdict reaches the finish: the strand
    passes that can hold a qualifying alignment, and each chain's
    qualifying end-column range for the native sliced finish.  In best
    mode the finish takes nothing from it: its batched native path runs
    both passes outright, so the port hands the per-item fallback no
    pass-bounds dict either.  The table is identical either way.
  - ``auto``: the list tools' rule of ``device.resolve_engine``.
A device error propagates; nothing degrades to the host behind the
caller's back.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from calitas_tpu_torch.align.engine import SequentialAligner, a2r_region
from calitas_tpu_torch.core.guide import Guide
from calitas_tpu_torch.core.scoring import Defaults
from calitas_tpu_torch.device import resolve_engine
from calitas_tpu_torch.io.fasta import IndexedFasta
from calitas_tpu_torch.io.tsv import MetricWriter, open_output
from calitas_tpu_torch.search.hits import HitBuilder, ReferenceHit, sort_hits
from calitas_tpu_torch.tools.pairwise import dp_query
from calitas_tpu_torch.utils import camel_to_gnu, scala_option_repr

logger = logging.getLogger("calitas_tpu_torch.AlignToReference")

BATCH_SIZE = 10_000  # AlignToReference.scala:110


def core_parameters_string(
    max_guide_diffs,
    max_pam_mismatches,
    max_gaps_between_guide_and_pam,
    max_overlap,
    guide_mismatch_net_cost,
    pam_mismatch_net_cost,
    genome_gap_net_cost,
    guide_gap_net_cost,
) -> str:
    """AlignToReference.scala:77-86 — note the three optional parameters
    render as Scala Option strings (None / Some(x))."""
    params = {
        "maxGuideDiffs": scala_option_repr(max_guide_diffs),
        "maxPamMismatches": scala_option_repr(max_pam_mismatches),
        "maxGapsBetweenGuideAndPam": str(max_gaps_between_guide_and_pam),
        "maxOverlap": scala_option_repr(max_overlap),
        "guideMismatchNetCost": str(guide_mismatch_net_cost),
        "pamMismatchNetCost": str(pam_mismatch_net_cost),
        "genomeGapNetCost": str(genome_gap_net_cost),
        "guideGapNetCost": str(guide_gap_net_cost),
    }
    return ";".join(sorted(f"{camel_to_gnu(k)}={v}" for k, v in params.items()))

def run(
    input: str | Path,
    ref: str | Path,
    output: Optional[str | Path] = None,
    window_size: Optional[int] = None,
    max_guide_diffs: Optional[int] = None,
    max_pam_mismatches: Optional[int] = None,
    max_gaps_between_guide_and_pam: int = Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM,
    max_total_diffs: Optional[int] = None,
    max_overlap: Optional[int] = None,
    guide_mismatch_net_cost: int = Defaults.MISMATCH_NET_COST,
    pam_mismatch_net_cost: int = Defaults.PAM_MISMATCH_NET_COST,
    genome_gap_net_cost: int = Defaults.GENOME_GAP_NET_COST,
    guide_gap_net_cost: int = Defaults.GUIDE_GAP_NET_COST,
    threads: int = 8,
    engine: str = "auto",  # 'auto' | 'host' | 'gpu'
    device: Optional[str] = None,  # the gpu engine's torch device (default cuda)
) -> None:
    ref_file = IndexedFasta(ref)
    if ref_file.dictionary is None or len(ref_file.dictionary) == 0:
        raise ValueError(f"Reference genome must have a sequence dictionary: {ref}")

    given = (max_guide_diffs, max_pam_mismatches, max_overlap)
    if all(v is not None for v in given):
        all_hits = True
    elif all(v is None for v in given):
        all_hits = False
    else:
        raise ValueError(
            "Must specify all or none of: --max-guide-diffs, "
            "--max-pam-mismatches, --max-overlap"
        )

    aligner = SequentialAligner(
        ref=ref_file,
        mismatch_net_cost=guide_mismatch_net_cost,
        pam_mismatch_net_cost=pam_mismatch_net_cost,
        genome_gap_net_cost=genome_gap_net_cost,
        guide_gap_net_cost=guide_gap_net_cost,
    )
    arguments = core_parameters_string(
        max_guide_diffs, max_pam_mismatches, max_gaps_between_guide_and_pam,
        max_overlap, guide_mismatch_net_cost, pam_mismatch_net_cost,
        genome_gap_net_cost, guide_gap_net_cost,
    )
    # Dummy guide initializes the builder; replaced per task
    # (AlignToReference.scala:73).
    builder = HitBuilder(
        guide_id="n/a",
        guide=Guide.parse("AAAnnn"),
        ref=ref_file,
        vcf=None,
        aligner_id="CALITAS:AlignToReference",
        arguments=arguments,
    )

    # Parse the input TSV (headers: id [optional], query, chrom, position).
    tasks: list[tuple[str, str, str, int]] = []
    with open(input) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        col = {name: i for i, name in enumerate(header)}
        for req in ("query", "chrom", "position"):
            if req not in col:
                raise ValueError(f"Input file missing required column: {req}")
        for line in fh:
            if not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            query = f[col["query"]]
            task_id = f[col["id"]] if "id" in col else query
            tasks.append((task_id, query, f[col["chrom"]], int(f[col["position"]])))

    out_fh = open_output(output)
    writer = MetricWriter(out_fh, ReferenceHit)
    from calitas_tpu_torch.parallel.host_pool import _mp_a2r_chunk, map_items_mp

    s = aligner.scorer
    align_kwargs = (
        dict(
            max_guide_diffs=max_guide_diffs,
            max_gaps_between_guide_and_pam=max_gaps_between_guide_and_pam,
            max_pam_diffs=max_pam_mismatches,
            max_total_diffs=(
                max_total_diffs
                if max_total_diffs is not None
                else max_guide_diffs
                + max_gaps_between_guide_and_pam
                + max_pam_mismatches
            ),
            max_overlap=max_overlap,
        )
        if all_hits
        else dict(max_gaps_between_guide_and_pam=max_gaps_between_guide_and_pam)
    )
    spec = {
        "key": ("a2r", str(ref), all_hits, window_size,
                 s.match_score, s.mismatch_score, s.pam_match_score,
                 s.pam_mismatch_score, s.query_gap_score, s.target_gap_score,
                 tuple(sorted(align_kwargs.items()))),
        "ref_path": str(ref),
        "all_hits": all_hits,
        "window_size": window_size,
        "align_kwargs": align_kwargs,
        "mismatch_net_cost": guide_mismatch_net_cost,
        "genome_gap_net_cost": genome_gap_net_cost,
        "guide_gap_net_cost": guide_gap_net_cost,
        "pam_mismatch_net_cost": pam_mismatch_net_cost,
    }

    screen_device = resolve_engine(
        engine, device, n_tasks=len(tasks), prefer_host_when_native=True
    )
    pair_screen = None
    if screen_device is not None:
        from calitas_tpu_torch.ops.pair_screen import PairScreen

        pair_screen = PairScreen(aligner.scorer, screen_device)

    def _screen_batch(batch):
        """The batch with the device screen's verdict attached: in
        all-hits mode each task gains ``(passes, chain ranges)``, the
        strand passes with a qualifying end column (skipping the others
        is exact, per ``align()``'s passes contract) and the screen
        coordinates (loA, hiA, loB, hiB) of the qualifying end columns
        for the worker's sliced native finish; best mode tasks stay as
        they are.  The window math is ``engine.align_to_ref``'s."""
        from calitas_tpu_torch.ops.pair_screen import pass_bounds_for

        guides, targets, min_scores = [], [], []
        for _task_id, query, chrom, pos in batch:
            g = None
            target = b""
            try:
                g = Guide.parse(query)
                seq_len = ref_file.sequence_length(chrom)
                if seq_len is None:
                    raise ValueError(chrom)
                region_start, region_end = a2r_region(
                    g.length, pos, window_size, seq_len
                )
                target = ref_file.get_subsequence(chrom, region_start, region_end)
            except Exception:
                g = None  # the worker re-parses and reports the error
            guides.append(g)
            targets.append(target if g is not None else b"")
            min_scores.append(
                aligner.min_guide_score(g, align_kwargs["max_guide_diffs"])
                if (all_hits and g is not None)
                else 0
            )
        chain_a, chain_b, ranges = pair_screen.chain_maxima_ranges(
            [dp_query(g) for g in guides], targets,
            min_scores if all_hits else None,
        )
        if not all_hits:
            return batch
        out = []
        for k, (task, g, a, b_) in enumerate(zip(batch, guides, chain_a, chain_b)):
            if g is None:
                out.append(task)
                continue
            bounds = pass_bounds_for(g, int(a), int(b_))
            passes = tuple(
                p for p in ("fwd", "rev")
                if bounds[p] == PairScreen.NO_SCREEN or bounds[p] >= min_scores[k]
            )
            # Unscreenable pairs (-1 ranges) carry no ranges and finish
            # full-width.
            cr = None
            if ranges[k, 0] != -1:
                cr = tuple(int(x) for x in ranges[k])
            out.append((*task, (passes, cr)))
        return out

    for batch_start in range(0, len(tasks), BATCH_SIZE):
        batch = tasks[batch_start : batch_start + BATCH_SIZE]
        if pair_screen is not None:
            batch = _screen_batch(batch)
        results: list[ReferenceHit] = []
        for (task_id, _q, _c, _p, *_extra), (guide, alns) in map_items_mp(
            batch, spec, threads,
            worker_fn=_mp_a2r_chunk, to_payload=lambda t: t, logger=logger,
        ):
            b = builder.copy(guide_id=task_id, guide=guide)
            results.extend(b.build(a) for a in alns)
        writer.write_all(sort_hits(results, ref_file.dictionary))
    writer.close()
    if out_fh.name != "<stdout>":
        out_fh.close()
