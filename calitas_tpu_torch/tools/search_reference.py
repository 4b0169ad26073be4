"""SearchReference: genome-wide off-target search, reference pass.

Port of ``calitas_tpu/tools/search_reference.py``.  Engines:
  - ``host``: every window is aligned with the exact host engine (the
    reference package's own host pass, reused as is).
  - ``gpu``: the device screen (``parallel/screen_runner.py``) flags the
    windows with a qualifying end column on either strand, and only those
    are finished on the host.  The screen is exact integer DP, so the
    table equals the host engine's.  ``device="cpu"`` runs the same screen
    through its plain PyTorch version.
  - ``auto``: ``gpu`` when ``torch.cuda.is_available()``, else ``host``.

With ``variants`` a second pass aligns the VCF's variant haplotype
windows.  On the gpu engine the variant feeds (native window builder plus
the device slot screen) start on their own threads before the reference
pass and are closed on any error in either pass; the host engine runs the
reference package's host passes as they are.

Hits are deduplicated, sorted and written as the 34-column table by the
reference package's finalizer.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional, Sequence

from calitas_tpu.align.engine import SequentialAligner
from calitas_tpu.core.guide import Guide
from calitas_tpu.core.scoring import Defaults
from calitas_tpu.io.fasta import IndexedFasta, extract_dictionary
from calitas_tpu.search.hits import HitBuilder, RenderedBlock
from calitas_tpu.tools.search_reference import (
    _finalize,
    _run_both_passes,
    _variant_pass,
    core_parameters_string,
)
from calitas_tpu.utils import ProgressLogger
from calitas_tpu_torch.device import resolve_engine

logger = logging.getLogger("calitas_tpu_torch.SearchReference")


def run(
    guide: Optional[str] = None,
    guide_id: Optional[str] = None,
    ref: str | Path = None,
    auxiliary_pams: Sequence[str] = (),
    guide_specs: Optional[Sequence[tuple[str, str, Sequence[str]]]] = None,
    variants: Optional[str | Path] = None,
    max_variants: int = Defaults.MAX_VARIANTS_IN_CLUSTER,
    output: Optional[str | Path] = None,
    threads: int = 8,
    window_size: int = 1000,
    max_guide_diffs: int = Defaults.MAX_GUIDE_DIFFS,
    max_pam_mismatches: int = Defaults.MAX_PAM_MISMATCHES,
    max_gaps_between_guide_and_pam: int = Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM,
    max_total_diffs: Optional[int] = None,
    max_overlap: int = Defaults.MAX_OVERLAP,
    guide_mismatch_net_cost: int = Defaults.MISMATCH_NET_COST,
    pam_mismatch_net_cost: int = Defaults.PAM_MISMATCH_NET_COST,
    genome_gap_net_cost: int = Defaults.GENOME_GAP_NET_COST,
    guide_gap_net_cost: int = Defaults.GUIDE_GAP_NET_COST,
    chrom: Optional[str] = None,
    engine: str = "auto",  # 'auto' | 'host' | 'gpu'
    device: Optional[str] = None,  # the gpu engine's torch device (default cuda)
    profile_dir: Optional[str] = None,
) -> None:
    """Search ``ref`` for one guide (``guide`` + ``guide_id``) or several
    (``guide_specs``) and write the table to ``output`` (stdout if None).
    With ``profile_dir`` a ``torch.profiler`` trace of the run is written
    there as ``trace.json``."""
    run_start = time.perf_counter()
    if ref is None:
        raise ValueError("SearchReference requires a reference FASTA (ref=)")
    screen_device = resolve_engine(engine, device)
    profiler = None
    if profile_dir:
        import torch.profiler as tp

        activities = [tp.ProfilerActivity.CPU]
        if screen_device is not None and screen_device.type == "cuda":
            activities.append(tp.ProfilerActivity.CUDA)
        profiler = tp.profile(activities=activities)
        profiler.start()

    ref = Path(ref)
    dictionary = extract_dictionary(ref)  # required (SearchReference.scala:478-484)
    ref_file = IndexedFasta(ref)
    aligner = SequentialAligner(
        mismatch_net_cost=guide_mismatch_net_cost,
        pam_mismatch_net_cost=pam_mismatch_net_cost,
        genome_gap_net_cost=genome_gap_net_cost,
        guide_gap_net_cost=guide_gap_net_cost,
    )
    max_total_diffs_actual = (
        max_total_diffs
        if max_total_diffs is not None
        else max_guide_diffs + max_gaps_between_guide_and_pam + max_pam_mismatches
    )
    arguments = core_parameters_string(
        max_variants, window_size, max_guide_diffs, max_pam_mismatches,
        max_gaps_between_guide_and_pam, max_total_diffs_actual, max_overlap,
        guide_mismatch_net_cost, pam_mismatch_net_cost, genome_gap_net_cost,
        guide_gap_net_cost,
    )
    if guide_specs is None:
        if guide is None or guide_id is None:
            raise ValueError("Provide either guide+guide_id or guide_specs")
        guide_specs = [(guide_id, guide, tuple(auxiliary_pams))]
    specs = [
        (gid, gstr, Guide.parse(gstr, aux)) for gid, gstr, aux in guide_specs
    ]

    # Completeness-guarantee check (SearchReference.scala:433-441): warn
    # when custom costs can lose valid alignments.
    mags = [abs(guide_mismatch_net_cost), abs(genome_gap_net_cost),
            abs(guide_gap_net_cost)]
    if (max_guide_diffs + 1) * min(mags) <= max_guide_diffs * max(mags):
        logger.warning(
            "Scoring constraint violated: (max-guide-diffs+1)*min_cost must "
            "exceed max-guide-diffs*max_cost or alignments within the given "
            "limits may be missed (min=%d max=%d max-guide-diffs=%d).",
            min(mags), max(mags), max_guide_diffs,
        )

    base_builder = HitBuilder(
        guide_id=specs[0][0],
        guide=specs[0][2],
        ref=ref_file,
        vcf=variants,
        aligner_id="CALITAS:SearchReference",
        arguments=arguments,
    )
    builders = {specs[0][0]: base_builder}
    for gid, _, g in specs[1:]:
        builders[gid] = base_builder.copy(guide_id=gid, guide=g)
    align_kwargs = dict(
        max_guide_diffs=max_guide_diffs,
        max_pam_diffs=max_pam_mismatches,
        max_gaps_between_guide_and_pam=max_gaps_between_guide_and_pam,
        max_total_diffs=max_total_diffs_actual,
        max_overlap=max_overlap,
    )

    def step_for(guide_str: str) -> int:
        window_overlap = (
            len(guide_str) + max_guide_diffs + max_gaps_between_guide_and_pam - 1
        )
        return window_size - window_overlap

    # Parse and index the VCF once per run (SearchReference.scala:227-231).
    vcf_index = None
    if variants is not None:
        from calitas_tpu.io.vcf import VcfIndex

        vcf_index = VcfIndex(variants)

    logger.info("Aligning to reference genome without variants.")
    hits: list = []
    if screen_device is None:
        progress = ProgressLogger(logger, noun="windows", verb="Processed", unit=25_000)
        _run_both_passes(
            chrom, hits, specs, builders, aligner, ref_file, vcf_index,
            max_variants, window_size, step_for, False, threads, align_kwargs,
            progress, logger,
        )
    else:
        _screened_passes(
            chrom, hits, specs, builders, aligner, ref_file, vcf_index,
            max_variants, window_size, step_for, threads, align_kwargs,
            screen_device,
        )
    try:
        _finalize(
            hits, max_overlap, dictionary, output, None, run_start, specs,
            logger,
        )
    finally:
        if profiler is not None:
            profiler.stop()
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(str(Path(profile_dir) / "trace.json"))


def _screened_passes(
    chrom, hits, specs, builders, aligner, ref_file, vcf_index, max_variants,
    window_size, step_for, threads, align_kwargs, device,
):
    """Both passes on the device screen.  The variant feeds start before
    the reference pass so the window builder and slot screen overlap it;
    an error in either pass closes every feed still producing."""
    feeds = _start_variant_feeds(
        chrom, specs, aligner, ref_file, vcf_index, max_variants,
        align_kwargs, device,
    )
    try:
        _screened_reference_pass(
            chrom, hits, specs, builders[specs[0][0]], aligner, ref_file,
            window_size, step_for, threads, align_kwargs, device,
        )
        logger.info("Reference windows processed.")
        if feeds:
            _variant_pass(
                feeds, hits, specs, builders, aligner, threads, align_kwargs,
                logger,
            )
            logger.info("Variant windows processed.")
    except BaseException:
        for _gspecs, feed in feeds:
            feed.close()
        raise


def _start_variant_feeds(
    chrom, specs, aligner, ref_file, vcf_index, max_variants, align_kwargs,
    device,
):
    """The variant pass's feeds, one per guide padding group, each already
    producing on its own thread: ``[(gspecs, BlockFeed)]``, empty without
    a VCF.  Guides of one padding see one window stream
    (SearchReference.scala:217-256), built once and screened for every
    guide of the group."""
    if vcf_index is None:
        return []
    from calitas_tpu.parallel.host_pool import BlockFeed
    from calitas_tpu.search.variants import variant_window_iterator
    from calitas_tpu_torch.search.variants import screened_variant_windows_multi

    max_guide_diffs = align_kwargs["max_guide_diffs"]
    max_gaps = align_kwargs["max_gaps_between_guide_and_pam"]
    groups: dict[int, list] = {}
    for spec in specs:
        padding = spec[2].length - 1 + max_guide_diffs + max_gaps
        groups.setdefault(padding, []).append(spec)
    feeds = []
    try:
        for padding, gspecs in groups.items():
            vwindows = variant_window_iterator(
                ref_file, vcf_index, chrom, padding, max_variants, blocks=True,
            )
            flagged = screened_variant_windows_multi(
                vwindows, aligner,
                [
                    (gid, g, aligner.min_guide_score(g, max_guide_diffs))
                    for gid, _, g in gspecs
                ],
                device=device,
            )
            feeds.append((gspecs, BlockFeed(flagged, 8192, depth=2)))
    except BaseException:
        for _gspecs, feed in feeds:
            feed.close()
        raise
    return feeds


def _screened_reference_pass(
    chrom, hits, specs, builder, aligner, ref_file, window_size, step_for,
    threads, align_kwargs, device,
):
    """Pass 1 on the device screen (SearchReference.scala:527-564)."""
    from calitas_tpu_torch.ops.genome_screen import GenomeScreen
    from calitas_tpu_torch.parallel.screen_runner import (
        GuideTask,
        screened_search,
    )

    tasks = [
        GuideTask(
            guide_id=gid, guide=g, guide_length=len(gstr),
            step_size=step_for(gstr),
        )
        for gid, gstr, g in specs
    ]
    hit_spec = dict(
        ref_path=str(ref_file.path),
        aligner_id=builder.aligner_id,
        arguments=builder.arguments,
        vcf_id=builder.vcf_id,
        timestamp=builder.timestamp,
        aligner_version=builder.aligner_version,
    )
    screen = GenomeScreen(aligner.scorer, device, window=window_size)
    hits_progress = ProgressLogger(logger, noun="hits", verb="Collected", unit=25_000)
    for _task, wchrom, wstart, rows in screened_search(
        ref_file, chrom, tasks, aligner, screen=screen,
        window_size=window_size, hit_spec=hit_spec, threads=threads,
        swallow_errors=True, **align_kwargs,
    ):
        # Columnar blocks append whole (the dedup reads their key arrays).
        if type(rows) is RenderedBlock:
            hits.append(rows)
        else:
            hits.extend(rows)
        hits_progress.record(wchrom, wstart, n=len(rows))
