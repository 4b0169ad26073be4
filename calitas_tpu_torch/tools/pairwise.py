"""PairwiseAlignSequences: best glocal alignment per (query, target) pair.

Port of ``calitas_tpu/tools/pairwise.py`` (PairwiseAlignSequences.scala):
a whitespace-delimited file of (query, target) pairs in, the 11-column
table out, with query_start hardcoded to 1 and target_start =
aln.startOffset.  Engines:
  - ``host``: the batched native finish of ``parallel/host_pool.py``.
  - ``gpu``: the pair screen (``ops/pair_screen.py``: the CUDA row screen
    in per-row-query mode, or its plain version with ``device="cpu"``)
    computes both chains' exact DP maxima for every pair before the same
    host finish.  The batched native path runs both strand passes
    outright (``parallel/host_pool.py::_mp_pairwise_chunk``) and reads
    nothing of them; without the native library each pair carries them to
    the per-pair fallback as a pass-DP-bounds dict (``pass_bounds_for``),
    which skips the rev pass where the bound shows it cannot win
    (``align.engine.align_best``).  The table is identical either way.
  - ``auto``: the list tools' rule of ``device.resolve_engine``.
A device fault in the pair screen degrades, as the reference's does: the
pairs run both passes on the host with no bounds (the same table), with
a WARNING and one count in ``utils.DEGRADED["pair_screen"]``.  A kernel
that does not build, launch or run, and programming errors, propagate.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from calitas_tpu_torch.align.engine import SequentialAligner
from calitas_tpu_torch.core.guide import Guide
from calitas_tpu_torch.core.scoring import Defaults
from calitas_tpu_torch.device import resolve_engine
from calitas_tpu_torch.io.tsv import open_output
from calitas_tpu_torch.utils import degradable, note_degraded

logger = logging.getLogger("calitas_tpu_torch.PairwiseAlignSequences")

COLUMNS = [
    "query", "target", "score", "query_start", "target_start", "cigar",
    "mismatches", "gap_bases", "padded_query", "alignment", "padded_target",
]


def dp_query(guide: Optional[Guide]) -> str:
    """The DP-orientation query of a parsed guide ("" for None): the
    revcomp'd protospacer for 5'-PAM guides, else the protospacer."""
    if guide is None:
        return ""
    return guide.guide_rc if guide.pam_is_5prime else guide.guide_fw


def parse_or_none(query: str) -> Optional[Guide]:
    """The parsed guide, or None when it does not parse (the finish
    worker re-parses it and reports the error in its row)."""
    try:
        return Guide.parse(query)
    except Exception:
        return None


def run(
    input: str | Path,
    output: Optional[str | Path] = None,
    threads: int = 8,
    max_gaps_between_guide_and_pam: int = Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM,
    max_overlap: int = Defaults.MAX_OVERLAP,
    guide_mismatch_net_cost: int = Defaults.MISMATCH_NET_COST,
    pam_mismatch_net_cost: int = Defaults.PAM_MISMATCH_NET_COST,
    genome_gap_net_cost: int = Defaults.GENOME_GAP_NET_COST,
    guide_gap_net_cost: int = Defaults.GUIDE_GAP_NET_COST,
    engine: str = "auto",  # 'auto' | 'host' | 'gpu'
    device: Optional[str] = None,  # the gpu engine's torch device (default cuda)
) -> None:
    tasks: list = []
    with open(input) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            fields = line.split()
            if len(fields) != 2:
                raise ValueError(
                    f"Line found with {len(fields)} fields: {' '.join(fields)}"
                )
            tasks.append((fields[0], fields[1].upper()))

    aligner = SequentialAligner(
        mismatch_net_cost=guide_mismatch_net_cost,
        pam_mismatch_net_cost=pam_mismatch_net_cost,
        genome_gap_net_cost=genome_gap_net_cost,
        guide_gap_net_cost=guide_gap_net_cost,
    )
    screen_device = resolve_engine(
        engine, device, n_tasks=len(tasks), prefer_host_when_native=True
    )
    if screen_device is not None:
        from calitas_tpu_torch import native
        from calitas_tpu_torch.ops.pair_screen import PairScreen, pass_bounds_for

        guides = [parse_or_none(q) for q, _t in tasks]
        try:
            chain_a, chain_b = PairScreen(aligner.scorer, screen_device).chain_maxima(
                [dp_query(g) for g in guides], [t for _q, t in tasks],
            )
        except Exception as ex:
            if not degradable(ex):
                raise
            note_degraded("pair_screen", logger,
                          "Device pair screen unavailable; aligning unscreened.")
            chain_a = None
        else:
            logger.info(
                "Pair screen: %d of %d pairs screened on %s.",
                int((chain_a != PairScreen.NO_SCREEN).sum()), len(tasks),
                screen_device,
            )
        # Only the per-pair fallback reads the bounds; unscreened pairs
        # carry none and run both passes.
        if chain_a is not None and not native.available():
            tasks = [
                (q, t, pass_bounds_for(g, int(a), int(b)) if g is not None else None)
                for (q, t), g, a, b in zip(tasks, guides, chain_a, chain_b)
            ]

    from calitas_tpu_torch.parallel.host_pool import _mp_pairwise_chunk, map_items_mp

    s = aligner.scorer
    spec = {
        "key": ("pw", s.match_score, s.mismatch_score, s.pam_match_score,
                 s.pam_mismatch_score, s.query_gap_score, s.target_gap_score,
                 max_gaps_between_guide_and_pam),
        "max_gaps": max_gaps_between_guide_and_pam,
        "mismatch_net_cost": guide_mismatch_net_cost,
        "genome_gap_net_cost": genome_gap_net_cost,
        "guide_gap_net_cost": guide_gap_net_cost,
        "pam_mismatch_net_cost": pam_mismatch_net_cost,
    }

    out = open_output(output)
    out.write("\t".join(COLUMNS) + "\n")
    for (query, target, *_bounds), aln in map_items_mp(
        tasks, spec, threads,
        worker_fn=_mp_pairwise_chunk, to_payload=lambda t: t, logger=logger,
    ):
        fields = [
            query,
            target,
            str(aln.score),
            "1",
            str(aln.start_offset),
            str(aln.cigar),
            str(aln.mismatches),
            str(aln.gap_bases),
            aln.padded_guide,
            aln.padded_alignment,
            aln.padded_target,
        ]
        out.write("\t".join(fields) + "\n")
    if out.name != "<stdout>":
        out.close()
    else:
        out.flush()
