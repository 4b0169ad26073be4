"""PairwiseAlignSequences: best glocal alignment per (query, target) pair.

Port of ``calitas_tpu/tools/pairwise.py`` (PairwiseAlignSequences.scala):
a whitespace-delimited file of (query, target) pairs in, the 11-column
table out, with query_start hardcoded to 1 and target_start =
aln.startOffset.  Engines:
  - ``host``: the reference package's batched native finish, by import.
  - ``gpu``: the pair screen (``ops/pair_screen.py``: the CUDA row screen
    in per-row-query mode, or its plain version with ``device="cpu"``)
    computes both chains' exact DP maxima for every pair before the same
    host finish.  The finish does not read them: its batched native path
    runs both strand passes outright (``calitas_tpu/parallel/host_pool.py::
    _mp_pairwise_chunk``), and the per-pair fallback would import the
    JAX package to read a pass-bounds dict, so the port hands it none.
    The table is identical either way.
  - ``auto``: the list tools' rule of ``device.resolve_engine``.
A device error propagates; nothing degrades to the host behind the
caller's back.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from calitas_tpu.align.engine import SequentialAligner
from calitas_tpu.core.guide import Guide
from calitas_tpu.core.scoring import Defaults
from calitas_tpu.io.tsv import open_output
from calitas_tpu.tools.pairwise import COLUMNS
from calitas_tpu_torch.device import resolve_engine

logger = logging.getLogger("calitas_tpu_torch.PairwiseAlignSequences")


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
        from calitas_tpu_torch.ops.pair_screen import PairScreen

        chain_a, _chain_b = PairScreen(aligner.scorer, screen_device).chain_maxima(
            [dp_query(parse_or_none(q)) for q, _t in tasks],
            [t for _q, t in tasks],
        )
        logger.info(
            "Pair screen: %d of %d pairs screened on %s.",
            int((chain_a != PairScreen.NO_SCREEN).sum()), len(tasks),
            screen_device,
        )

    from calitas_tpu.parallel.host_pool import _mp_pairwise_chunk, map_items_mp

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
    for (query, target), aln in map_items_mp(
        tasks, spec, threads,
        worker_fn=_mp_pairwise_chunk, to_payload=lambda t: t,
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
