"""Command line of the PyTorch/CUDA port: the four reference tools
(SearchReference, AlignToReference, PairwiseAlignSequences, PrepareVcf)
with the flags and defaults of ``calitas_tpu/cli.py``
(SearchReference.scala:451-471, AlignToReference.scala:34-51,
PairwiseAlignSequences.scala:24-34, PrepareVcf.scala:31-37), and
``--engine {auto,host,gpu}`` and ``--device`` on the three that screen.
PrepareVcf is host-only and runs ``calitas_tpu.tools.prepare_vcf``.

    python -m calitas_tpu_torch SearchReference -i GUIDE -I ID -r REF.fa \\
        -o OUT.txt --engine gpu [-v VARIANTS.vcf]
    python -m calitas_tpu_torch SearchReference --guide-file GUIDES.tsv \\
        -r REF.fa -o OUT.txt --engine gpu
    python -m calitas_tpu_torch AlignToReference -i LOCI.tsv -r REF.fa \\
        -o OUT.txt --engine gpu [-w 200 -d 4 -p 1 -O 5]
    python -m calitas_tpu_torch PairwiseAlignSequences -i PAIRS.txt \\
        -o OUT.txt --engine gpu
"""

from __future__ import annotations

import argparse
import logging
import sys

from calitas_tpu.cli import _add_scoring_args, _Once, _parse_guide_file, _strict_bool
from calitas_tpu.core.scoring import Defaults
from calitas_tpu_torch.device import ENGINES

#: reference CLI flags whose features the port does not have yet, and the
#: ROADMAP item that brings each
_NOT_PORTED = {
    "checkpoint": "--checkpoint: ROADMAP Queue 1 item 11",
    "process_index": "--process-index: ROADMAP Queue 1 item 11",
    "process_count": "--process-count: ROADMAP Queue 1 item 11",
    "distributed": "--distributed: ROADMAP Queue 1 item 9",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="calitas-tpu-torch",
        description="CRISPR off-target search (CALITAS-compatible), "
                    "PyTorch/CUDA port.",
    )
    from calitas_tpu.version import aligner_version

    parser.add_argument(
        "--version", action="version",
        version=f"calitas-tpu-torch {aligner_version()}",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    sr = sub.add_parser(
        "SearchReference",
        help="Searches a reference sequence for alignments of a guide+PAM.",
    )
    sr.add_argument("-i", "--guide", default=None, action=_Once,
                    help="Guide with PAM, PAM must be lower case.")
    sr.add_argument("-I", "--guide-id", default=None, action=_Once,
                    help="ID of the guide.")
    sr.add_argument("--guide-file", default=None,
                    help="TSV of guides (columns: guide_id, guide, optional "
                         "aux_pams comma-separated) searched in one pass. "
                         "Mutually exclusive with --guide/--guide-id.")
    sr.add_argument("-x", "--auxiliary-pams", nargs="*", default=[],
                    help="Additional PAM sequences. Must be lower case.")
    sr.add_argument("-r", "--ref", required=True, help="Reference genome fasta.")
    sr.add_argument("-v", "--variants", default=None,
                    help="Optional VCF of variants to search in addition to "
                         "the reference.")
    sr.add_argument("-V", "--max-variants", type=int,
                    default=Defaults.MAX_VARIANTS_IN_CLUSTER,
                    help="Exclude clusters of more than this many variants.")
    sr.add_argument("-o", "--output", default=None, help="Output file to write.")
    sr.add_argument("-t", "--threads", type=int, default=8)
    sr.add_argument("-w", "--window-size", type=int, default=1000)
    sr.add_argument("-d", "--max-guide-diffs", type=int, default=Defaults.MAX_GUIDE_DIFFS)
    sr.add_argument("-p", "--max-pam-mismatches", type=int, default=Defaults.MAX_PAM_MISMATCHES)
    sr.add_argument("-g", "--max-gaps-between-guide-and-pam", type=int,
                    default=Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM)
    sr.add_argument("-D", "--max-total-diffs", type=int, default=None)
    sr.add_argument("-O", "--max-overlap", type=int, default=Defaults.MAX_OVERLAP)
    _add_scoring_args(sr)
    sr.add_argument("-c", "--chrom", default=None,
                    help="Examine only the named chromosome.")
    sr.add_argument("--engine", choices=ENGINES, default="auto",
                    help="Execution engine (auto: gpu when CUDA is available).")
    _add_device_arg(sr)
    sr.add_argument("--profile-dir", default=None,
                    help="Write a torch.profiler trace of the run to this "
                         "directory.")
    sr.add_argument("--checkpoint", default=None, help="Not ported yet.")
    sr.add_argument("--process-index", type=int, default=None,
                    help="Not ported yet.")
    sr.add_argument("--process-count", type=int, default=None,
                    help="Not ported yet.")
    sr.add_argument("--distributed", action="store_true", help="Not ported yet.")

    ar = sub.add_parser(
        "AlignToReference",
        help="Glocal alignment of query sequences to windows on the reference.",
    )
    ar.add_argument("-i", "--input", required=True,
                    help="Input file of sequence queries and approximate positions.")
    ar.add_argument("-r", "--ref", required=True,
                    help="Reference genome fasta, must be indexed with faidx.")
    ar.add_argument("-o", "--output", default=None)
    ar.add_argument("-w", "--window-size", type=int, default=None)
    ar.add_argument("-d", "--max-guide-diffs", type=int, default=None)
    ar.add_argument("-p", "--max-pam-mismatches", type=int, default=None)
    ar.add_argument("-g", "--max-gaps-between-guide-and-pam", type=int,
                    default=Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM)
    ar.add_argument("-D", "--max-total-diffs", type=int, default=None)
    ar.add_argument("-O", "--max-overlap", type=int, default=None)
    _add_scoring_args(ar)
    ar.add_argument("-t", "--threads", type=int, default=8)
    ar.add_argument("--engine", choices=ENGINES, default="auto",
                    help="Execution engine (auto: host below 1000 loci or "
                         "with the native library, else gpu when CUDA is "
                         "available; output-identical).")
    _add_device_arg(ar)

    pw = sub.add_parser(
        "PairwiseAlignSequences", help="Performs pairwise alignment of sequences."
    )
    pw.add_argument("-i", "--input", required=True, help="Input file of sequence pairs.")
    pw.add_argument("-o", "--output", default=None)
    pw.add_argument("-t", "--threads", type=int, default=8)
    pw.add_argument("-g", "--max-gaps-between-guide-and-pam", type=int,
                    default=Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM)
    pw.add_argument("-O", "--max-overlap", type=int, default=Defaults.MAX_OVERLAP)
    _add_scoring_args(pw)
    pw.add_argument("--engine", choices=ENGINES, default="auto",
                    help="Execution engine (auto: host below 1000 pairs or "
                         "with the native library, else gpu when CUDA is "
                         "available; output-identical).")
    _add_device_arg(pw)

    pv = sub.add_parser("PrepareVcf",
                        help="Prepares a VCF for optimal use by SearchReference.")
    pv.add_argument("-i", "--input", nargs="+", required=True,
                    help="One or more input VCFs")
    pv.add_argument("-o", "--output", required=True, help="The output VCF to create.")
    pv.add_argument("-f", "--min-af", type=float, default=0.01,
                    help="The minimum allele frequency of variants to retain.")
    pv.add_argument("-d", "--dict", dest="dict_path", default=None,
                    help="An optional sequence dictionary to use to override contig lines.")
    pv.add_argument("-c", "--add-chr-prefix", type=_strict_bool,
                    default=True, help="If true, add 'chr' to chroms 1-22, X and Y.")
    return parser


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device of the gpu engine (default cuda; cpu "
                        "runs the screen's plain PyTorch version).")


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    args = build_parser().parse_args(argv)
    run = {
        "SearchReference": _search_reference,
        "AlignToReference": _align_to_reference,
        "PairwiseAlignSequences": _pairwise,
        "PrepareVcf": _prepare_vcf,
    }[args.command]
    try:
        return run(args)
    except (FileNotFoundError, ValueError, KeyError) as ex:
        print(f"error: {ex}", file=sys.stderr)
        return 1


def _search_reference(args) -> int:
    from calitas_tpu_torch.tools import search_reference

    for dest, what in _NOT_PORTED.items():
        value = getattr(args, dest)
        if value is not None and value is not False:
            raise NotImplementedError(what)
    guide_specs = None
    if args.guide_file is not None:
        if args.guide is not None or args.guide_id is not None:
            raise SystemExit("--guide-file is mutually exclusive with --guide/--guide-id")
        if args.auxiliary_pams:
            raise SystemExit(
                "-x/--auxiliary-pams cannot be combined with --guide-file "
                "(use the file's aux_pams column)"
            )
        guide_specs = _parse_guide_file(args.guide_file)
    elif args.guide is None or args.guide_id is None:
        raise SystemExit("Provide --guide and --guide-id, or --guide-file")

    search_reference.run(
        guide=args.guide,
        guide_id=args.guide_id,
        ref=args.ref,
        auxiliary_pams=args.auxiliary_pams,
        guide_specs=guide_specs,
        variants=args.variants,
        max_variants=args.max_variants,
        output=args.output,
        threads=args.threads,
        window_size=args.window_size,
        max_guide_diffs=args.max_guide_diffs,
        max_pam_mismatches=args.max_pam_mismatches,
        max_gaps_between_guide_and_pam=args.max_gaps_between_guide_and_pam,
        max_total_diffs=args.max_total_diffs,
        max_overlap=args.max_overlap,
        guide_mismatch_net_cost=args.guide_mismatch_net_cost,
        pam_mismatch_net_cost=args.pam_mismatch_net_cost,
        genome_gap_net_cost=args.genome_gap_net_cost,
        guide_gap_net_cost=args.guide_gap_net_cost,
        chrom=args.chrom,
        engine=args.engine,
        device=args.device,
        profile_dir=args.profile_dir,
    )
    return 0


def _align_to_reference(args) -> int:
    from calitas_tpu_torch.tools import align_to_reference

    align_to_reference.run(
        input=args.input,
        ref=args.ref,
        output=args.output,
        window_size=args.window_size,
        max_guide_diffs=args.max_guide_diffs,
        max_pam_mismatches=args.max_pam_mismatches,
        max_gaps_between_guide_and_pam=args.max_gaps_between_guide_and_pam,
        max_total_diffs=args.max_total_diffs,
        max_overlap=args.max_overlap,
        guide_mismatch_net_cost=args.guide_mismatch_net_cost,
        pam_mismatch_net_cost=args.pam_mismatch_net_cost,
        genome_gap_net_cost=args.genome_gap_net_cost,
        guide_gap_net_cost=args.guide_gap_net_cost,
        threads=args.threads,
        engine=args.engine,
        device=args.device,
    )
    return 0


def _pairwise(args) -> int:
    from calitas_tpu_torch.tools import pairwise

    pairwise.run(
        input=args.input,
        output=args.output,
        threads=args.threads,
        max_gaps_between_guide_and_pam=args.max_gaps_between_guide_and_pam,
        max_overlap=args.max_overlap,
        guide_mismatch_net_cost=args.guide_mismatch_net_cost,
        pam_mismatch_net_cost=args.pam_mismatch_net_cost,
        genome_gap_net_cost=args.genome_gap_net_cost,
        guide_gap_net_cost=args.guide_gap_net_cost,
        engine=args.engine,
        device=args.device,
    )
    return 0


def _prepare_vcf(args) -> int:
    from calitas_tpu.tools import prepare_vcf

    prepare_vcf.run(
        input=args.input,
        output=args.output,
        min_af=args.min_af,
        dict_path=args.dict_path,
        add_chr_prefix=args.add_chr_prefix,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
