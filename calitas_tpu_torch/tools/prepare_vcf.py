"""PrepareVcf: VCF normalization for SearchReference.

Parity contract: PrepareVcf.scala (SURVEY.md §3.5): PASS + AF filtering,
simple alleles only, INFO reduced to AF, genotypes stripped, optional
contig-header override from a dictionary, optional 'chr' prefixing of
chromosomes 1-22/X/Y, multi-VCF merge.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Sequence

from calitas_tpu_torch.io.fasta import SequenceDictionary, extract_dictionary
from calitas_tpu_torch.io.vcf import (
    PASSING_FILTERS,
    VcfReader,
    VcfVariant,
    VcfWriter,
    format_af,
)
from calitas_tpu_torch.io.tsv import float32_widen

logger = logging.getLogger("calitas_tpu_torch.PrepareVcf")

CHROMS_TO_FIX = frozenset([str(i) for i in range(1, 23)] + ["X", "Y"])


def fix_chrom(chrom: str) -> str:
    """Prepend 'chr' to chromosome names that need it (PrepareVcf.scala:91)."""
    return f"chr{chrom}" if chrom in CHROMS_TO_FIX else chrom


def run(
    input: Sequence[str | Path],
    output: str | Path,
    min_af: float = 0.01,
    dict_path: Optional[str | Path] = None,
    add_chr_prefix: bool = True,
) -> None:
    # Build the output header from the first input VCF (PrepareVcf.scala:41-58).
    first = VcfReader(input[0])
    header = first.header.copy()
    first.close()

    if dict_path is not None:
        d = extract_dictionary(dict_path)
        header.replace_contigs([(e.name, e.length, e.assembly) for e in d])
        if d.entries and d.entries[0].assembly:
            header.set_general("reference", d.entries[0].assembly)
    header.samples = []  # drop samples

    out = VcfWriter(output, header)
    from calitas_tpu_torch.utils import ProgressLogger

    progress = ProgressLogger(logger, noun="variants", verb="wrote", unit=100_000)
    n = 0
    from calitas_tpu_torch.io.vcf import _SIMPLE_BASES

    simple = _SIMPLE_BASES
    for vcf_in in input:
        logger.info("Processing file %s", vcf_in)
        reader = VcfReader(vcf_in)
        # Streaming fast path: the filters only need FILTER / INFO.AF /
        # REF / ALT, so records are rejected from split fields without
        # building variant objects, and survivors are re-rendered
        # directly — behavior identical to filtering parsed records
        # (PrepareVcf.scala:63-81; VcfWriter renders the same columns).
        for line in reader.iter_lines():
            f = line.split("\t", 8)  # genotype columns stay unsplit
            if f[6] != "PASS" and frozenset(f[6].split(";")) != PASSING_FILTERS:
                continue
            info = f[7]
            raw_af = None
            if info != ".":
                for item in info.split(";"):
                    if item.startswith("AF="):
                        raw_af = item[3:]  # last occurrence wins
            if raw_af is None:
                continue
            # float32-widened compares: the reference filters Float AFs
            # against a Double minAf (PrepareVcf.scala:69,72), so Scala
            # widens each float32 — AF=0.01 vs --min-af 0.01 is DROPPED
            # (float32(0.01) = 0.00999999... < 0.01).
            afs = [float32_widen(x) for x in raw_af.split(",")]
            if not any(af >= min_af for af in afs):
                continue
            ref = f[3]
            alts = [a for a in f[4].split(",") if a != "."]
            if not (ref and all(c in simple for c in ref)) or not all(
                a and all(c in simple for c in a) for a in alts
            ):
                continue
            kept_alts = []
            kept_afs = []
            for alt, af in zip(alts, afs):
                if af >= min_af:
                    kept_alts.append(alt)
                    kept_afs.append(af)
            chrom = fix_chrom(f[0]) if add_chr_prefix else f[0]
            pos = int(f[1])
            out.write_line(
                f"{chrom}\t{pos}\t{f[2]}\t{ref}\t"
                f"{','.join(kept_alts) if kept_alts else '.'}\t{f[5]}\t"
                f"PASS\tAF={format_af(kept_afs)}\n"
            )
            progress.record(f[0], pos)
            n += 1
    out.close()
    logger.info("Wrote %d variants.", n)
