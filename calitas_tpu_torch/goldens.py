"""Inputs of the golden configurations 1, 2, 3, 4 and 5s.

The port's counterpart of ``benchmarks/run_configs.py``: the same
synthetic genomes from the same seeds, the same guides, pairs, loci and
VCF, written under the same file names, so a run of the port's CLI on
them must give the tables in ``benchmarks/golden/`` (with the run-varying
``time_stamp`` and ``aligner_version`` columns blanked).  Each config
function writes its inputs into ``out`` (a reference already built there
is reused) and returns the CLI arguments of its run, without ``-o`` and
``--engine``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from calitas_tpu_torch.core.sequence import revcomp
from calitas_tpu_torch.io.fasta import ReferenceSetBuilder

GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"
PROTO = "CTTGCCCCACAGGGCAGTAA"

#: golden table of each config, under benchmarks/golden/
GOLDEN = {
    "1": "config1.txt",
    "2": "config2.txt",
    "3": "config3.txt.gz",
    "4": "config4.txt",
    "5s": "config5s.txt.gz",
}


def synth_genome(n: int, seed: int, plant: int = 40) -> str:
    """``n`` random ACGT bases with ``plant`` copies of the guide's
    protospacer, each mutated 0-4 times, followed by a PAM and put on
    either strand at random."""
    rng = np.random.default_rng(seed)
    arr = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)]
    for _ in range(plant):
        pos = int(rng.integers(100, n - 100))
        site = list(PROTO)
        for _ in range(int(rng.integers(0, 5))):
            i = int(rng.integers(0, len(site)))
            site[i] = rng.choice([c for c in "ACGT" if c != site[i]])
        seq = "".join(site) + rng.choice(["TGG", "AAG", "CGG"])
        if rng.random() < 0.5:
            seq = revcomp(seq)
        arr[pos : pos + len(seq)] = np.frombuffer(seq.encode(), dtype=np.uint8)
    return arr.tobytes().decode("ascii")


def build_ref(out: Path, n: int, seed: int, name: str) -> Path:
    """``out/name.fa`` (with .fai and .dict): one contig ``chr21`` of
    :func:`synth_genome` ``(n, seed)``; an existing file is reused."""
    path = Path(out) / f"{name}.fa"
    if path.exists():
        return path
    b = ReferenceSetBuilder(assembly=name)
    b.add("chr21").add(synth_genome(n, seed))
    return b.to_file(path)


def config1(out: Path) -> list:
    """PairwiseAlignSequences: the guide against 100 short targets, each
    holding a copy of its site mutated 0-3 times."""
    rng = np.random.default_rng(1)
    inp = Path(out) / "pairs.txt"
    with open(inp, "w") as fh:
        for _ in range(100):
            t = list("".join(rng.choice(list("ACGT"), 60)))
            pos = int(rng.integers(0, 60 - 24))
            site = list(PROTO + "TGG")
            for _ in range(int(rng.integers(0, 4))):
                i = int(rng.integers(0, len(site)))
                site[i] = rng.choice(list("ACGT"))
            t[pos : pos + len(site)] = site
            fh.write(f"{GUIDE}\t{''.join(t)}\n")
    return ["PairwiseAlignSequences", "-i", str(inp)]


def config2(out: Path) -> list:
    """AlignToReference, best mode, ``-w 60``: 200 random loci of a 2 Mb
    contig."""
    ref = build_ref(out, 2_000_000, 2, "c2ref")
    rng = np.random.default_rng(2)
    inp = Path(out) / "loci.txt"
    with open(inp, "w") as fh:
        fh.write("id\tquery\tchrom\tposition\n")
        for i in range(200):
            fh.write(f"{i}\t{GUIDE}\tchr21\t{int(rng.integers(100, 1_999_900))}\n")
    return ["AlignToReference", "-i", str(inp), "-r", str(ref), "-w", "60"]


def config3(out: Path) -> list:
    """SearchReference on a chr21-scale contig (40 Mb; chr21 is ~46 Mb)."""
    ref = build_ref(out, 40_000_000, 3, "c3chr21")
    return ["SearchReference", "-i", GUIDE, "-I", "bench", "-r", str(ref),
            "-d", "5", "-p", "1"]


def config4_vcf(out: Path, n: int = 5_000_000) -> Path:
    """Config 4's raw VCF: 2,000 random SNVs with allele frequencies in
    [0.01, 0.5) over ``chr21``."""
    rng = np.random.default_rng(4)
    raw_vcf = Path(out) / "raw.vcf"
    with open(raw_vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=AF,Number=A,Type=Float,Description="AF">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for pos in sorted(rng.integers(1000, n - 1000, size=2000)):
            ref_b = rng.choice(list("ACGT"))
            alt = rng.choice([c for c in "ACGT" if c != ref_b])
            af = float(rng.uniform(0.01, 0.5))
            fh.write(f"chr21\t{pos}\trs{pos}\t{ref_b}\t{alt}\t50\tPASS\tAF={af:.3f}\n")
    return raw_vcf


def config4(out: Path) -> list:
    """SearchReference with variants: a 5 Mb contig and config 4's VCF
    through PrepareVcf."""
    from calitas_tpu_torch.tools import prepare_vcf

    n = 5_000_000
    ref = build_ref(out, n, 4, "c4chr21")
    prepared = Path(out) / "prepared.vcf"
    prepare_vcf.run(input=[config4_vcf(out, n)], output=prepared,
                    add_chr_prefix=False)
    return ["SearchReference", "-i", GUIDE, "-I", "bench", "-r", str(ref),
            "-v", str(prepared)]


def config5s_guides() -> list:
    """Config 5s's guides ``[(id, guide)]``: the guide and three random
    20-base ``nrg`` guides."""
    rng = np.random.default_rng(5)
    guides = [("g%d" % i, "".join(rng.choice(list("ACGT"), 20)) + "nrg")
              for i in range(4)]
    guides[0] = ("g0", GUIDE)
    return guides


def config5s(out: Path) -> list:
    """Multi-guide SearchReference: config 5s's four guides over a 10 Mb
    contig, as a guide file."""
    ref = build_ref(out, 10_000_000, 5, "c5ref")
    gfile = Path(out) / "config5s_guides.tsv"
    gfile.write_text("guide_id\tguide\n" + "".join(
        f"{i}\t{g}\n" for i, g in config5s_guides()))
    return ["SearchReference", "--guide-file", str(gfile), "-r", str(ref)]


CONFIGS = {"1": config1, "2": config2, "3": config3, "4": config4, "5s": config5s}
