"""The port's variant (VCF) pass against the JAX package: SearchReference
with ``-v`` on the gpu engine, run here through the plain PyTorch screen
(``--device cpu``), writes the table of the JAX host engine, variant rows
included; the slot screen's flagged windows cover the exact ones.
Mirrors tests/test_engine_differential.py's test_engines_identical_with_
variants."""

import numpy as np
import pytest

from calitas_tpu.align.engine import SequentialAligner
from calitas_tpu.core.guide import Guide
from calitas_tpu.core.sequence import revcomp
from calitas_tpu.io.fasta import IndexedFasta, ReferenceSetBuilder
from calitas_tpu.io.vcf import VcfIndex
from calitas_tpu.search.variants import variant_window_iterator
from calitas_tpu.tools import search_reference as jax_sr
from calitas_tpu_torch import cli
from calitas_tpu_torch.ops import dp_screen as port_dp
from calitas_tpu_torch.search import variants as port_variants
from calitas_tpu_torch.tools import search_reference as port_sr

from test_torch_search_reference import table_without_timestamp
from vcf_util import VcfBuilder


def _reference_and_vcf(tmp_path, seed, n=80_000, n_variants=300):
    """A random genome with mutated sites of two guides (20 and 22 bases)
    planted on both strands, and a VCF of SNPs, insertions and deletions,
    some of them inside the planted sites."""
    rng = np.random.default_rng(seed)
    protos = ["".join(rng.choice(list("ACGT"), k)) for k in (20, 22)]
    genome = list("".join(rng.choice(list("ACGT"), n)))
    sites = []
    for proto in protos:
        for _ in range(4):
            pos = int(rng.integers(100, n - 2_000))
            sites.append(pos + 1 + int(rng.integers(0, 20)))
            site = list(proto)
            for _ in range(int(rng.integers(0, 4))):
                i = int(rng.integers(0, len(site)))
                site[i] = rng.choice([c for c in "ACGT" if c != site[i]])
            seq = "".join(site) + rng.choice(["TGG", "GAG", "CGG"])
            if rng.random() < 0.5:
                seq = revcomp(seq)
            genome[pos : pos + len(seq)] = list(seq)
    gstr = "".join(genome)
    b = ReferenceSetBuilder(assembly=f"tvar{seed}")
    b.add("chr1").add(gstr)
    ref = b.to_file(tmp_path / "ref.fa")
    vb = VcfBuilder()
    positions = {int(p) for p in rng.integers(500, n - 500, size=n_variants)}
    for pos in sorted(positions | set(sites)):
        ref_b = gstr[pos - 1]
        kind = rng.random()
        if kind < 0.7:  # SNP
            alleles = (ref_b, rng.choice([c for c in "ACGT" if c != ref_b]))
        elif kind < 0.85:  # insertion
            ins = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 4))))
            alleles = (ref_b, ref_b + ins)
        else:  # deletion
            dlen = int(rng.integers(1, 4))
            alleles = (gstr[pos - 1 : pos + dlen], ref_b)
        vb.add(chrom="chr1", pos=pos, alleles=alleles, info={"AF": "0.25"})
    return protos, ref, vb.to_file(tmp_path / "v.vcf")


@pytest.mark.parametrize("seed", [7, 8])
def test_gpu_engine_with_variants_matches_jax_host_engine(tmp_path, seed):
    """Two guide lengths: two slot-screen groups over one upload."""
    protos, ref, vcf = _reference_and_vcf(tmp_path, seed)
    specs = [("ga", protos[0] + "nrg", ()), ("gb", protos[1] + "nrg", ())]
    calls = port_dp.reference_calls["cpu"]
    port_sr.run(ref=ref, variants=vcf, output=tmp_path / "p.txt",
                guide_specs=specs, engine="gpu", device="cpu", threads=1)
    assert port_dp.reference_calls["cpu"] > calls  # the device screen ran
    jax_sr.run(ref=ref, variants=vcf, output=tmp_path / "h.txt",
               guide_specs=specs, engine="host", threads=1)
    rows = table_without_timestamp(tmp_path / "p.txt")
    assert rows == table_without_timestamp(tmp_path / "h.txt")
    assert len(rows) > 0
    header = open(tmp_path / "p.txt").readline().rstrip("\n").split("\t")
    vcf_col = header.index("variant_vcf")
    assert any(r[vcf_col].startswith("v.vcf:") for r in rows)  # variant rows


def test_host_engine_with_variants_and_cli(tmp_path):
    """The port's host engine runs the reference package's host passes;
    ``-v`` on the port's CLI gives the same table."""
    protos, ref, vcf = _reference_and_vcf(tmp_path, 9, n=40_000, n_variants=150)
    guide = protos[0] + "nrg"
    common = ["SearchReference", "-i", guide, "-I", "g", "-r", str(ref),
              "-v", str(vcf), "-t", "1"]
    assert cli.main([*common, "-o", str(tmp_path / "c.txt"),
                     "--engine", "gpu", "--device", "cpu"]) == 0
    port_sr.run(guide=guide, guide_id="g", ref=ref, variants=vcf,
                output=tmp_path / "p.txt", engine="host", threads=1)
    jax_sr.run(guide=guide, guide_id="g", ref=ref, variants=vcf,
               output=tmp_path / "h.txt", engine="host", threads=1)
    want = table_without_timestamp(tmp_path / "h.txt")
    assert table_without_timestamp(tmp_path / "p.txt") == want
    assert table_without_timestamp(tmp_path / "c.txt") == want
    assert len(want) > 0


def test_screened_windows_cover_every_hit_window(tmp_path):
    """Every variant window in which the exact host aligner finds a hit is
    flagged by the slot screen, for each guide; with a slot narrower than
    some windows, those pass through flagged for every guide."""
    protos, ref, vcf = _reference_and_vcf(tmp_path, 10, n=30_000, n_variants=200)
    fasta = IndexedFasta(ref)
    index = VcfIndex(vcf)
    aligner = SequentialAligner()
    guides = [Guide.parse(p + "nrg") for p in protos]
    padding = max(g.length for g in guides) - 1 + 5 + 3
    specs = [(f"g{i}", g, aligner.min_guide_score(g, 5)) for i, g in enumerate(guides)]

    def windows(blocks):
        return variant_window_iterator(fasta, index, None, padding, 16, blocks=blocks)

    flagged = {
        (w.start, w.bases.tobytes()): keys
        for w, keys in port_variants.screened_variant_windows_multi(
            windows(True), aligner, specs, device="cpu", slot=96,
            batch_slots=256,
        )
    }
    all_windows = list(windows(False))
    assert len(all_windows) > 256  # several batches
    assert any(len(w.bases) > 96 for w in all_windows)
    n_hits = 0
    for w in all_windows:
        key = (w.start, w.bases.tobytes())
        if len(w.bases) > 96:
            assert flagged[key] == {"g0", "g1"}
            continue
        for gid, g, _ms in specs:
            hits = aligner.align(
                g, w.bases, max_guide_diffs=5, max_gaps_between_guide_and_pam=3,
                max_pam_diffs=1, max_total_diffs=9,
            )
            if hits:
                n_hits += 1
                assert gid in flagged.get(key, ())
    assert n_hits > 0
    single = list(port_variants.screened_variant_windows(
        windows(True), aligner, guides[0], specs[0][2], device="cpu", slot=96))
    assert {(w.start, w.bases.tobytes()) for w in single} == {
        k for k, keys in flagged.items() if "g0" in keys
    }
