"""Checkpoint and resume in the port (``calitas_tpu_torch/search/checkpoint.py``
wired into ``tools/search_reference.py::run``), mirroring the checkpoint
tests of ``tests/test_e2e_extras.py``.  Every run goes through the gpu
engine on ``device="cpu"`` (the screens' plain PyTorch versions) and the
host engine, and its table must equal the JAX package's host-engine table
with ``time_stamp`` and ``aligner_version`` blanked."""

from __future__ import annotations

import json

import pytest

from calitas_tpu.io.fasta import ReferenceSetBuilder
from calitas_tpu.tools import search_reference as jax_sr
from calitas_tpu_torch.io import vcf as port_vcf
from calitas_tpu_torch.search.checkpoint import CheckpointState
from calitas_tpu_torch.tools import search_reference as port_sr
from tests.vcf_util import VcfBuilder

GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"
ENGINES = [dict(engine="gpu", device="cpu"), dict(engine="host")]
ENGINE_IDS = ["gpu-on-cpu", "host"]


def blank(path) -> list:
    lines = open(path).read().splitlines()
    hdr = lines[0].split("\t")
    varying = {hdr.index("time_stamp"), hdr.index("aligner_version")}
    return [
        tuple("" if i in varying else c for i, c in enumerate(line.split("\t")))
        for line in lines
    ]


def jax_host_table(tmp_path, **kw) -> list:
    out = tmp_path / "jax_host.txt"
    jax_sr.run(output=out, engine="host", threads=1, **kw)
    return blank(out)


def two_contigs(tmp_path, assembly, c1, c2, sep=("AAGG", "GGTT", "CCAA", "TTGG"), n=100):
    b = ReferenceSetBuilder(assembly=assembly)
    b.add("c1").add(sep[0] * n).add(c1).add(sep[1] * n)
    b.add("c2").add(sep[2] * n).add(c2).add(sep[3] * n)
    return b.to_file(tmp_path / "ref.fa")


@pytest.mark.parametrize("engine", ENGINES, ids=ENGINE_IDS)
def test_resume_produces_identical_table(tmp_path, monkeypatch, engine):
    ref = two_contigs(tmp_path, "ck", "CTTGCCCCACAGGGCAGTAATGG",
                      "CTTGCCCCACAGGGCAGTAACGG")
    want = jax_host_table(tmp_path, guide=GUIDE, guide_id="g", ref=ref)

    # A run that crashes right after checkpointing c1 ...
    ck = tmp_path / "state.jsonl"
    orig_record = CheckpointState.record

    def bomb(self, chrom, hits):
        orig_record(self, chrom, hits)
        if chrom == "c1":
            raise RuntimeError("simulated crash")

    monkeypatch.setattr(CheckpointState, "record", bomb)
    with pytest.raises(RuntimeError, match="simulated crash"):
        port_sr.run(guide=GUIDE, guide_id="g", ref=ref, threads=1,
                    output=tmp_path / "part.txt", checkpoint=ck, **engine)
    monkeypatch.setattr(CheckpointState, "record", orig_record)
    started = [json.loads(line) for line in ck.read_text().splitlines()]
    assert [r.get("chrom") for r in started] == [None, "c1"]

    # ... resumes with c2 only, into the uninterrupted run's table.
    out = tmp_path / "resumed.txt"
    port_sr.run(guide=GUIDE, guide_id="g", ref=ref, threads=1, output=out,
                checkpoint=ck, **engine)
    assert blank(out) == want
    assert len(want) >= 3
    assert CheckpointState.open(ck, started[0]["meta"]["fingerprint"]).done == {"c1", "c2"}


def test_fingerprint_mismatch_rejected(tmp_path):
    ck = tmp_path / "s.jsonl"
    s = CheckpointState.open(ck, "fp1")
    s.set_timestamp("t")
    s.record("c1", [])
    s.close()
    with pytest.raises(ValueError):
        CheckpointState.open(ck, "fp2")


@pytest.mark.parametrize("engine", ENGINES, ids=ENGINE_IDS)
def test_checkpoint_multi_guide_with_variants(tmp_path, engine):
    """Checkpoint and resume of a multi-guide run with a VCF pass."""
    ref = two_contigs(tmp_path, "ckmg", "CTTGCCCCACAGGGCAGTAATGG",
                      "GGCCTTAAGGCCTTAAGGCCAGG", sep=("AT", "GC", "TA", "CG"),
                      n=200)
    vcf = VcfBuilder()
    vcf.add("c1", 410, "snp1", ["T", "G"], info={"AF": "0.4"})
    vcf_path = vcf.to_file(tmp_path / "v.vcf")
    specs = [
        ("g1", "CTTGCCCCACAGGGCAGTAAnrg", ()),
        ("g2", "GGCCTTAAGGCCTTAAGGCCnrg", ()),
    ]
    want = jax_host_table(tmp_path, ref=ref, guide_specs=specs, variants=vcf_path)

    ck = tmp_path / "state.jsonl"
    for name in ("ck1.txt", "ck2.txt"):  # the second resumes a completed state
        port_sr.run(ref=ref, output=tmp_path / name, guide_specs=specs,
                    variants=vcf_path, checkpoint=ck, threads=1, **engine)
        assert blank(tmp_path / name) == want
    assert any(row[0] == "g2" for row in want[1:])
    assert any("snp1" in "\t".join(row) for row in want[1:])


@pytest.mark.parametrize("engine", ENGINES, ids=ENGINE_IDS)
def test_vcf_parsed_once_per_run(tmp_path, monkeypatch, engine):
    """A multi-guide, checkpointed run reads the VCF exactly once."""
    ref = two_contigs(tmp_path, "once", "CTTGCCCCACAGGGCAGTAATGG",
                      "GGCCTTAAGGCCTTAAGGCCAGG", sep=("AT", "GC", "TA", "CG"),
                      n=150)
    vcf = VcfBuilder()
    vcf.add("c1", 310, "s1", ["T", "G"], info={"AF": "0.4"})
    vcf_path = vcf.to_file(tmp_path / "v.vcf")

    opens = []
    orig = port_vcf.VcfReader.__init__

    def counting(self, path):
        opens.append(str(path))
        orig(self, path)

    monkeypatch.setattr(port_vcf.VcfReader, "__init__", counting)
    port_sr.run(
        ref=ref, output=tmp_path / "o.txt",
        guide_specs=[("g1", "CTTGCCCCACAGGGCAGTAAnrg", ()),
                     ("g2", "GGCCTTAAGGCCTTAAGGCCnrg", ())],
        variants=vcf_path, checkpoint=tmp_path / "ck.jsonl", threads=1,
        **engine,
    )
    assert opens.count(str(vcf_path)) == 1, opens


@pytest.mark.parametrize("engine", ENGINES, ids=ENGINE_IDS)
def test_checkpoint_refuses_changed_inputs(tmp_path, engine):
    """The fingerprint covers every input that shapes the table: resuming
    with another VCF, a chrom restriction or other aux PAMs is refused."""
    ref = two_contigs(tmp_path, "ckfp", "CTTGCCCCACAGGGCAGTAATGG",
                      "CTTGCCCCACAGGGCAGTAACGG", sep=("AT", "GC", "TA", "CG"),
                      n=200)
    vcf1 = VcfBuilder()
    vcf1.add("c1", 410, "snp1", ["T", "G"], info={"AF": "0.4"})
    v1 = vcf1.to_file(tmp_path / "v1.vcf")
    vcf2 = VcfBuilder()
    vcf2.add("c1", 420, "snp2", ["A", "C"], info={"AF": "0.4"})
    v2 = vcf2.to_file(tmp_path / "v2.vcf")
    want = jax_host_table(tmp_path, guide=GUIDE, guide_id="g", ref=ref, variants=v1)

    ck = tmp_path / "state.jsonl"
    common = dict(guide=GUIDE, guide_id="g", ref=ref, checkpoint=ck, threads=1,
                  **engine)
    port_sr.run(output=tmp_path / "o1.txt", variants=v1, **common)
    # same inputs: the resume (every contig done) is fine
    port_sr.run(output=tmp_path / "o2.txt", variants=v1, **common)
    assert blank(tmp_path / "o1.txt") == want == blank(tmp_path / "o2.txt")
    for kw in (
        {"variants": v2},
        {"variants": v1, "chrom": "c1"},
        {"variants": v1, "auxiliary_pams": ("nag",)},
    ):
        with pytest.raises(ValueError, match="refusing to resume"):
            port_sr.run(output=tmp_path / "oX.txt", **common, **kw)


def test_checkpoint_torn_tail_truncated_and_resumable(tmp_path):
    """A crash mid-write tears the last line; open() truncates it and the
    run resumes."""
    ck = tmp_path / "s.jsonl"
    s = CheckpointState.open(ck, "fp")
    s.set_timestamp("t0")
    s.record("c1", [])
    s.close()
    with open(ck, "a") as fh:
        fh.write('{"chrom": "c2", "hits": [{"l": "truncat')  # torn line
    s2 = CheckpointState.open(ck, "fp")
    assert s2.timestamp == "t0"
    assert s2.is_done("c1") and not s2.is_done("c2")
    s2.record("c2", [])  # the torn bytes are gone; a record appends cleanly
    s2.close()
    s3 = CheckpointState.open(ck, "fp")
    assert s3.is_done("c2")
    s3.close()


def test_checkpoint_torn_tail_non_ascii_byte_exact(tmp_path):
    """The truncation offset counts bytes, not characters."""
    ck = tmp_path / "u.jsonl"
    meta = json.dumps({"meta": {"fingerprint": "fp", "timestamp": "t0"}})
    rec = json.dumps({"chrom": "chrß", "hits": []}, ensure_ascii=False)
    with open(ck, "wb") as fh:
        fh.write(meta.encode() + b"\n")
        fh.write(rec.encode("utf-8") + b"\n")
        fh.write(b'{"chrom": "c2", "hits": [{"l": "tor')  # torn tail
    s = CheckpointState.open(ck, "fp")
    assert s.is_done("chrß") and not s.is_done("c2")
    s.close()
    assert ck.read_bytes() == meta.encode() + b"\n" + rec.encode("utf-8") + b"\n"
