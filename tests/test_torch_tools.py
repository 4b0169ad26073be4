"""The port's list-driven tools through its command line: golden configs
1 (PairwiseAlignSequences) and 2 (AlignToReference) with ``--engine gpu
--device cpu`` (the plain pair screen) equal ``benchmarks/golden``, both
tools' gpu engine equals their host engine, the list tools' auto-engine
rule, and PrepareVcf through the port's CLI."""

from pathlib import Path

import numpy as np
import pytest
import torch

from calitas_tpu.core.sequence import revcomp
from calitas_tpu.io.fasta import ReferenceSetBuilder
from calitas_tpu_torch import cli
from calitas_tpu_torch.device import AUTO_DEVICE_MIN_TASKS, resolve_engine
from calitas_tpu_torch.ops import dp_screen
from tests.test_golden_configs import assert_matches_golden, configs  # noqa: F401
from tests.test_golden_configs import norm_rows

ROOT = Path(__file__).resolve().parent.parent
GPU_ON_CPU = ["--engine", "gpu", "--device", "cpu"]


def _cli(argv):
    assert cli.main([str(a) for a in argv]) == 0


def test_config1_pairwise_golden_through_the_port(configs, tmp_path, monkeypatch):  # noqa: F811
    """benchmarks/run_configs.py's config1 writes its input and calls the
    reference tool; the tool is swapped for the port's CLI."""
    from calitas_tpu.tools import pairwise

    monkeypatch.setattr(pairwise, "run", lambda input, output: _cli(
        ["PairwiseAlignSequences", "-i", input, "-o", output, *GPU_ON_CPU]))
    calls = dp_screen.reference_calls["cpu"]
    configs.config1()
    assert dp_screen.reference_calls["cpu"] > calls
    assert_matches_golden(tmp_path / "config1.txt", "config1.txt")


def test_config2_a2r_golden_through_the_port(configs, tmp_path, monkeypatch):  # noqa: F811
    from calitas_tpu.tools import align_to_reference

    monkeypatch.setattr(
        align_to_reference, "run",
        lambda input, ref, output, window_size: _cli(
            ["AlignToReference", "-i", input, "-r", ref, "-o", output,
             "-w", window_size, *GPU_ON_CPU]),
    )
    calls = dp_screen.reference_calls["cpu"]
    configs.config2()
    assert dp_screen.reference_calls["cpu"] > calls
    assert_matches_golden(tmp_path / "config2.txt", "config2.txt")


@pytest.fixture()
def a2r_ref(tmp_path):
    """A 60 kb contig with mutated sites of config 3's guide and of a
    24-base 5'-PAM guide, and loci near and far from them."""
    rng = np.random.default_rng(21)
    g3 = "CTTGCCCCACAGGGCAGTAA"
    p5 = "".join(rng.choice(list("ACGT"), 24))
    seq = list("".join(rng.choice(list("ACGT"), 60_000)))
    rows = ["id\tquery\tchrom\tposition"]
    for k in range(30):
        pos = 1_000 + k * 1_900
        five = k % 3 == 0
        site = list(p5 if five else g3)
        for _ in range(int(rng.integers(0, 4))):
            i = int(rng.integers(0, len(site)))
            site[i] = "ACGT"[("ACGT".index(site[i]) + 1) % 4]
        s = ("TTTA" + "".join(site)) if five else ("".join(site) + "TGG")
        if k % 2:
            s = revcomp(s)
        seq[pos : pos + len(s)] = list(s)
        query = ("tttv" + p5) if five else (g3 + "nrg")
        shift = int(rng.integers(-50, 51)) if k % 4 else 700  # some loci miss
        rows.append(f"l{k}\t{query}\tchr1\t{pos + shift}")
    b = ReferenceSetBuilder(assembly="a2rtools")
    b.add("chr1").add("".join(seq))
    ref = b.to_file(tmp_path / "ref.fa")
    loci = tmp_path / "loci.tsv"
    loci.write_text("\n".join(rows) + "\n")
    return ref, loci


@pytest.mark.parametrize(
    "limits", [[], ["-w", "200", "-d", "4", "-p", "1", "-O", "5"]],
    ids=["best", "all-hits"],
)
def test_a2r_gpu_engine_equals_host(tmp_path, a2r_ref, limits):
    ref, loci = a2r_ref
    base = ["AlignToReference", "-i", loci, "-r", ref, "-t", "1", *limits]
    _cli([*base, "-o", tmp_path / "host.txt", "--engine", "host"])
    _cli([*base, "-o", tmp_path / "gpu.txt", *GPU_ON_CPU])
    host = norm_rows((tmp_path / "host.txt").read_text())
    assert norm_rows((tmp_path / "gpu.txt").read_text()) == host
    assert len(host) > 10


def test_pairwise_gpu_engine_equals_host_with_competitive_rev(tmp_path):
    """Pairs whose two strands both hold a site (the rev pass competes)."""
    rng = np.random.default_rng(8)
    lines = []
    for i in range(30):
        proto = "".join(rng.choice(list("ACGT"), 20))
        q = ("tttv" + proto) if i % 2 else (proto + "nrg")
        other = list(proto)
        other[int(rng.integers(0, 20))] = "A"
        t = ("".join(rng.choice(list("ACGT"), 8)) + proto + "TGG"
             + "".join(rng.choice(list("ACGT"), 5)) + revcomp("".join(other) + "AGG"))
        lines.append(f"{q}\t{t}")
    inp = tmp_path / "pairs.txt"
    inp.write_text("\n".join(lines) + "\n")
    _cli(["PairwiseAlignSequences", "-i", inp, "-o", tmp_path / "host.txt",
          "--engine", "host"])
    _cli(["PairwiseAlignSequences", "-i", inp, "-o", tmp_path / "gpu.txt",
          *GPU_ON_CPU])
    host = (tmp_path / "host.txt").read_bytes()
    assert (tmp_path / "gpu.txt").read_bytes() == host
    assert len(host.splitlines()) == 31


def test_auto_rule_of_the_list_tools(monkeypatch):
    from calitas_tpu_torch import native

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(native, "available", lambda: False)
    big = AUTO_DEVICE_MIN_TASKS
    assert AUTO_DEVICE_MIN_TASKS == 1000
    kw = dict(prefer_host_when_native=True)
    assert resolve_engine("auto", "cpu", n_tasks=big - 1, **kw) is None
    assert resolve_engine("auto", "cpu", n_tasks=big, **kw) == torch.device("cpu")
    monkeypatch.setattr(native, "available", lambda: True)
    assert resolve_engine("auto", "cpu", n_tasks=big, **kw) is None
    # SearchReference passes neither: auto follows the card alone
    assert resolve_engine("auto", "cpu") == torch.device("cpu")
    # explicit engines ignore the rule
    assert resolve_engine("gpu", "cpu", n_tasks=1, **kw) == torch.device("cpu")
    assert resolve_engine("host", "cpu", n_tasks=10**6) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    assert resolve_engine("auto", "cpu", n_tasks=big, **kw) is None


def test_port_tools_own_their_engine_rule():
    for name in ("pairwise.py", "align_to_reference.py"):
        src = (ROOT / "calitas_tpu_torch" / "tools" / name).read_text()
        assert "_resolve_engine" not in src and "calitas_tpu.ops" not in src


def test_prepare_vcf_through_the_port(tmp_path):
    from calitas_tpu.tools import prepare_vcf

    vcf = tmp_path / "raw.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        '##INFO=<ID=AF,Number=A,Type=Float,Description="AF">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        "1\t100\trs1\tA\tG\t50\tPASS\tAF=0.2\n"
        "1\t200\trs2\tC\tT\t50\tPASS\tAF=0.001\n"
        "2\t300\trs3\tG\tGA\t50\tPASS\tAF=0.05\n"
    )
    _cli(["PrepareVcf", "-i", vcf, "-o", tmp_path / "port.vcf", "-f", "0.01"])
    prepare_vcf.run(input=[vcf], output=tmp_path / "ref.vcf", min_af=0.01)
    got = (tmp_path / "port.vcf").read_text()
    assert got == (tmp_path / "ref.vcf").read_text()
    assert "rs1" in got and "rs2" not in got
