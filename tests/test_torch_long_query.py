"""Guides whose DP query is longer than the CUDA kernels take (Q > 48).

The port routes them as the reference does: the route is chosen before
any launch from the query length alone, the kernel for Q <= Q_MAX and the
plain PyTorch screen on the same device above it.  On the CPU the rule
itself and a search with a 50-base DP query are checked; on the card
(marked ``cuda``) the same search must give the ``--device cpu`` table
without launching a kernel for the long guide."""

import logging

import numpy as np
import pytest
import torch

from calitas_tpu.io.fasta import ReferenceSetBuilder
from calitas_tpu_torch import cli
from calitas_tpu_torch.ops import dp_cuda, dp_screen

PROTO50 = "GATTACAGGCTTGCCCCACAGGGCAGTAACTGACGTTAGCATCGGATCCA"
GUIDE50 = PROTO50 + "nrg"


def test_route_rule():
    assert len(PROTO50) == 50
    for q, want in [(1, True), (20, True), (48, True), (49, False), (50, False)]:
        assert dp_cuda.uses_kernel(q, "cuda") is want
        assert dp_cuda.uses_kernel(q, torch.device("cuda", 0)) is want
        assert dp_cuda.uses_kernel(q, "cpu") is False


def test_route_is_logged_with_the_length(caplog):
    with caplog.at_level(logging.INFO, logger="calitas_tpu_torch.screen"):
        assert dp_cuda.log_route("Screen of guides g", 50, "cuda") is False
        assert dp_cuda.log_route("Screen of guides h", 20, "cuda") is True
    msgs = [r.getMessage() for r in caplog.records]
    assert "50-base query" in msgs[0] and "plain PyTorch screen" in msgs[0]
    assert "20-base query" in msgs[1] and "CUDA kernel" in msgs[1]


def _reference(tmp_path, n=30_000):
    rng = np.random.default_rng(50)
    seq = list("".join(rng.choice(list("ACGT"), n)))
    for k, pos in enumerate((4_000, 17_000, 25_500)):
        site = list(PROTO50)
        for _ in range(k):  # 0, 1 and 2 mismatches
            i = int(rng.integers(0, 50))
            site[i] = "ACGT"[("ACGT".index(site[i]) + 1) % 4]
        seq[pos : pos + 53] = list("".join(site) + "TGG")
    b = ReferenceSetBuilder(assembly="long50")
    b.add("chr1").add("".join(seq))
    return b.to_file(tmp_path / "ref.fa")


def norm_rows(text: str) -> list:
    """Table rows with the run-varying time_stamp and aligner_version
    blanked, as tests/test_golden_configs.py does (kept here: on the
    card's machine the tests import nothing from other test modules)."""
    lines = text.splitlines()
    hdr = lines[0].split("\t")
    varying = {hdr.index(c) for c in ("time_stamp", "aligner_version")}
    return [tuple("" if i in varying else f for i, f in enumerate(line.split("\t")))
            for line in lines]


def _search(ref, out, *extra):
    rc = cli.main(["SearchReference", "-i", GUIDE50, "-I", "g50", "-r", str(ref),
                   "-o", str(out), "-t", "1", *extra])
    assert rc == 0
    return norm_rows(out.read_text())


def test_long_guide_search_on_the_plain_route_equals_host(tmp_path):
    ref = _reference(tmp_path)
    host = _search(ref, tmp_path / "host.txt", "--engine", "host")
    calls = dp_screen.reference_calls["cpu"]
    dev = _search(ref, tmp_path / "dev.txt", "--engine", "gpu", "--device", "cpu")
    assert dp_screen.reference_calls["cpu"] > calls
    assert dev == host
    assert len(host) >= 4  # header + the three planted sites


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_long_guide_search_on_the_card_equals_cpu(cuda, tmp_path, caplog):
    ref = _reference(tmp_path)
    want = _search(ref, tmp_path / "cpu.txt", "--engine", "gpu", "--device", "cpu")
    dp_cuda.reset_launches()
    dp_screen.reference_calls["cuda"] = 0
    with caplog.at_level(logging.INFO, logger="calitas_tpu_torch.screen"):
        got = _search(ref, tmp_path / "cuda.txt", "--engine", "gpu")
    assert got == want and len(got) >= 4
    assert dp_screen.reference_calls["cuda"] > 0
    assert dp_cuda.launches["screen_dual"] == 0
    assert any("50-base query" in r.getMessage() for r in caplog.records)


def test_callers_route_by_query_length(tmp_path, monkeypatch):
    """Every caller (single-guide and fused reference pass, variant pass)
    asks ``uses_kernel`` before any launch.  With the rule made true on
    the CPU for Q <= 48, the kernel wrappers see only the short guides;
    the 50-base guides take the plain screens, and the table equals the
    host engine's."""
    seen = []

    def spy(real):
        def wrapper(genome, qvals, *a, **kw):
            seen.append((real.__name__, np.asarray(qvals).shape[-1]))
            return real(genome, qvals, *a, **kw)
        return wrapper

    monkeypatch.setattr(dp_cuda, "uses_kernel", lambda q, device: q <= dp_cuda.Q_MAX)
    monkeypatch.setattr(dp_cuda, "screen_dual", spy(dp_cuda.screen_dual))
    monkeypatch.setattr(dp_cuda, "screen_multi", spy(dp_cuda.screen_multi))
    ref = _reference(tmp_path)
    other = "GATTACAGGATTACAGGATTACAGGATTACAGGATTACAGGATTACAGGT"
    guides = tmp_path / "guides.tsv"
    guides.write_text("guide_id\tguide\n"
                      f"a\t{GUIDE50}\nb\t{other}nrg\nc\tCTTGCCCCACAGGGCAGTAAnrg\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n"
                   "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                   "chr1\t4010\trs1\tA\tG\t50\tPASS\tAF=0.1\n")
    base = ["SearchReference", "--guide-file", str(guides), "-r", str(ref),
            "-v", str(vcf), "-t", "1"]
    assert cli.main([*base, "-o", str(tmp_path / "dev.txt"), "--engine", "gpu",
                     "--device", "cpu"]) == 0
    assert seen and all(q == 20 for _name, q in seen), seen
    assert {name for name, _q in seen} == {"screen_dual", "screen_multi"}
    assert cli.main([*base, "-o", str(tmp_path / "host.txt"), "--engine", "host"]) == 0
    want = norm_rows((tmp_path / "host.txt").read_text())
    assert norm_rows((tmp_path / "dev.txt").read_text()) == want and len(want) >= 4
