"""Multi-guide SearchReference on the port: guides of one shape (query
length, step, PAM spec) take the fused multi-guide screen, one dispatch
per group, and the table equals the JAX package's host engine and the
per-guide runs.  Run here on the gpu engine through the screen's plain
PyTorch version (``--device cpu``).  Mirrors tests/test_multi_guide.py."""

import numpy as np
import pytest

from calitas_tpu.io.fasta import ReferenceSetBuilder
from calitas_tpu.tools import search_reference as jax_sr
from calitas_tpu_torch import cli
from calitas_tpu_torch.ops import dp_screen as port_dp
from calitas_tpu_torch.ops.genome_screen import GenomeScreen
from calitas_tpu_torch.tools import search_reference as port_sr

from test_torch_search_reference import table_without_timestamp

# Same protospacer length (21) and PAM: one screen group of three.
SAME = [
    ("m1", "ACGTACATGCTCGATACGACGnr"),
    ("m2", "TTGACCAAGCAAAACAGACCAnr"),
    ("m3", "GGGGCCCCAAAATTTTACGTAnr"),
]
OTHER = ("o1", "TTGACCAAGCAAAACAGACCnrg")  # 20 bases: a group of its own


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.default_rng(66)
    b = ReferenceSetBuilder(assembly="tmg")
    c = b.add("chr1")
    c.add("".join(rng.choice(list("ACGT"), 3_000)))
    for _gid, g in SAME:
        c.add(g[:-2] + "AG")
        c.add("".join(rng.choice(list("ACGT"), 700)))
    c.add(g[:10] + "T" + g[11:-2] + "GG")  # one mismatch
    c.add("".join(rng.choice(list("ACGT"), 500)))
    c.add(OTHER[1][:-3] + "TGG")
    c.add("".join(rng.choice(list("ACGT"), 4_000)))
    return b.to_file(tmp_path_factory.mktemp("tmg") / "ref.fa")


class _Spy:
    """Counts calls of the two GenomeScreen dispatch methods."""

    def __init__(self, monkeypatch):
        self.calls = {"multi": [], "single": 0}
        multi = GenomeScreen.screen_contig_multi_async
        single = GenomeScreen.screen_contig_async

        def spy_multi(screen, genome, contig_len, step, dp_queries, *a, **k):
            self.calls["multi"].append(len(dp_queries))
            return multi(screen, genome, contig_len, step, dp_queries, *a, **k)

        def spy_single(screen, *a, **k):
            self.calls["single"] += 1
            return single(screen, *a, **k)

        monkeypatch.setattr(GenomeScreen, "screen_contig_multi_async", spy_multi)
        monkeypatch.setattr(GenomeScreen, "screen_contig_async", spy_single)


def test_same_length_guides_take_the_fused_screen(ref, tmp_path, monkeypatch):
    spy = _Spy(monkeypatch)
    specs = [(gid, g, ()) for gid, g in [*SAME, OTHER]]
    calls = port_dp.reference_calls["cpu"]
    port_sr.run(ref=ref, output=tmp_path / "p.txt", guide_specs=specs,
                engine="gpu", device="cpu", threads=1)
    # one fused dispatch for the group of three, one dual for the other
    assert spy.calls == {"multi": [3], "single": 1}
    assert port_dp.reference_calls["cpu"] == calls + 2  # one segment each
    jax_sr.run(ref=ref, output=tmp_path / "h.txt", guide_specs=specs,
               engine="host", threads=1)
    rows = table_without_timestamp(tmp_path / "p.txt")
    assert rows == table_without_timestamp(tmp_path / "h.txt")
    assert {r[0] for r in rows} == {"m1", "m2", "m3", "o1"}


def test_multi_guide_equals_individual_runs(ref, tmp_path):
    specs = [(gid, g, ()) for gid, g in SAME]
    port_sr.run(ref=ref, output=tmp_path / "multi.txt", guide_specs=specs,
                engine="gpu", device="cpu", threads=1)
    singles = []
    for gid, g in SAME:
        out = tmp_path / f"{gid}.txt"
        port_sr.run(guide=g, guide_id=gid, ref=ref, output=out, engine="gpu",
                    device="cpu", threads=1)
        singles.extend(table_without_timestamp(out))
    assert sorted(table_without_timestamp(tmp_path / "multi.txt")) == sorted(singles)


def test_guide_file_cli_fuses_and_matches_jax(ref, tmp_path, monkeypatch):
    spy = _Spy(monkeypatch)
    gf = tmp_path / "guides.tsv"
    gf.write_text("guide_id\tguide\n" + "".join(f"{i}\t{g}\n" for i, g in SAME))
    common = ["SearchReference", "--guide-file", str(gf), "-r", str(ref), "-t", "1"]
    assert cli.main([*common, "-o", str(tmp_path / "p.txt"), "--engine", "gpu",
                     "--device", "cpu", "-w", "300"]) == 0
    assert spy.calls == {"multi": [3], "single": 0}
    from calitas_tpu import cli as jax_cli

    assert jax_cli.main([*common, "-o", str(tmp_path / "h.txt"), "--engine",
                         "host", "-w", "300"]) == 0
    rows = table_without_timestamp(tmp_path / "p.txt")
    assert rows == table_without_timestamp(tmp_path / "h.txt")
    assert {r[0] for r in rows} == {"m1", "m2", "m3"}
