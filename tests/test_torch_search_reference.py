"""End-to-end differential: the port's SearchReference (gpu engine, run
here on the CPU through the screen's plain PyTorch version) must write
tables identical, modulo time_stamp, to the JAX package's host engine."""

import numpy as np
import pytest
import torch

from calitas_tpu.core.sequence import revcomp
from calitas_tpu.io.fasta import ReferenceSetBuilder
from calitas_tpu.tools import search_reference as jax_sr
from calitas_tpu_torch import cli
from calitas_tpu_torch.device import resolve_device, resolve_engine
from calitas_tpu_torch.tools import search_reference as port_sr


def table_without_timestamp(path):
    rows = []
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        ts = header.index("time_stamp")
        for line in fh:
            f = line.rstrip("\n").split("\t")
            f[ts] = ""
            rows.append(tuple(f))
    return rows


def _guide_and_site(rng, kind):
    proto = "".join(rng.choice(list("ACGT"), 20))
    if kind == "3prime":
        return proto + "nrg", proto, ["TGG", "GAG", "CGG"], "after"
    if kind == "5prime":
        return "tttv" + proto, proto, ["TTTA", "TTTG", "ATTC"], "before"
    return proto, proto, [""], "after"  # PAM-less, all upper case


def _reference(tmp_path, seed, kind, n=120_000):
    """A random genome with mutated guide sites planted on both strands."""
    rng = np.random.default_rng(seed)
    guide, proto, pams, side = _guide_and_site(rng, kind)
    genome = list("".join(rng.choice(list("ACGT"), n)))
    for _ in range(8):
        pos = int(rng.integers(100, n - 2_000))
        site = list(proto)
        for _ in range(int(rng.integers(0, 5))):
            i = int(rng.integers(0, len(site)))
            site[i] = rng.choice([c for c in "ACGT" if c != site[i]])
        pam = rng.choice(pams)
        seq = "".join(site) + pam if side == "after" else pam + "".join(site)
        if rng.random() < 0.5:
            seq = revcomp(seq)
        genome[pos : pos + len(seq)] = list(seq)
    b = ReferenceSetBuilder(assembly=f"fuzz{seed}{kind}")
    b.add("chr1").add("".join(genome))
    return guide, b.to_file(tmp_path / "ref.fa")


@pytest.mark.parametrize("kind", ["3prime", "5prime", "pamless"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gpu_engine_matches_jax_host_engine(tmp_path, seed, kind):
    guide, ref = _reference(tmp_path, seed, kind)
    port_sr.run(guide=guide, guide_id="g", ref=ref, output=tmp_path / "p.txt",
                engine="gpu", device="cpu", threads=1)
    jax_sr.run(guide=guide, guide_id="g", ref=ref, output=tmp_path / "h.txt",
               engine="host", threads=1)
    port_rows = table_without_timestamp(tmp_path / "p.txt")
    assert port_rows == table_without_timestamp(tmp_path / "h.txt")
    assert len(port_rows) > 0  # planted sites must be found


def test_multi_guide_and_cli_match_jax(tmp_path):
    """A guide file of two guides with different PAM specs (two screen
    groups of one guide each) through the port's CLI equals the JAX
    package's host engine on the same file."""
    guide, ref = _reference(tmp_path, 3, "3prime", n=60_000)
    gfile = tmp_path / "guides.tsv"
    gfile.write_text(
        "guide_id\tguide\taux_pams\n"
        f"g1\t{guide}\t\n"
        "g2\tGACGCATAAAGATGAGACGCngg\tnag\n"
    )
    common = ["-r", str(ref), "--guide-file", str(gfile), "-t", "1", "-w", "500"]
    assert cli.main(["SearchReference", *common, "-o", str(tmp_path / "p.txt"),
                     "--engine", "gpu", "--device", "cpu"]) == 0
    from calitas_tpu import cli as jax_cli

    assert jax_cli.main(["SearchReference", *common, "-o",
                         str(tmp_path / "h.txt"), "--engine", "host"]) == 0
    rows = table_without_timestamp(tmp_path / "p.txt")
    assert rows == table_without_timestamp(tmp_path / "h.txt")
    assert {r[0] for r in rows} >= {"g1"}


def test_engine_resolution():
    assert resolve_engine("host") is None
    assert resolve_engine("gpu", "cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_engine("tpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        assert resolve_engine("auto") is None
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_engine("gpu")


def test_unported_features_raise(tmp_path, monkeypatch, capsys):
    """Nothing of the reference's CLI is left unported: the port's
    SearchReference takes every flag of the JAX package's, none is refused
    as not ported, and ``--distributed`` reaches torch.distributed, which
    needs its environment."""
    from calitas_tpu import cli as jax_cli

    def sub_flags(parser, command):
        sub = next(a for a in parser._actions if a.choices and command in a.choices)
        return {o: a.help for a in sub.choices[command]._actions for o in a.option_strings}

    port = sub_flags(cli.build_parser(), "SearchReference")
    assert set(sub_flags(jax_cli.build_parser(), "SearchReference")) <= set(port)
    assert not any("not ported" in (h or "").lower() for h in port.values())
    assert not hasattr(cli, "_NOT_PORTED")

    guide, ref = _reference(tmp_path, 4, "3prime", n=5_000)
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    out = tmp_path / "o.txt"
    assert cli.main(["SearchReference", "-i", guide, "-I", "g", "-r", str(ref),
                     "-o", str(out), "--engine", "host", "--distributed"]) == 1
    assert "env:// rendezvous" in capsys.readouterr().err
    assert not out.exists()


def test_profile_dir_writes_a_trace(tmp_path):
    """The trace holds the program's spans, which record for the run only."""
    import json

    from calitas_tpu_torch import spans

    guide, ref = _reference(tmp_path, 5, "3prime", n=5_000)
    port_sr.run(guide=guide, guide_id="g", ref=ref, output=tmp_path / "p.txt",
                engine="gpu", device="cpu", threads=1,
                profile_dir=str(tmp_path / "prof"))
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"calitas:request", "calitas:run", "calitas:contig"} <= names
    assert not spans.enabled()
    spans.drain()


@pytest.mark.parametrize("window,engine,noted", [
    (3000, "gpu", True), (2048, "gpu", False), (3000, "host", False),
])
def test_wide_window_note(tmp_path, caplog, window, engine, noted):
    """The reference's log note for --window-size > 2048 on the device
    engine (calitas_tpu/tools/search_reference.py:246-256); the table
    still equals the JAX host engine's."""
    guide, ref = _reference(tmp_path, 6, "3prime", n=20_000)
    with caplog.at_level("INFO", logger="calitas_tpu_torch.SearchReference"):
        port_sr.run(guide=guide, guide_id="g", ref=ref, output=tmp_path / "p.txt",
                    engine=engine, device="cpu", threads=1, window_size=window)
    notes = [r.getMessage() for r in caplog.records if "> 2048" in r.getMessage()]
    assert notes == ([f"--window-size {window} > 2048: end-column ranges use coarser "
                      "16-column blocks (slightly wider finish DP slices)."]
                     if noted else [])
    jax_sr.run(guide=guide, guide_id="g", ref=ref, output=tmp_path / "h.txt",
               engine="host", threads=1, window_size=window)
    assert table_without_timestamp(tmp_path / "p.txt") == table_without_timestamp(
        tmp_path / "h.txt")
