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


def test_unported_features_raise(tmp_path):
    guide, ref = _reference(tmp_path, 4, "3prime", n=5_000)
    for flag in (["--checkpoint", "c"], ["--process-index", "0"],
                 ["--distributed"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.main(["SearchReference", "-i", guide, "-I", "g", "-r", str(ref),
                      *flag])


def test_profile_dir_writes_a_trace(tmp_path):
    guide, ref = _reference(tmp_path, 5, "3prime", n=5_000)
    port_sr.run(guide=guide, guide_id="g", ref=ref, output=tmp_path / "p.txt",
                engine="gpu", device="cpu", threads=1,
                profile_dir=str(tmp_path / "prof"))
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
