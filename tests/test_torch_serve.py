"""Resident serving in the port (``calitas_tpu_torch/serve.py``): each
resident search's table equals a fresh run of the port and the JAX
package's host-engine table (``time_stamp`` and ``aligner_version``
blanked), the JSON line protocol answers as ``tests/test_serve.py``
expects of the JAX package's server, the resident arrays are staged
once and never written, and a contig whose staging fails is served from
the host, as the JAX package's server serves it.  The gpu engine
runs here on ``device="cpu"``: the screens' plain PyTorch versions."""

from __future__ import annotations

import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from calitas_tpu.io.fasta import ReferenceSetBuilder
from calitas_tpu.tools import search_reference as jax_sr
from calitas_tpu_torch import cli
from calitas_tpu_torch.ops.genome_screen import GenomeScreen
from calitas_tpu_torch.serve import ResidentSearcher, serve_stdio
from calitas_tpu_torch.tools import search_reference as port_sr

GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"
GUIDE2 = "ACGGATCGATTGCATGAAGGtgg"
GUIDE_5P = "tttv" + GUIDE[:20]  # the planted "TTTT" + protospacer: one PAM mismatch


def blank(text: str) -> list:
    """Table lines with the run-varying columns blanked."""
    lines = text.splitlines()
    hdr = lines[0].split("\t")
    varying = {hdr.index("time_stamp"), hdr.index("aligner_version")}
    return [
        "\t".join("" if i in varying else c for i, c in enumerate(line.split("\t")))
        for line in lines
    ]


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """tests/test_serve.py's genome: seed 29, two contigs with planted
    sites for both guides, a VCF of two SNVs."""
    tmp = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(29)
    b = ReferenceSetBuilder(assembly="serve")
    planted = "TTTT" + GUIDE[:20] + "TGG" + "CC" + GUIDE2[:20].lower()
    for name, n in (("chr1", 60000), ("chr2", 40000)):
        seq = "".join(rng.choice(list("ACGT"), n))
        seq = seq[:5000] + planted.upper() + seq[5000 + len(planted):]
        b.add(name).add(seq)
    ref = b.to_file(tmp / "ref.fa")
    vcf = tmp / "v.vcf"
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=AF,Number=A,Type=Float,Description="AF">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.write("chr1\t5007\trs1\tT\tG\t.\tPASS\tAF=0.3\n")
        fh.write("chr2\t9000\trs2\tA\tC\t.\tPASS\tAF=0.1\n")
    return ref, vcf


def fresh(tmp_path, name, engine_mod, **kw) -> list:
    """One fresh run's blanked table (``engine_mod`` is the port's or the
    JAX package's search_reference)."""
    out = tmp_path / f"{name}.tsv"
    engine_mod.run(output=out, threads=1, **kw)
    return blank(out.read_text())


def port_fresh(tmp_path, name, ref, **kw) -> list:
    return fresh(tmp_path, name, port_sr, ref=ref, engine="gpu", device="cpu", **kw)


def jax_host(tmp_path, name, ref, **kw) -> list:
    return fresh(tmp_path, name, jax_sr, ref=ref, engine="host", **kw)


def test_resident_searches_match_fresh_runs(genome, tmp_path):
    ref, vcf = genome
    server = ResidentSearcher(ref, vcf, threads=1, engine="gpu", device="cpu")
    assert server.engine == "gpu" and sorted(server._staged) == ["chr1", "chr2"]
    t1 = blank(server.search(GUIDE, "g1"))
    t2 = blank(server.search(GUIDE2, "g2", max_guide_diffs=4))

    kw1 = dict(guide=GUIDE, guide_id="g1", variants=vcf)
    kw2 = dict(guide=GUIDE2, guide_id="g2", variants=vcf, max_guide_diffs=4)
    assert t1 == port_fresh(tmp_path, "p1", ref, **kw1) == jax_host(tmp_path, "h1", ref, **kw1)
    assert t2 == port_fresh(tmp_path, "p2", ref, **kw2) == jax_host(tmp_path, "h2", ref, **kw2)
    assert len(t1) > 1 and any("rs1" in line for line in t1)  # a variant row


def test_resident_host_engine_identical(genome, tmp_path):
    ref, vcf = genome
    gpu = ResidentSearcher(ref, vcf, threads=1, engine="gpu", device="cpu")
    host = ResidentSearcher(ref, vcf, threads=1, engine="host")
    assert host.engine == "host" and host._staged == {}
    a = blank(gpu.search(GUIDE, "g1"))
    assert a == blank(host.search(GUIDE, "g1"))
    assert a == jax_host(tmp_path, "h", ref, guide=GUIDE, guide_id="g1", variants=vcf)


def test_serve_stdio_protocol(genome, tmp_path):
    ref, vcf = genome
    server = ResidentSearcher(ref, vcf, threads=1, engine="host")
    out_path = tmp_path / "req.tsv"
    requests = "\n".join([
        json.dumps({"cmd": "ping"}),
        json.dumps({"guide": GUIDE, "guide_id": "g1", "output": str(out_path)}),
        json.dumps({"guide": "acgtacgt", "guide_id": "bad"}),  # all lower case: parse error
        json.dumps({"guide": GUIDE, "guide_id": "g1", "bogus_kw": 1}),
        # '-' would write the table into the protocol's stream
        json.dumps({"guide": GUIDE, "guide_id": "g1", "output": "-"}),
        json.dumps([GUIDE, "g1"]),  # not an object
        json.dumps({"cmd": "shutdown"}),
    ]) + "\n"
    out = io.StringIO()
    serve_stdio(server, stdin=io.StringIO(requests), stdout=out)
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    assert replies[0]["ready"] and replies[0]["ok"]
    assert replies[0]["engine"] == "host" and replies[0]["vcf"] == "v.vcf"
    assert replies[1]["ok"]  # ping
    assert replies[2]["ok"] and replies[2]["rows"] >= 1
    assert out_path.exists()
    assert blank(out_path.read_text()) == jax_host(
        tmp_path, "h", ref, guide=GUIDE, guide_id="g1", variants=vcf)
    assert not replies[3]["ok"]  # bad guide reported, server kept running
    assert not replies[4]["ok"] and "bad request" in replies[4]["error"]
    assert not replies[5]["ok"] and "bad request" in replies[5]["error"]
    assert not replies[6]["ok"] and "bad request" in replies[6]["error"]
    assert replies[7]["ok"] and replies[7].get("bye")


def test_serve_cli_subprocess(genome, tmp_path):
    """The Serve sub-command end to end over pipes, gpu engine on the CPU."""
    ref, vcf = genome
    err_path = tmp_path / "serve.err"
    with open(err_path, "w") as err_fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "calitas_tpu_torch", "Serve", "-r", str(ref),
             "-v", str(vcf), "-t", "1", "--engine", "gpu", "--device", "cpu"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err_fh, text=True,
        )
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ok"] and ready["ready"] and ready["engine"] == "gpu"
        assert ready["staged_contigs"] == 2
        proc.stdin.write(json.dumps({"guide": GUIDE, "guide_id": "g1"}) + "\n")
        proc.stdin.flush()
        resp = json.loads(proc.stdout.readline())
        assert resp["ok"] and resp["rows"] >= 1
        assert resp["table"].startswith("guide_id\t")
        assert blank(resp["table"]) == jax_host(
            tmp_path, "h", ref, guide=GUIDE, guide_id="g1", variants=vcf)
        proc.stdin.write(json.dumps({"cmd": "shutdown"}) + "\n")
        proc.stdin.flush()
        assert json.loads(proc.stdout.readline()).get("bye")
        proc.communicate(timeout=60)
        err = err_path.read_text()
        assert proc.returncode == 0, err[-2000:]
        assert "on cpu -> plain PyTorch screen" in err  # the screen route's log line
    finally:
        if proc.poll() is None:
            proc.kill()


def test_serve_gpu_engine_without_cuda_raises(genome):
    if torch.cuda.is_available():
        pytest.skip("the machine has a CUDA device")
    ref, _vcf = genome
    with pytest.raises(RuntimeError, match="cuda"):
        ResidentSearcher(ref, engine="gpu")
    with pytest.raises(RuntimeError, match="cuda"):  # never answers from the host
        cli.main(["Serve", "-r", str(ref), "--engine", "gpu"])


def test_warmup_runs_and_requests_stay_identical(genome, tmp_path):
    """warmup() leaves the searcher answering exactly as a fresh run."""
    ref, _vcf = genome
    s = ResidentSearcher(ref, threads=1, engine="gpu", device="cpu")
    s.warmup()
    table = blank(s.search(guide=GUIDE, guide_id="g"))
    assert table == port_fresh(tmp_path, "p", ref, guide=GUIDE, guide_id="g")
    assert table == jax_host(tmp_path, "h", ref, guide=GUIDE, guide_id="g")


def test_pam_switch_leaves_resident_arrays_unwritten(genome, tmp_path):
    """A 3'-nrg request, a 5'-PAM request, then the first again: each
    equals a fresh run, and the resident arrays hold no PAM bits after
    (a request for one PAM spec never screens against another's gate)."""
    ref, vcf = genome
    s = ResidentSearcher(ref, vcf, threads=1, engine="gpu", device="cpu")
    before = {name: arr.clone() for name, arr in s._staged.items()}
    kw3 = dict(guide=GUIDE, guide_id="g3")
    kw5 = dict(guide=GUIDE_5P, guide_id="g5")
    first = blank(s.search(**kw3))
    five = blank(s.search(**kw5))
    again = blank(s.search(**kw3))
    want3 = port_fresh(tmp_path, "p3", ref, variants=vcf, **kw3)
    assert first == want3 == again
    assert five == port_fresh(tmp_path, "p5", ref, variants=vcf, **kw5)
    assert five == jax_host(tmp_path, "h5", ref, variants=vcf, **kw5)
    assert any(line.startswith("g5\t") for line in five[1:])
    for name, arr in s._staged.items():
        assert torch.equal(arr, before[name]), name
        assert int((arr & 0x30).max()) == 0  # no PAM-gate bit in a resident array


def test_stage_runs_at_construction_only(genome, monkeypatch):
    ref, vcf = genome
    calls = []
    orig = GenomeScreen.stage

    def counting(self, bases):
        calls.append(len(bases))
        return orig(self, bases)

    monkeypatch.setattr(GenomeScreen, "stage", counting)
    s = ResidentSearcher(ref, vcf, threads=1, engine="gpu", device="cpu")
    assert calls == [60000, 40000]
    s.search(GUIDE, "g1")
    s.search(guide_specs=[("a", GUIDE, ()), ("b", GUIDE2, ())], chrom="chr2")
    assert calls == [60000, 40000]


def test_staging_error_leaves_the_constructor(genome, tmp_path, monkeypatch, caplog):
    """A device fault while chr2 is staged degrades, as the reference's
    server does: the constructor returns with chr1 resident, logs a
    WARNING and counts one; every request aligns chr2 on the host (no new
    staging) and its table equals a fresh run's.  A programming error in
    staging still leaves the constructor."""
    from calitas_tpu_torch import utils

    ref, vcf = genome
    want = port_fresh(tmp_path, "f", ref, guide=GUIDE, guide_id="g1", variants=vcf)
    orig = GenomeScreen.stage
    calls = []

    def chr2_fails(self, bases):
        calls.append(len(bases))
        if len(bases) == 40000:
            raise torch.cuda.OutOfMemoryError("staging failed on purpose")
        return orig(self, bases)

    monkeypatch.setattr(GenomeScreen, "stage", chr2_fails)
    utils.reset_degraded()
    with caplog.at_level("WARNING"):
        s = ResidentSearcher(ref, vcf, threads=1, engine="gpu", device="cpu")
    assert list(s._staged) == ["chr1"]
    assert utils.DEGRADED == {**dict.fromkeys(utils.DEGRADED, 0), "resident_staging": 1}
    assert any("Staging failed for chr2" in r.getMessage() and r.exc_info
               for r in caplog.records if r.levelname == "WARNING")
    for _ in range(2):
        assert blank(s.search(GUIDE, "g1")) == want
    assert calls == [60000, 40000]
    assert utils.DEGRADED["staging"] == 0

    def bug(self, bases):
        raise TypeError("planted bug")

    monkeypatch.setattr(GenomeScreen, "stage", bug)
    with pytest.raises(TypeError, match="planted bug"):
        ResidentSearcher(ref, threads=1, engine="gpu", device="cpu")
