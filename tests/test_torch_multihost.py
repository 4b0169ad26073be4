"""Whole-contig shards and their merge in the port
(``calitas_tpu_torch/parallel/multihost.py``, ``SearchReference
--process-index/--process-count``, ``MergeHitTables``), mirroring
``tests/test_multihost.py``, ``--distributed`` through torch.distributed
over gloo included: the shards' merged table must equal the JAX
package's single host-engine run with ``time_stamp`` and
``aligner_version`` blanked."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest

from calitas_tpu.io.fasta import ReferenceSetBuilder
from calitas_tpu.parallel.multihost import host_contig_partition as jax_partition
from calitas_tpu.tools import search_reference as jax_sr
from calitas_tpu_torch.io.fasta import IndexedFasta
from calitas_tpu_torch.parallel.multihost import host_contig_partition, merge_host_outputs
from calitas_tpu_torch.tools import search_reference as port_sr
from tests.vcf_util import VcfBuilder

GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"


def rows(path) -> list:
    lines = open(path).read().splitlines()
    hdr = lines[0].split("\t")
    varying = {hdr.index("time_stamp"), hdr.index("aligner_version")}
    return [
        tuple("" if i in varying else c for i, c in enumerate(line.split("\t")))
        for line in lines[1:]
    ]


def jax_single(tmp_path, ref, **kw) -> list:
    out = tmp_path / "jax_single.txt"
    jax_sr.run(guide=GUIDE, guide_id="g", ref=ref, output=out, engine="host",
               threads=1, **kw)
    return rows(out)


def test_partition_covers_all_contigs():
    contigs = [("c1", 100), ("c2", 500), ("c3", 300), ("c4", 300)]
    parts = [host_contig_partition(contigs, i, 3) for i in range(3)]
    assert sorted(c for p in parts for c in p) == ["c1", "c2", "c3", "c4"]
    assert parts == [host_contig_partition(contigs, i, 3) for i in range(3)]
    assert parts == [jax_partition(contigs, i, 3) for i in range(3)]


def test_merged_equals_single_host(tmp_path):
    """Per-contig runs of the port, merged per host and then globally,
    equal one run over the whole genome."""
    rng = np.random.default_rng(3)
    b = ReferenceSetBuilder(assembly="mh")
    for i in range(4):
        seq = "".join(rng.choice(list("ACGT"), 4000))
        seq = seq[:977] + "CTTGCCCCACAGGGCAGTAATGG" + seq[1000:]  # one site per contig
        b.add(f"chr{i + 1}").add(seq)
    ref = b.to_file(tmp_path / "ref.fa")
    fa = IndexedFasta(ref)
    contigs = [(e.name, e.length) for e in fa.dictionary]
    host_files = []
    for h in range(2):
        parts = []
        for c in host_contig_partition(contigs, h, 2):
            out = tmp_path / f"h{h}.{c}.txt"
            port_sr.run(guide=GUIDE, guide_id="g", ref=ref, output=out, chrom=c,
                        engine="gpu", device="cpu", threads=1)
            parts.append(out)
        merged_h = tmp_path / f"host{h}.txt"
        merge_host_outputs(parts, fa.dictionary, merged_h)
        host_files.append(merged_h)
    final = tmp_path / "merged.txt"
    assert merge_host_outputs(host_files, fa.dictionary, final) >= 4
    assert rows(final) == jax_single(tmp_path, ref)


def _launch(tmp_path, ref, extra=()) -> tuple:
    """Two ``SearchReference --process-index h --process-count 2`` runs of
    the port's CLI and their ``MergeHitTables``: (per-shard row sets,
    merged rows)."""
    cmd = [sys.executable, "-m", "calitas_tpu_torch", "SearchReference",
           "-i", GUIDE, "-I", "g", "-r", str(ref), "-t", "1", "--engine", "gpu",
           "--device", "cpu", *extra]
    host_files = []
    for h in range(2):
        out = tmp_path / f"host{h}.txt"
        subprocess.run(cmd + ["-o", str(out), "--process-index", str(h),
                              "--process-count", "2"],
                       check=True, capture_output=True)
        host_files.append(str(out))
    final = tmp_path / "merged.txt"
    subprocess.run(
        [sys.executable, "-m", "calitas_tpu_torch", "MergeHitTables",
         "-i", *host_files, "-o", str(final), "-r", str(ref)],
        check=True, capture_output=True,
    )
    return [set(rows(f)) for f in host_files], rows(final)


def test_launcher_subprocesses_merge_to_single(tmp_path):
    rng = np.random.default_rng(11)
    b = ReferenceSetBuilder(assembly="mhl")
    for i in range(3):
        seq = "".join(rng.choice(list("ACGT"), 3000 + 500 * i))
        seq = seq[:511] + "CTTGCCCCACAGGGCAGTAATGG" + seq[534:]
        b.add(f"chr{i + 1}").add(seq)
    ref = b.to_file(tmp_path / "ref.fa")
    (h0, h1), merged = _launch(tmp_path, ref)
    assert merged == jax_single(tmp_path, ref)
    assert len(merged) >= 3
    # the shards' tables are disjoint, non-empty parts of the merged one
    assert h0 and h1 and not (h0 & h1)
    assert (h0 | h1) == set(merged)


def test_launcher_subprocesses_merge_with_vcf(tmp_path):
    """The same with a VCF: the variant pass's rows merge too."""
    rng = np.random.default_rng(13)
    b = ReferenceSetBuilder(assembly="mhv")
    vb = VcfBuilder()
    proto = "CTTGCCCCACAGGGCAGTAA"
    for i in range(3):
        seq = list("".join(rng.choice(list("ACGT"), 3000 + 400 * i)))
        seq[511:534] = list(proto + "TGG")
        # break base 10 of a second site; a variant repairs it
        broken = list(proto)
        broken[10] = "A" if proto[10] != "A" else "C"
        seq[1500:1523] = list("".join(broken) + "TGG")
        seq = "".join(seq)
        name = f"chr{i + 1}"
        b.add(name).add(seq)
        vb.add(name, 1511, alleles=(seq[1510], proto[10]), info={"AF": "0.4"})
        for _ in range(10):  # noise
            p = int(rng.integers(100, 2800))
            rb = seq[p - 1]
            vb.add(name, p, alleles=(rb, "ACGT"[("ACGT".index(rb) + 1) % 4]),
                   info={"AF": "0.05"})
    ref = b.to_file(tmp_path / "ref.fa")
    vcf = vb.to_file(tmp_path / "v.vcf")
    (h0, h1), merged = _launch(tmp_path, ref, ["-v", str(vcf)])
    assert merged == jax_single(tmp_path, ref, variants=vcf)
    assert h0 and h1 and not (h0 & h1)
    vd = open(tmp_path / "merged.txt").readline().split("\t").index("variant_description")
    assert sum(1 for r in merged if "0.400" in r[vd]) >= 3  # repaired sites


@pytest.mark.parametrize("engine", [dict(engine="gpu", device="cpu"), dict(engine="host")],
                         ids=["gpu-on-cpu", "host"])
def test_process_args_validation(tmp_path, engine):
    b = ReferenceSetBuilder(assembly="val")
    b.add("c1").add("ACGT" * 100)
    ref = b.to_file(tmp_path / "ref.fa")
    common = dict(guide=GUIDE, guide_id="g", ref=ref, output=tmp_path / "o.txt",
                  **engine)
    for bad in (dict(process_index=2, process_count=2), dict(process_count=2),
                dict(process_index=0), dict(chrom="c1", process_index=0, process_count=2)):
        with pytest.raises(ValueError):
            port_sr.run(**common, **bad)
    assert not (tmp_path / "o.txt").exists()


def test_distributed_flag_two_processes(tmp_path):
    """``--distributed`` end to end: two processes initialize
    torch.distributed over gloo on localhost from ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (no
    ``--process-index``), take their shards from their rank, and their
    merged table equals the single run (tests/test_multihost.py's
    counterpart)."""
    import os
    import socket

    rng = np.random.default_rng(23)
    b = ReferenceSetBuilder(assembly="dist")
    for i in range(3):
        seq = "".join(rng.choice(list("ACGT"), 2500 + 400 * i))
        seq = seq[:401] + "CTTGCCCCACAGGGCAGTAATGG" + seq[424:]
        b.add(f"chr{i + 1}").add(seq)
    ref = b.to_file(tmp_path / "ref.fa")
    cmd = [sys.executable, "-m", "calitas_tpu_torch", "SearchReference", "-i", GUIDE,
           "-I", "g", "-r", str(ref), "-t", "1", "--engine", "gpu", "--device", "cpu"]
    with socket.socket() as s:  # a free localhost port for the rendezvous
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, host_files = [], []
    for rank in range(2):
        out = tmp_path / f"dhost{rank}.txt"
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank))
        procs.append(subprocess.Popen(cmd + ["-o", str(out), "--distributed"], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        host_files.append(str(out))
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode()[-2000:]
            assert "torch.distributed: rank" in err.decode()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    final = tmp_path / "dmerged.txt"
    subprocess.run([sys.executable, "-m", "calitas_tpu_torch", "MergeHitTables",
                    "-i", *host_files, "-o", str(final), "-r", str(ref)],
                   check=True, capture_output=True)
    merged = rows(final)
    assert merged == jax_single(tmp_path, ref)
    assert len(merged) >= 3
    h0, h1 = (set(rows(f)) for f in host_files)
    assert h0 and h1 and not (h0 & h1)
    assert (h0 | h1) == set(merged)


def test_distributed_identity_and_teardown(tmp_path, monkeypatch):
    """In one process (world size 1): an explicit process index or count
    must agree with torch.distributed's, and the process group is
    destroyed when run() ends, by an error too."""
    import socket

    import torch.distributed as dist

    b = ReferenceSetBuilder(assembly="one")
    b.add("c1").add("ACGT" * 100 + "CTTGCCCCACAGGGCAGTAATGG" + "ACGT" * 100)
    ref = b.to_file(tmp_path / "ref.fa")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for var, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                       ("WORLD_SIZE", "1"), ("RANK", "0")):
        monkeypatch.setenv(var, value)
    common = dict(guide=GUIDE, guide_id="g", engine="host", threads=1, distributed=True)
    for bad in (dict(process_index=1), dict(process_count=2)):
        with pytest.raises(ValueError, match="disagrees with torch.distributed"):
            port_sr.run(ref=ref, output=tmp_path / "o.txt", **common, **bad)
        assert not dist.is_initialized()
    with pytest.raises(FileNotFoundError):
        port_sr.run(ref=tmp_path / "missing.fa", output=tmp_path / "o.txt", **common)
    assert not dist.is_initialized()
    port_sr.run(ref=ref, output=tmp_path / "o.txt", process_count=1, **common)
    assert not dist.is_initialized()
    assert rows(tmp_path / "o.txt") == jax_single(tmp_path, ref)
