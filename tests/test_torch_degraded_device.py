"""Device-fault degradation in the port: when staging, a screen launch, a
segment's readback, a variant slot batch or a list tool's pair screen
fails with a device fault, the run falls back to host alignment and still
writes the exact table; every degradation logs a WARNING and counts one in
``utils.DEGRADED``.  Faults of the port's own kernels (``KernelError``), a
query the kernels do not take (``NotImplementedError``) and programming
errors propagate.  Mirrors tests/test_degraded_device.py; the faults are
injected where the port calls (``stage``, ``screen_contig_async`` /
``screen_contig_multi_async`` and their resolvers, ``screen_slots_multi``,
``PairScreen``).  The gpu engine runs on ``device="cpu"`` (the plain
PyTorch screens); tables are held against the host engine's with
``time_stamp`` and ``aligner_version`` blanked."""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from calitas_tpu_torch import utils
from calitas_tpu_torch.align.engine import SequentialAligner
from calitas_tpu_torch.core.guide import Guide
from calitas_tpu_torch.core.sequence import revcomp
from calitas_tpu_torch.io.fasta import IndexedFasta, ReferenceSetBuilder
from calitas_tpu_torch.ops import dp_cuda, genome_screen
from calitas_tpu_torch.ops.genome_screen import GenomeScreen
from calitas_tpu_torch.ops.pair_screen import PairScreen
from calitas_tpu_torch.parallel.screen_runner import GuideTask, screened_search
from calitas_tpu_torch.search.variants import screened_variant_windows_multi
from calitas_tpu_torch.serve import ResidentSearcher
from calitas_tpu_torch.tools import align_to_reference, pairwise
from calitas_tpu_torch.tools import search_reference as port_sr
from calitas_tpu_torch.utils import KernelError, degradable

KW = dict(
    max_guide_diffs=5, max_pam_diffs=1, max_gaps_between_guide_and_pam=3,
    max_total_diffs=9, max_overlap=10,
)
PROTO = "GACGCATAAAGATGAGACGC"
PROTO2 = "CTTGCCCCACAGGGCAGTAA"


def counts(**nonzero) -> dict:
    return {**dict.fromkeys(utils.DEGRADED, 0), **nonzero}


@pytest.fixture(autouse=True)
def clean_counter():
    utils.reset_degraded()
    yield
    utils.reset_degraded()


@pytest.fixture()
def ref(tmp_path):
    """tests/test_degraded_device.py's genome: two 30 kb contigs with four
    sites of the guide each."""
    rng = np.random.default_rng(11)
    b = ReferenceSetBuilder(assembly="dg")
    for c in ("chr1", "chr2"):
        seq = list("".join(rng.choice(list("ACGT"), 30_000)))
        for k in range(4):
            p = 2000 + k * 6000
            seq[p : p + 23] = list(PROTO + "TGG")
        b.add(c).add("".join(seq))
    return IndexedFasta(b.to_file(tmp_path / "ref.fa")), Guide.parse(PROTO + "nrg")


def rows_of(fasta, guides, screen, window_size=1000, step=970):
    tasks = [GuideTask(guide_id=f"g{i}", guide=g, guide_length=len(g.guide) + 3,
                       step_size=step) for i, g in enumerate(guides)]
    hs = dict(ref_path=str(fasta.path), aligner_id="A", arguments="x",
              vcf_id=None, timestamp="t")
    out = []
    for task, chrom, _start, rows in screened_search(
        fasta, None, tasks, SequentialAligner(), window_size=window_size,
        threads=1, hit_spec=hs, screen=screen, **KW,
    ):
        out += [(task.guide_id, chrom, r._line) for r in rows]
    return sorted(out)


def _raise(exc):
    def fail(*_a, **_k):
        raise exc
    return fail


class StageFails(GenomeScreen):
    exc = RuntimeError("CUDA error: injected staging failure")

    def stage(self, bases):
        raise self.exc


class LaunchFails(GenomeScreen):
    exc = RuntimeError("CUDA error: injected launch failure")

    def screen_contig_async(self, *a, **k):
        raise self.exc

    screen_contig_multi_async = screen_contig_async


def test_stage_failure_degrades_to_host(ref, caplog):
    fasta, guide = ref
    scorer = SequentialAligner().scorer
    good = rows_of(fasta, [guide], GenomeScreen(scorer, "cpu", window=1000))
    assert utils.DEGRADED == counts()
    with caplog.at_level(logging.WARNING):
        degraded = rows_of(fasta, [guide], StageFails(scorer, "cpu", window=1000))
    assert degraded == good
    assert len(good) >= 8
    assert utils.DEGRADED == counts(staging=2)
    assert sum("Device staging failed" in r.getMessage() and bool(r.exc_info)
               for r in caplog.records) == 2


@pytest.mark.parametrize("n_guides", [1, 2], ids=["dual", "multi"])
def test_screen_failure_degrades_to_host(ref, n_guides):
    fasta, guide = ref
    guides = [guide, Guide.parse(PROTO2 + "nrg")][:n_guides]
    scorer = SequentialAligner().scorer
    good = rows_of(fasta, guides, GenomeScreen(scorer, "cpu", window=1000))
    degraded = rows_of(fasta, guides, LaunchFails(scorer, "cpu", window=1000))
    assert degraded == good
    assert utils.DEGRADED == counts(launch=2)  # one group, two contigs


@dataclass
class W:
    chrom: str
    start: int
    length: int
    bases: np.ndarray


def _windows():
    return [W("chr1", 1 + i * 50, 60, np.frombuffer(b"ACGT" * 15, dtype=np.uint8))
            for i in range(10)]


def _failing_resolvers(exc):
    def screen(_scorer, _tmasks, groups, _device, mesh=None):
        return [_raise(exc) for _g in groups]
    return screen


@pytest.mark.parametrize("where", ["launch", "readback"])
def test_variant_screen_failure_degrades(monkeypatch, where):
    """A device failure inside the variant-window screen yields every
    window for every guide (a superset) instead of aborting."""
    exc = RuntimeError("CUDA error: injected")
    monkeypatch.setattr(genome_screen, "screen_slots_multi",
                        _raise(exc) if where == "launch" else _failing_resolvers(exc))
    g = Guide.parse(PROTO + "ngg")
    wins = _windows()
    out = list(screened_variant_windows_multi(
        iter(wins), SequentialAligner(), [("g", g, 0)], device="cpu", batch_slots=4,
    ))
    assert [w.start for w, _ in out] == [w.start for w in wins]
    assert all(keys == frozenset({"g"}) for _w, keys in out)
    assert utils.DEGRADED == counts(variant_screen=3)  # 10 windows, batches of 4


class StageTypeError(GenomeScreen):
    def stage(self, bases):
        raise TypeError("planted bug")


class ScreenRecursion(GenomeScreen):
    def screen_contig(self, *a, **k):
        raise RecursionError("planted bug")

    screen_contig_async = screen_contig


def test_programming_errors_propagate(ref):
    """Degradation is for device failures only: a programming error in the
    screen must crash the search, not silently downgrade the contig to
    host alignment."""
    fasta, guide = ref
    scorer = SequentialAligner().scorer
    with pytest.raises(TypeError):
        rows_of(fasta, [guide], StageTypeError(scorer, "cpu", window=1000))
    with pytest.raises(RecursionError):
        rows_of(fasta, [guide], ScreenRecursion(scorer, "cpu", window=1000))
    assert utils.DEGRADED == counts()


def test_variant_screen_programming_error_propagates(monkeypatch):
    monkeypatch.setattr(genome_screen, "screen_slots_multi", _raise(TypeError("planted bug")))
    with pytest.raises(TypeError):
        list(screened_variant_windows_multi(
            iter(_windows()), SequentialAligner(), [("g", Guide.parse(PROTO + "ngg"), 0)],
            device="cpu", batch_slots=4,
        ))
    assert utils.DEGRADED == counts()


def test_degradable_classification(monkeypatch, tmp_path):
    """torch's device faults degrade; the port's kernel faults (also a
    kernel that faulted while it ran, wherever torch reports it),
    NotImplementedError and programming errors never do.  dp_cuda raises
    KernelError where a kernel does not build or launch, and where a
    readback meets a kernel that faulted."""
    assert degradable(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert degradable(RuntimeError("CUDA error: out of memory"))
    assert degradable(RuntimeError("CUDA error: uncorrectable ECC error encountered"))
    assert degradable(OSError("tunnel reset"))
    for fault in utils._KERNEL_EXECUTION_FAULTS:
        exc = RuntimeError(f"CUDA error: {fault}\nCUDA kernel errors might be "
                           "asynchronously reported at some other API call")
        assert utils.kernel_execution_fault(exc)
        assert not degradable(exc)
    assert not degradable(torch.AcceleratorError("CUDA error: unspecified launch failure"))
    assert not degradable(KernelError("screen_dual launch failed"))
    assert not degradable(NotImplementedError("Q > 48"))
    for exc in utils._PROGRAMMING_ERRORS:
        assert not degradable(exc("planted bug"))
    assert dp_cuda.KernelError is KernelError

    class Lib:
        @staticmethod
        def calitas_cuda_error_string(err):
            return b"invalid configuration argument"

    with pytest.raises(KernelError, match="screen_dual launch failed: CUDA error 9"):
        dp_cuda._raise_on(Lib, 9, "screen_dual")

    class Event:
        def __init__(self, msg):
            self.msg = msg

        def synchronize(self):
            raise RuntimeError(self.msg)

    with pytest.raises(KernelError, match="faulted while it ran: CUDA error: misaligned"):
        dp_cuda._wait(Event("CUDA error: misaligned address"))
    with pytest.raises(RuntimeError, match="out of memory") as info:
        dp_cuda._wait(Event("CUDA error: out of memory"))
    assert not isinstance(info.value, KernelError)
    monkeypatch.setattr(dp_cuda.shutil, "which", lambda _name: None)
    monkeypatch.setattr(dp_cuda, "Path", lambda _p: tmp_path / "no-nvcc")
    with pytest.raises(KernelError, match="nvcc not found"):
        dp_cuda._nvcc()
    monkeypatch.setattr(dp_cuda, "_nvcc", lambda: "false")  # a compiler that fails
    monkeypatch.setattr(dp_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(KernelError, match="nvcc failed"):
        dp_cuda.build_all(["probes"])


class ReadbackFails(GenomeScreen):
    """Every segment of one batch; segment ``k``'s readback fails."""

    MIN_BATCHES_PER_SEGMENT = 1
    k = 1
    exc = RuntimeError("CUDA error: injected readback failure")

    def _fail_k(self, segs):
        return [(i0, n, _raise(self.exc) if i == self.k else res)
                for i, (i0, n, res) in enumerate(segs)]

    def screen_contig_async(self, *a, **kw):
        return self._fail_k(super().screen_contig_async(*a, **kw))

    def screen_contig_multi_async(self, *a, **kw):
        return self._fail_k(super().screen_contig_multi_async(*a, **kw))


@pytest.mark.parametrize("n_guides", [1, 2], ids=["dual", "multi"])
def test_readback_fault_degrades_that_segment_and_later(tmp_path, caplog, n_guides):
    """A readback fault in segment 1 of a 3-segment contig: segment 0
    keeps its flags (its candidates only), segments 1-2 go to the host
    unscreened, the rows equal a clean screen's, and the group's fault
    counts once."""
    rng = np.random.default_rng(5)
    seq = list("".join(rng.choice(list("ACGT"), 75_000)))
    for p in range(3_000, 73_000, 6_000):
        seq[p : p + 23] = list((PROTO if p % 2 else PROTO2) + "AGG")
    b = ReferenceSetBuilder(assembly="rb")
    b.add("chr1").add("".join(seq))
    fasta = IndexedFasta(b.to_file(tmp_path / "ref.fa"))
    guides = [Guide.parse(PROTO + "nrg"), Guide.parse(PROTO2 + "nrg")][:n_guides]
    scorer = SequentialAligner().scorer
    step = 64 - (23 + 5 + 3 - 1)

    clean = GenomeScreen(scorer, "cpu", window=64, batch_windows=1024)
    clean.MIN_BATCHES_PER_SEGMENT = 1
    genome = clean.stage(fasta.get_bases("chr1"))
    segs = clean.screen_contig_async(genome, 75_000, step, PROTO, revcomp(PROTO),
                                     SequentialAligner().min_guide_score(guides[0], 5),
                                     pam_spec=(tuple(guides[0].pams_fw), 1, 3))
    assert len(segs) == 3
    flagged = [int(res()[0].any(axis=0).sum()) for _i0, _n, res in segs]
    want_cand = flagged[0] + sum(n for _i0, n, _r in segs[1:])

    good = rows_of(fasta, guides, clean, window_size=64, step=step)
    with caplog.at_level(logging.INFO):
        degraded = rows_of(fasta, guides,
                           ReadbackFails(scorer, "cpu", window=64, batch_windows=1024),
                           window_size=64, step=step)
    assert degraded == good
    assert len(good) >= 8
    assert utils.DEGRADED == counts(readback=1)
    assert f"Screen chr1/g0: {want_cand} of " in caplog.text
    assert sum(r.levelname == "WARNING" and "segment at window 1024" in r.getMessage()
               for r in caplog.records) == 1


def blank(path) -> list:
    lines = open(path).read().splitlines()
    hdr = lines[0].split("\t")
    varying = {hdr.index(c) for c in ("time_stamp", "aligner_version") if c in hdr}
    return ["\t".join("" if i in varying else c for i, c in enumerate(line.split("\t")))
            for line in lines]


@pytest.fixture()
def list_inputs(tmp_path):
    """A 40 kb contig with sites of the guide, 30 pairs and 30 A2R loci."""
    rng = np.random.default_rng(8)
    seq = list("".join(rng.choice(list("ACGT"), 40_000)))
    loci = ["id\tquery\tchrom\tposition"]
    pairs = []
    for k in range(30):
        site = list(PROTO2)
        for _ in range(int(rng.integers(0, 4))):
            i = int(rng.integers(0, 20))
            site[i] = "ACGT"[("ACGT".index(site[i]) + 1) % 4]
        s = "".join(site) + "TGG"
        pos = 500 + k * 1_300
        seq[pos : pos + 23] = list(s)
        loci.append(f"l{k}\t{PROTO2}nrg\tchr1\t{pos + int(rng.integers(-40, 41))}")
        flank = "".join(rng.choice(list("ACGT"), 30))
        pairs.append(f"{PROTO2}nrg\t{flank}{s if k % 2 else revcomp(s)}{flank}")
    b = ReferenceSetBuilder(assembly="lt")
    b.add("chr1").add("".join(seq))
    ref = b.to_file(tmp_path / "ref.fa")
    (tmp_path / "loci.tsv").write_text("\n".join(loci) + "\n")
    (tmp_path / "pairs.txt").write_text("\n".join(pairs) + "\n")
    return tmp_path, ref


def _list_tool(tool, tmp, ref, out, **engine):
    if tool == "pairwise":
        pairwise.run(tmp / "pairs.txt", out, threads=1, **engine)
    else:
        align_to_reference.run(tmp / "loci.tsv", ref, out, window_size=200,
                               max_guide_diffs=4, max_pam_mismatches=1,
                               max_overlap=5, threads=1, **engine)


@pytest.mark.parametrize("tool", ["pairwise", "a2r"])
def test_pair_screen_fault_degrades(list_inputs, monkeypatch, caplog, tool):
    """PairwiseAlignSequences' screen fails once; AlignToReference's second
    batch of four fails, and that batch and the later ones run unscreened
    while the first keeps its screen.  Both tables equal the host
    engine's, and each fault counts once."""
    tmp, ref = list_inputs
    _list_tool(tool, tmp, ref, tmp / "host.txt", engine="host")
    monkeypatch.setattr(align_to_reference, "BATCH_SIZE", 8)
    name = "chain_maxima" if tool == "pairwise" else "chain_maxima_ranges"
    orig = getattr(PairScreen, name)
    calls = []

    def flaky(self, *a, **k):
        calls.append(1)
        if len(calls) == (1 if tool == "pairwise" else 2):
            raise torch.cuda.OutOfMemoryError("injected")
        return orig(self, *a, **k)

    monkeypatch.setattr(PairScreen, name, flaky)
    with caplog.at_level(logging.WARNING):
        _list_tool(tool, tmp, ref, tmp / "gpu.txt", engine="gpu", device="cpu")
    assert blank(tmp / "gpu.txt") == blank(tmp / "host.txt")
    assert len(blank(tmp / "host.txt")) > 10
    assert len(calls) == (1 if tool == "pairwise" else 2)
    assert utils.DEGRADED == counts(pair_screen=1)
    assert "Device pair screen unavailable" in caplog.text


def _genome(tmp_path, n_contigs=3):
    rng = np.random.default_rng(17)
    b = ReferenceSetBuilder(assembly="oom")
    for i in range(n_contigs):
        seq = list("".join(rng.choice(list("ACGT"), 8_000 + 1_000 * i)))
        seq[700 + 300 * i : 723 + 300 * i] = list(PROTO2 + "TGG")
        b.add(f"chr{i + 1}").add("".join(seq))
    return b.to_file(tmp_path / "ref.fa")


def test_out_of_memory_degrades_through_run(tmp_path, monkeypatch):
    """torch.cuda.OutOfMemoryError at staging and at launch, through
    run(): the tables equal the host engine's, one count per fault."""
    ref = _genome(tmp_path)
    kw = dict(guide=PROTO2 + "nrg", guide_id="g", ref=ref, threads=1)
    port_sr.run(output=tmp_path / "host.txt", engine="host", **kw)
    want = blank(tmp_path / "host.txt")
    assert len(want) >= 4
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
    for point, method in (("staging", "stage"), ("launch", "screen_contig_async")):
        utils.reset_degraded()
        with monkeypatch.context() as m:
            m.setattr(GenomeScreen, method, _raise(oom))
            port_sr.run(output=tmp_path / f"{point}.txt", engine="gpu", device="cpu", **kw)
        assert blank(tmp_path / f"{point}.txt") == want
        assert utils.DEGRADED == counts(**{point: 3})


ENTRY_POINTS = ["search_reference", "pairwise", "a2r", "serve"]


def _illegal_address(msg):
    """torch's report of a kernel that faulted while it ran."""
    return RuntimeError(f"CUDA error: an illegal memory access was encountered ({msg})")


@pytest.mark.parametrize("exc_type", [KernelError, NotImplementedError, _illegal_address],
                         ids=["KernelError", "NotImplementedError", "illegal_address"])
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_kernel_faults_propagate(list_inputs, monkeypatch, exc_type, entry):
    """A kernel that does not build, launch or run and a query the
    kernels do not take leave every entry point; nothing degrades, and no
    table is written."""
    tmp, ref = list_inputs
    exc = exc_type("planted kernel fault")
    out = tmp / "out.txt"
    with pytest.raises(type(exc), match="planted kernel fault"):
        if entry == "search_reference":
            monkeypatch.setattr(GenomeScreen, "screen_contig_async", _raise(exc))
            port_sr.run(guide=PROTO2 + "nrg", guide_id="g", ref=ref, output=out,
                        engine="gpu", device="cpu", threads=1)
        elif entry == "serve":
            monkeypatch.setattr(GenomeScreen, "stage", _raise(exc))
            ResidentSearcher(ref, threads=1, engine="gpu", device="cpu")
        else:
            name = "chain_maxima" if entry == "pairwise" else "chain_maxima_ranges"
            monkeypatch.setattr(PairScreen, name, _raise(exc))
            _list_tool(entry, tmp, ref, out, engine="gpu", device="cpu")
    assert utils.DEGRADED == counts()
    if entry == "search_reference":
        assert not out.exists()


@pytest.mark.parametrize("exc_type", [KernelError, RuntimeError],
                         ids=["readback_KernelError", "RuntimeError"])
@pytest.mark.parametrize("n_guides", [1, 2], ids=["dual", "multi"])
def test_kernel_execution_fault_at_readback_propagates(tmp_path, monkeypatch, n_guides,
                                                       exc_type):
    """A kernel that faulted while it ran shows first at a segment's
    readback, as dp_cuda.readback's KernelError or as torch's own
    RuntimeError: run() fails with it (no host fallback for the segment
    or the later ones), nothing degrades, and no table is written."""
    ref = _genome(tmp_path, 2)
    method = "screen_contig_async" if n_guides == 1 else "screen_contig_multi_async"
    orig = getattr(GenomeScreen, method)
    exc = exc_type("CUDA error: an illegal memory access was encountered")

    def faulted(self, *a, **kw):
        return [(i0, n, _raise(exc)) for i0, n, _res in orig(self, *a, **kw)]

    monkeypatch.setattr(GenomeScreen, method, faulted)
    specs = [("a", PROTO2 + "nrg", ()), ("b", PROTO + "nrg", ())][:n_guides]
    with pytest.raises(exc_type, match="illegal memory access"):
        port_sr.run(guide_specs=specs, ref=ref, output=tmp_path / "o.txt",
                    engine="gpu", device="cpu", threads=1)
    assert utils.DEGRADED == counts()
    assert not (tmp_path / "o.txt").exists()


@pytest.mark.parametrize("exc_type", utils._PROGRAMMING_ERRORS,
                         ids=[e.__name__ for e in utils._PROGRAMMING_ERRORS])
def test_programming_errors_propagate_out_of_run(tmp_path, monkeypatch, exc_type):
    ref = _genome(tmp_path, 1)
    monkeypatch.setattr(GenomeScreen, "screen_contig_async", _raise(exc_type("planted bug")))
    with pytest.raises(exc_type):
        port_sr.run(guide=PROTO2 + "nrg", guide_id="g", ref=ref,
                    output=tmp_path / "o.txt", engine="gpu", device="cpu", threads=1)
    assert utils.DEGRADED == counts()
    assert not (tmp_path / "o.txt").exists()


def test_clean_runs_count_no_degradation(list_inputs):
    """Both passes (a VCF, two guides fused), both list tools: the counter
    reads zero everywhere."""
    tmp, ref = list_inputs
    base = IndexedFasta(ref).get_bases("chr1")[1011:1012].tobytes().decode()
    vcf = tmp / "v.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        '##INFO=<ID=AF,Number=A,Type=Float,Description="AF">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        f"chr1\t1012\trs1\t{base}\t{'C' if base != 'C' else 'G'}\t.\tPASS\tAF=0.2\n"
    )
    port_sr.run(guide_specs=[("a", PROTO2 + "nrg", ()), ("b", PROTO + "nrg", ())], ref=ref,
                variants=vcf, output=tmp / "sr.txt", engine="gpu", device="cpu", threads=1)
    for tool in ("pairwise", "a2r"):
        _list_tool(tool, tmp, ref, tmp / f"{tool}.txt", engine="gpu", device="cpu")
    assert utils.DEGRADED == counts()
