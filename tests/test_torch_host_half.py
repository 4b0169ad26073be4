"""The port's own host half against the JAX package's original, module by
module, on inputs made from a numpy seed: CIGAR parsing and rendering,
the scorer and the encoding tables, reference-set files and FASTA reads,
VCF records and TSV rendering, the native batched finish, and the inputs
of the golden configurations.  Each side builds its own objects from the
same strings and files; only plain values cross over."""

import dataclasses
import importlib.util
import pickle
from pathlib import Path

import numpy as np
import pytest

from calitas_tpu.align.batch import finish_windows as jax_finish_windows
from calitas_tpu.align.engine import SequentialAligner as JaxAligner
from calitas_tpu.core import cigar as jax_cigar
from calitas_tpu.core import scoring as jax_scoring
from calitas_tpu.core import sequence as jax_sequence
from calitas_tpu.core.guide import Guide as JaxGuide
from calitas_tpu.io import fasta as jax_fasta
from calitas_tpu.io import tsv as jax_tsv
from calitas_tpu.io import vcf as jax_vcf
from calitas_tpu.search.hits import HitBuilder as JaxHitBuilder
from calitas_tpu.search.hits import ReferenceHit as JaxReferenceHit
from calitas_tpu_torch import goldens
from calitas_tpu_torch.align.batch import finish_windows
from calitas_tpu_torch.align.engine import SequentialAligner
from calitas_tpu_torch.cli import _parse_guide_file
from calitas_tpu_torch.core import cigar, scoring, sequence
from calitas_tpu_torch.core.guide import Guide
from calitas_tpu_torch.io import fasta, tsv, vcf
from calitas_tpu_torch.search.hits import HitBuilder, ReferenceHit

ROOT = Path(__file__).resolve().parent.parent
SEEDS = [0, 1, 2]
GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"


def _random_cigar(rng) -> str:
    n = int(rng.integers(1, 12))
    return "".join(
        f"{int(rng.integers(1, 40))}{rng.choice(list('=XMID'))}" for _ in range(n)
    )


def _elems(c) -> list:
    return [(e.op, e.length) for e in c]


@pytest.mark.parametrize("seed", SEEDS)
def test_cigar_parse_render_coalesce(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        s = _random_cigar(rng)
        mine, ref = cigar.Cigar(s), jax_cigar.Cigar(s)
        assert _elems(mine) == _elems(ref)
        assert str(mine) == str(ref)
        assert str(mine.coalesce()) == str(ref.coalesce())
        assert (mine.length_on_query, mine.length_on_target, mine.diff_bases()) == (
            ref.length_on_query, ref.length_on_target, ref.diff_bases())
        assert cigar.length_on_target_str(s) == jax_cigar.length_on_target_str(s)
        lazy = cigar.LazyCigar(s)
        assert str(lazy) == s and _elems(lazy) == _elems(ref)
    for bad in ("3", "=3", "3Q", "0M"):
        with pytest.raises(ValueError):
            jax_cigar.length_on_target_str(bad)
        with pytest.raises(ValueError):
            cigar.length_on_target_str(bad)


@pytest.mark.parametrize("parsed", [False, True])
def test_lazy_cigar_pickles(parsed):
    """The finish workers return alignments holding a LazyCigar: it must
    survive the trip back, parsed or not."""
    c = cigar.LazyCigar("3=1X")
    if parsed:
        assert _elems(c) == [("=", 3), ("X", 1)]
    back = pickle.loads(pickle.dumps(c))
    assert type(back) is cigar.LazyCigar
    assert str(back) == "3=1X" and _elems(back) == [("=", 3), ("X", 1)]
    assert back == cigar.Cigar("3=1X")


@pytest.mark.parametrize("seed", SEEDS)
def test_scorer_and_encoding_tables(seed):
    rng = np.random.default_rng(seed)
    costs = [-int(x) for x in rng.integers(1, 400, 4)]
    mine = scoring.derive_scorer(*costs)
    ref = jax_scoring.derive_scorer(*costs)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert scoring.scorer_from_reference(dataclasses.asdict(ref)) == mine
    as_numpy = {k: np.int32(v) for k, v in dataclasses.asdict(ref).items()}
    assert scoring.scorer_from_reference(as_numpy) == mine
    with pytest.raises(ValueError):
        scoring.scorer_from_reference({"match_score": 1})
    assert scoring.worst_guide_diff_score(*costs[:3]) == \
        jax_scoring.worst_guide_diff_score(*costs[:3])
    for name in ("IUPAC_MASK", "TARGET_MASK_TABLE", "MASK_TABLE"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sequence, name)), np.asarray(getattr(jax_sequence, name)))
    letters = list("ACGTNRYSWKMBDHVacgtnrysw")
    for _ in range(20):
        s = "".join(rng.choice(letters, int(rng.integers(1, 60))))
        for fn in ("encode_query", "encode_target"):
            np.testing.assert_array_equal(
                getattr(sequence, fn)(s), getattr(jax_sequence, fn)(s))
        assert sequence.revcomp(s) == jax_sequence.revcomp(s)


def _contigs(rng) -> list:
    out = []
    for k in range(int(rng.integers(2, 4))):
        n = int(rng.integers(150, 2_000))
        s = "".join(rng.choice(list("ACGTacgtN"), n, p=[.22] * 4 + [.02] * 4 + [.04]))
        out.append((f"chr{k + 1}", s))
    return out


def _write_refs(tmp_path, seed):
    rng = np.random.default_rng(seed)
    contigs = _contigs(rng)
    paths = []
    for side, mod in (("port", fasta), ("jax", jax_fasta)):
        b = mod.ReferenceSetBuilder(assembly=f"hh{seed}", line_length=60)
        for name, s in contigs:
            b.add(name).add(s)
        paths.append(b.to_file(tmp_path / side / "ref.fa"))
    return contigs, paths


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_set_files_and_reads(tmp_path, seed):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    contigs, (mine_path, ref_path) = _write_refs(tmp_path, seed)
    for suffix in (".fa", ".fa.fai", ".dict"):
        a = mine_path.parent / ("ref" + suffix)
        b = ref_path.parent / ("ref" + suffix)
        assert a.read_bytes() == b.read_bytes(), suffix
    mine, ref = fasta.IndexedFasta(mine_path), jax_fasta.IndexedFasta(ref_path)
    assert mine.names == ref.names
    rng = np.random.default_rng(seed + 100)
    for name, s in contigs:
        assert mine.sequence_length(name) == ref.sequence_length(name) == len(s)
        assert bytes(mine.get_bases(name)) == bytes(ref.get_bases(name))
        for _ in range(10):
            lo = int(rng.integers(1, len(s)))
            hi = int(rng.integers(lo, len(s) + 1))
            assert mine.get_subsequence(name, lo, hi) == ref.get_subsequence(name, lo, hi)
    dm = [dataclasses.asdict(e) for e in fasta.extract_dictionary(mine_path)]
    dr = [dataclasses.asdict(e) for e in jax_fasta.extract_dictionary(ref_path)]
    assert dm == dr


def _vcf_text(seed) -> str:
    rng = np.random.default_rng(seed)
    lines = ["##fileformat=VCFv4.2",
             '##INFO=<ID=AF,Number=A,Type=Float,Description="AF">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    for chrom in ("chr1", "chr2"):
        for pos in sorted({int(p) for p in rng.integers(1, 5_000, 40)}):
            ref_b = str(rng.choice(list("ACGT")))
            kind = rng.random()
            if kind < 0.6:
                alts = [str(rng.choice([c for c in "ACGT" if c != ref_b]))]
            elif kind < 0.8:
                alts = [ref_b + "".join(rng.choice(list("ACGT"), 2)), "<DEL>"]
            else:
                ref_b = ref_b + "".join(rng.choice(list("ACGT"), 3))
                alts = [ref_b[0]]
            afs = ",".join(f"{float(x):.4g}" for x in rng.uniform(0.001, 0.5, len(alts)))
            rsid = f"rs{pos}" if rng.random() < 0.5 else "."
            lines.append(f"{chrom}\t{pos}\t{rsid}\t{ref_b}\t{','.join(alts)}\t"
                         f"{int(rng.integers(1, 99))}\tPASS\tAF={afs}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", SEEDS)
def test_vcf_records_and_tsv_rendering(tmp_path, seed):
    path = tmp_path / "v.vcf"
    path.write_text(_vcf_text(seed))
    mine = [dataclasses.asdict(v) for v in vcf.VcfReader(path)]
    ref = [dataclasses.asdict(v) for v in jax_vcf.VcfReader(path)]
    assert mine == ref and len(mine) > 40
    mine_idx, ref_idx = vcf.VcfIndex(path), jax_vcf.VcfIndex(path)
    assert mine_idx.chroms == ref_idx.chroms
    for c in ref_idx.chroms:
        assert [dataclasses.asdict(v) for v in mine_idx.query(c, 100, 3_000)] == [
            dataclasses.asdict(v) for v in ref_idx.query(c, 100, 3_000)]
    assert [v.af() for v in vcf.VcfReader(path)] == [v.af() for v in jax_vcf.VcfReader(path)]
    rng = np.random.default_rng(seed)
    values = [None, True, False, "x", 0, -7, 12345678901]
    values += [float(x) for x in rng.normal(0, 1e3, 20)]
    values += [float(x) for x in rng.uniform(1e-9, 1e-3, 10)]
    for v in values:
        assert tsv.format_value(v) == jax_tsv.format_value(v)
    for x in rng.uniform(0, 1, 20):
        assert tsv.format_java_float32(float(x)) == jax_tsv.format_java_float32(float(x))
        assert tsv.float32_widen(float(x)) == jax_tsv.float32_widen(float(x))


def _finish_inputs(seed):
    """Seeded windows, each with 0-2 copies of the guide's site mutated
    0-4 times, on either strand."""
    rng = np.random.default_rng(seed)
    proto = GUIDE[:-3]
    windows = []
    for w in range(40):
        t = list(rng.choice(list("ACGT"), int(rng.integers(60, 400))))
        for _ in range(int(rng.integers(0, 3))):
            site = list(proto + str(rng.choice(["AGG", "TGG", "CAG"])))
            for _ in range(int(rng.integers(0, 5))):
                site[int(rng.integers(0, len(site)))] = str(rng.choice(list("ACGT")))
            s = "".join(site)
            if rng.random() < 0.5:
                s = sequence.revcomp(s)
            p = int(rng.integers(0, len(t) - len(s)))
            t[p : p + len(s)] = list(s)
        bases = np.frombuffer("".join(t).encode(), np.uint8).copy()
        windows.append(("chr1", 1 + 500 * w, bases))
    return windows


@pytest.mark.parametrize("seed", SEEDS)
def test_native_batched_finish_and_rendered_rows(tmp_path, seed):
    limits = dict(max_guide_diffs=5, max_pam_diffs=1,
                  max_gaps_between_guide_and_pam=3, max_total_diffs=9,
                  max_overlap=10)
    windows = _finish_inputs(seed)
    passes = [("fwd", "rev")] * len(windows)
    mine = finish_windows(Guide.parse(GUIDE), SequentialAligner(), windows,
                          passes, **limits)
    ref = jax_finish_windows(JaxGuide.parse(GUIDE), JaxAligner(), windows,
                             passes, **limits)
    assert mine is not None and ref is not None  # the native library ran

    def plain(a):  # field by field: asdict would deep-copy the JAX LazyCigar
        d = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
        d["cigar"] = str(a.cigar)
        return d

    assert [[plain(a) for a in w] for w in mine] == [[plain(a) for a in w] for w in ref]
    assert sum(len(w) for w in mine) >= 10

    # Rows rendered through each side's hit model are the same text.
    seq = "ACGT" * 6_000
    rows = []
    for side, fmod, hb, finish in (
        ("port", fasta, HitBuilder, mine), ("jax", jax_fasta, JaxHitBuilder, ref),
    ):
        (tmp_path / side).mkdir()
        b = fmod.ReferenceSetBuilder(assembly="hh")
        b.add("chr1").add(seq)
        guide = (Guide if side == "port" else JaxGuide).parse(GUIDE)
        builder = hb(guide_id="g", guide=guide,
                     ref=fmod.IndexedFasta(b.to_file(tmp_path / side / "ref.fa")),
                     vcf=None, aligner_id="CALITAS:SearchReference",
                     arguments="a=1", _timestamp="t0", _aligner_version="v0")
        fields = tsv.fields_of(ReferenceHit)
        rows.append([tsv.render_row(builder.build(a), fields)
                     for w in finish for a in w])
    assert rows[0] == rows[1] and len(rows[0]) >= 10


def _random_hit_rows(rng, names, n) -> list:
    """``n`` seeded ReferenceHit field dicts over contigs ``names``, with
    repeated sort keys (chromosome, start, strand, score) among them."""
    rows = []
    for _ in range(n):
        row = {}
        for f in dataclasses.fields(ReferenceHit):
            hint = str(f.type)
            if f.name == "chromosome":
                v = str(rng.choice(names))
            elif f.name == "strand":
                v = str(rng.choice(["+", "-"]))
            elif f.name == "cigar":
                v = f"{int(rng.integers(18, 24))}="
            elif "Optional" in hint and rng.random() < 0.4:
                v = None
            elif "float" in hint:
                v = float(rng.uniform(0.001, 0.5))
            elif "int" in hint:
                v = int(rng.integers(0, 200))
            else:
                v = "".join(rng.choice(list("ACGTacgt"), int(rng.integers(1, 12))))
            row[f.name] = v
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", SEEDS)
def test_contig_partition_and_merge(tmp_path, seed):
    """parallel/multihost.py: the whole-contig partition equals the JAX
    package's over seeded dictionaries, and merge_host_outputs writes the
    same file from the same per-shard tables (seed 2 is large enough for
    the sort's array path)."""
    from calitas_tpu.parallel import multihost as jax_multihost
    from calitas_tpu_torch.parallel import multihost

    rng = np.random.default_rng(seed)
    # lengths in whole thousands, so that ties fall to the name order
    contigs = [(f"chr{i}", 1000 * int(rng.integers(1, 6)))
               for i in range(int(rng.integers(3, 12)))]
    for count in range(1, 6):
        parts = [multihost.host_contig_partition(contigs, i, count) for i in range(count)]
        assert parts == [jax_multihost.host_contig_partition(contigs, i, count)
                         for i in range(count)]
        assert sorted(c for p in parts for c in p) == sorted(c for c, _ in contigs)

    b = fasta.ReferenceSetBuilder(assembly="mh")
    for name, _length in contigs:
        b.add(name).add("ACGT" * 10)
    ref = b.to_file(tmp_path / "ref.fa")
    rows = _random_hit_rows(rng, [c for c, _ in contigs], 5_000 if seed == 2 else 300)
    shards = []
    for k in range(3):
        path = tmp_path / f"shard{k}.txt"
        writer = jax_tsv.MetricWriter(open(path, "w"), JaxReferenceHit)
        writer.write_all([JaxReferenceHit(**r) for r in rows[k::3]])
        writer.close()
        shards.append(path)
    n_mine = multihost.merge_host_outputs(
        shards, fasta.extract_dictionary(ref), tmp_path / "mine.txt")
    n_ref = jax_multihost.merge_host_outputs(
        shards, jax_fasta.extract_dictionary(ref), tmp_path / "ref.txt")
    assert n_mine == n_ref == len(rows)
    assert (tmp_path / "mine.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    # without a reference: sorted by chromosome name
    multihost.merge_host_outputs(shards, None, tmp_path / "m2.txt")
    jax_multihost.merge_host_outputs(shards, None, tmp_path / "r2.txt")
    assert (tmp_path / "m2.txt").read_bytes() == (tmp_path / "r2.txt").read_bytes()


def _run_configs(out: Path):
    spec = importlib.util.spec_from_file_location(
        "run_configs_for_test", ROOT / "benchmarks" / "run_configs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.OUT = out
    return mod


def _capture(monkeypatch, module, calls):
    monkeypatch.setattr(module, "run", lambda **kw: calls.append(kw))


@pytest.mark.parametrize("config", ["1", "2", "3", "4", "5s"])
def test_golden_inputs_equal_run_configs(tmp_path, monkeypatch, config):
    """goldens.py writes what benchmarks/run_configs.py writes, byte for
    byte (the JAX tools it would call are replaced by a recorder)."""
    from calitas_tpu.tools import align_to_reference, pairwise, search_reference

    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    calls: list = []
    for m in (pairwise, align_to_reference, search_reference):
        _capture(monkeypatch, m, calls)
    rc = _run_configs(theirs)
    getattr(rc, "config" + config)()
    argv = goldens.CONFIGS[config](ours)
    assert goldens.GOLDEN[config] == Path(str(calls[0]["output"])).name + (
        ".gz" if config in ("3", "5s") else "")
    theirs_files = sorted(p.name for p in theirs.iterdir())
    for name in theirs_files:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    kw = calls[0]
    if config == "5s":
        gfile = argv[argv.index("--guide-file") + 1]
        assert [(i, g) for i, g, _aux in _parse_guide_file(gfile)] == [
            (i, g) for i, g, _aux in kw["guide_specs"]]
    flags = {"input": "-i", "guide": "-i", "guide_id": "-I", "ref": "-r",
             "variants": "-v", "window_size": "-w", "max_guide_diffs": "-d",
             "max_pam_mismatches": "-p"}
    for key, value in kw.items():
        if key in ("output", "guide_specs"):
            continue
        got = argv[argv.index(flags[key]) + 1]
        if key in ("input", "ref", "variants"):
            assert Path(got).name == Path(str(value)).name, key
        else:
            assert got == str(value), key
