"""The window split over a device mesh in the port: ``ShardedGenomeScreen``
and the sharded slot batches on meshes of 2, 3 and 8 ``cpu`` entries (3
gives spans that are not whole bytes of flags, 8 tail entries with no
window) give flags and ranges bit-identical to the port's one-device
``GenomeScreen`` and to the JAX package's ``ShardedGenomeScreen`` on the
8-device CPU mesh of tests/conftest.py; ``run(mesh=)`` tables equal those
without a mesh.  Gated screens are held against JAX's Pallas path in
interpret mode, never the XLA path, which applies no PAM gate.  Mirrors
tests/test_sharding.py but for ``screen_on_mesh`` (held against the JAX
function in tests/test_torch_graft_entry.py) and the nibble-packed
staging, which is not ported."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import calitas_tpu.ops.genome_screen as jax_gs
from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu.core.sequence import TARGET_MASK_TABLE, encode_query, revcomp
from calitas_tpu.tools import search_reference as jax_sr
from calitas_tpu_torch.align.engine import SequentialAligner
from calitas_tpu_torch.core.guide import Guide
from calitas_tpu_torch.io.fasta import IndexedFasta, ReferenceSetBuilder
from calitas_tpu_torch.ops import dp_screen
from calitas_tpu_torch.ops import genome_screen as port_gs
from calitas_tpu_torch.parallel.mesh import make_mesh
from calitas_tpu_torch.parallel.screen_runner import GuideTask, screened_search
from calitas_tpu_torch.tools import search_reference as port_sr

SCORER = derive_scorer()
GUIDE = "CTTGCCCCACAGGGCAGTAA"
MESHES = [2, 3, 8]


@pytest.fixture(scope="module")
def mesh8():
    import jax

    devices = jax.devices("cpu")
    if len(devices) < 8:
        pytest.skip("needs 8 devices (set xla_force_host_platform_device_count)")
    from calitas_tpu.parallel.mesh import make_mesh as jax_make_mesh

    return jax_make_mesh(8, devices=devices)


def cpu_mesh(n: int) -> tuple:
    return make_mesh(devices=["cpu"] * n)


def test_make_mesh():
    assert cpu_mesh(3) == (torch.device("cpu"),) * 3
    assert make_mesh(2, devices=["cpu"] * 4) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    with pytest.raises(ValueError):
        make_mesh(devices=["meta"])
    assert port_gs.mesh_spans(3, 100, 100) == [(0, 100, 40), (1, 140, 40), (2, 180, 20)]
    assert port_gs.mesh_spans(8, 0, 10) == [(0, 0, 8), (1, 8, 2)]
    assert port_gs.slot_batch_unit(False, cpu_mesh(3)) == 24
    assert port_gs.slot_batch_unit(True, cpu_mesh(2)) == 2 * port_gs.BATCH_UNIT


def _bases(contig: str) -> np.ndarray:
    return np.frombuffer(contig.encode(), dtype=np.uint8)


class TestShardedScreen:
    @pytest.mark.parametrize("n", MESHES)
    def test_flags_match_single_device(self, mesh8, n):
        rng = np.random.default_rng(2)
        contig = "".join(rng.choice(list("ACGT"), 60_000))
        contig = contig[:5000] + GUIDE + contig[5000 + len(GUIDE):]
        bases = _bases(contig)
        args = (len(bases), 970, GUIDE, revcomp(GUIDE), 590)

        single = port_gs.GenomeScreen(SCORER, "cpu", window=1000, batch_windows=512)
        f1 = single.screen_contig(single.stage(bases), *args)
        sharded = port_gs.ShardedGenomeScreen(SCORER, cpu_mesh(n), window=1000,
                                              batch_windows=512)
        staged = sharded.stage(bases)
        assert list(staged) == [torch.device("cpu")]  # one copy per distinct device
        calls = dp_screen.reference_calls["cpu"]
        f2 = sharded.screen_contig(staged, *args)
        assert dp_screen.reference_calls["cpu"] - calls == len(
            port_gs.mesh_spans(n, 0, len(f1)))  # one launch per live span
        np.testing.assert_array_equal(f1, f2)
        if n == 8:
            jax_screen = jax_gs.ShardedGenomeScreen(SCORER, mesh8, window=1000,
                                                    batch_windows=512, use_pallas=False)
            np.testing.assert_array_equal(
                f1, jax_screen.screen_contig(jax_screen.stage(bases), *args))
        assert f1.any()

    @pytest.mark.parametrize("n", MESHES)
    def test_gated_chain_flags_and_ranges_match_single_device(self, mesh8, n):
        """The full output contract: per-chain flags, the PAM gate and
        coarse end-column ranges."""
        rng = np.random.default_rng(5)
        contig = list("".join(rng.choice(list("ACGT"), 30_000)))
        for pos, seq in ((700, GUIDE + "TGG"), (9000, revcomp(GUIDE + "AGG"))):
            contig[pos : pos + len(seq)] = list(seq)
        bases = _bases("".join(contig))
        pam_spec = (("ngg",), 1, 3)
        args = (len(bases), 220, GUIDE, revcomp(GUIDE), 1100)

        single = port_gs.GenomeScreen(SCORER, "cpu", window=250, batch_windows=1024)
        f1, r1 = single.screen_contig(single.stage(bases), *args, pam_spec=pam_spec,
                                      return_ranges=True)
        sharded = port_gs.ShardedGenomeScreen(SCORER, cpu_mesh(n), window=250,
                                              batch_windows=1024)
        f2, r2 = sharded.screen_contig(sharded.stage(bases), *args, pam_spec=pam_spec,
                                       return_ranges=True)
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(r1, r2)
        if n == 8:
            jax_screen = jax_gs.ShardedGenomeScreen(
                SCORER, mesh8, window=250, batch_windows=1024, use_pallas=True,
                interpret=True, pack_staging=False,
            )
            f3, r3 = jax_screen.screen_contig(jax_screen.stage(bases), *args,
                                              pam_spec=pam_spec, return_ranges=True)
            np.testing.assert_array_equal(f1, f3)
            np.testing.assert_array_equal(r1[f1], r3[f3])  # contractual where flagged
        assert f1.any()

    @pytest.mark.parametrize("n", MESHES)
    def test_screened_search_on_mesh_identical_rows(self, tmp_path, n):
        """screened_search over the mesh yields the one-device rows (the
        sharded ranges reach the sliced native finish)."""
        rng = np.random.default_rng(9)
        proto = "".join(rng.choice(list("ACGT"), 20))
        contig = list("".join(rng.choice(list("ACGT"), 50_000)))
        for _ in range(6):
            pos = int(rng.integers(100, 49_000))
            site = list(proto)
            for _ in range(int(rng.integers(0, 3))):
                i = int(rng.integers(0, len(site)))
                site[i] = rng.choice([c for c in "ACGT" if c != site[i]])
            seq = "".join(site) + "TGG"
            if rng.random() < 0.5:
                seq = revcomp(seq)
            contig[pos : pos + len(seq)] = list(seq)
        b = ReferenceSetBuilder(assembly="shardtest")
        b.add("chr1").add("".join(contig))
        ref = IndexedFasta(b.to_file(tmp_path / "ref.fa"))
        guide = Guide.parse(proto + "nrg")
        kw = dict(max_guide_diffs=5, max_pam_diffs=1, max_gaps_between_guide_and_pam=3,
                  max_total_diffs=9, max_overlap=10)
        task = GuideTask(guide_id="g", guide=guide, guide_length=len(guide.guide),
                         step_size=970)
        hit_spec = dict(ref_path=str(ref.path), aligner_id="a", arguments="args",
                        vcf_id="", timestamp="ts")

        def run(screen):
            rows = []
            for _t, chrom, _start, rr in screened_search(
                ref, None, [task], SequentialAligner(), window_size=1000,
                screen=screen, hit_spec=hit_spec, **kw,
            ):
                rows += [(chrom, r._line) for r in rr]
            return rows

        single_rows = run(port_gs.GenomeScreen(SCORER, "cpu", window=1000))
        assert run(port_gs.ShardedGenomeScreen(SCORER, cpu_mesh(n), window=1000)) == single_rows
        assert len(single_rows) > 0


class TestShardedAsyncScreen:
    @pytest.mark.parametrize("n", MESHES)
    def test_segmented_flags_and_ranges_match_single_device(self, mesh8, n):
        """The sharded segmented screen resolves to the one-shot screen's
        per-chain flags and ranges, and to the JAX sharded screen's."""
        rng = np.random.default_rng(9)
        contig = "".join(rng.choice(list("ACGT"), 300_000))
        for pos in (5000, 150_000, 290_000):
            contig = contig[:pos] + GUIDE + contig[pos + len(GUIDE):]
        bases = _bases(contig)
        args = (len(bases), 220, GUIDE, revcomp(GUIDE), 590)

        single = port_gs.GenomeScreen(SCORER, "cpu", window=250, batch_windows=1024)
        f1, r1 = single.screen_contig(single.stage(bases), *args, return_ranges=True)
        sharded = port_gs.ShardedGenomeScreen(SCORER, cpu_mesh(n), window=250,
                                              batch_windows=1024)
        segs = sharded.screen_contig_async(sharded.stage(bases), *args, segments=2)
        assert len(segs) == 2
        assert [(i0, n_seg) for i0, n_seg, _r in segs] == single.segment_spans(
            f1.shape[1], 2)
        parts = [resolve() for _i0, _n, resolve in segs]
        np.testing.assert_array_equal(np.concatenate([f for f, _r in parts], axis=1), f1)
        np.testing.assert_array_equal(np.concatenate([r for _f, r in parts], axis=1), r1)
        if n == 8:
            jax_screen = jax_gs.ShardedGenomeScreen(SCORER, mesh8, window=250,
                                                    batch_windows=1024, use_pallas=False)
            f3, r3 = jax_screen.screen_contig(jax_screen.stage(bases), *args,
                                              return_ranges=True)
            np.testing.assert_array_equal(f1, f3)
            np.testing.assert_array_equal(r1, r3)
        assert f1.any()


class TestShardedMultiGuideScreen:
    @pytest.mark.parametrize("n", MESHES)
    def test_sharded_multi_async_equals_single_device_multi(self, mesh8, n):
        """The sharded multi-guide screen equals the one-device multi
        screen per guide, flags and ranges, the PAM gate on."""
        rng = np.random.default_rng(31)
        bases = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 60_000).astype(np.uint8)
        guides = [Guide.parse(GUIDE + "nrg"), Guide.parse("ACGTACATGCTCGATACGACnrg")]
        for g, pos in zip(guides, (7_000, 45_000)):
            site = (g.guide + "TGG").encode()
            bases[pos : pos + len(site)] = np.frombuffer(site, dtype=np.uint8)
        dqs = [(g.guide_fw, revcomp(g.guide_fw)) for g in guides]
        mss = [60 * len(g.guide_fw) - 5 * 122 for g in guides]
        pam_spec = (tuple(guides[0].pams_fw), 1, 3)

        def run(screen):
            parts_f, parts_r = [], []
            for _i0, n_seg, resolve in screen.screen_contig_multi_async(
                screen.stage(bases), len(bases), 230, dqs, mss, pam_spec=pam_spec,
            ):
                cf, cr = resolve()
                assert cf.shape[2] == n_seg and cr.shape[2] == n_seg
                parts_f.append(cf)
                parts_r.append(cr)
            return np.concatenate(parts_f, axis=2), np.concatenate(parts_r, axis=2)

        f1, r1 = run(port_gs.GenomeScreen(SCORER, "cpu", window=256))
        f2, r2 = run(port_gs.ShardedGenomeScreen(SCORER, cpu_mesh(n), window=256))
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(r1, r2)
        if n == 8:
            f3, r3 = run(jax_gs.ShardedGenomeScreen(
                SCORER, mesh8, window=256, batch_windows=1024, use_pallas=True,
                interpret=True, pack_staging=False,
            ))
            np.testing.assert_array_equal(f1, f3)
            np.testing.assert_array_equal(r1[f1], r3[f3])
        assert f1.any(axis=(1, 2)).all()  # every guide found its plant


class TestShardedVariantPass:
    @pytest.mark.parametrize("n", MESHES)
    def test_slot_flags_match_single_device(self, mesh8, n):
        rng = np.random.default_rng(23)
        unit = port_gs.slot_batch_unit(False, cpu_mesh(n))
        B, T = 3 * unit, 64
        letters = np.frombuffer(b"ACGT", dtype=np.uint8)
        tmasks = TARGET_MASK_TABLE[letters[rng.integers(0, 4, size=(B, T))]]
        site = TARGET_MASK_TABLE[np.frombuffer((GUIDE + "TGG").encode(), np.uint8)]
        tmasks[5, 10 : 10 + len(site)] = site
        tmasks[B - 3, : len(site)] = site
        qv = np.stack([encode_query(GUIDE), encode_query(revcomp(GUIDE))]).astype(np.int32)[None]
        ms = np.asarray([SCORER.match_score * 10], np.int32)

        single = port_gs.screen_slots_multi(SCORER, tmasks, [(qv, ms)], "cpu")[0]()
        sharded = port_gs.screen_slots_multi(SCORER, tmasks, [(qv, ms), (qv, ms + 1)],
                                             "cpu", mesh=cpu_mesh(n))
        np.testing.assert_array_equal(single, sharded[0]())
        assert sharded[1]().shape == (1, B)
        want = jax_gs.screen_slots_multi(SCORER, tmasks, np.full(B, T, np.int32),
                                         [(False, qv, ms)], mesh=mesh8 if n == 8 else None)[0]()
        np.testing.assert_array_equal(single, want)
        assert single[0, 5] and single[0, B - 3]


def _table(path) -> list:
    lines = open(path).read().splitlines()
    hdr = lines[0].split("\t")
    varying = {hdr.index("time_stamp"), hdr.index("aligner_version")}
    return [tuple("" if i in varying else c for i, c in enumerate(line.split("\t")))
            for line in lines]


@pytest.fixture(scope="module")
def variant_genome(tmp_path_factory):
    """tests/test_sharding.py's variant-pass genome: three sites, one
    restored by a variant, 60 noise SNVs."""
    from tests.vcf_util import VcfBuilder

    tmp = tmp_path_factory.mktemp("meshvar")
    rng = np.random.default_rng(17)
    contig = list("".join(rng.choice(list("ACGT"), 20_000)))
    for i, pos in enumerate((500, 5_000, 12_000)):
        site = GUIDE + "TGG"
        contig[pos : pos + len(site)] = list(revcomp(site) if i % 2 else site)
    broken = list(GUIDE)
    broken[10] = "A" if GUIDE[10] != "A" else "C"
    contig[8_000 : 8_023] = list("".join(broken) + "TGG")
    contig = "".join(contig)
    b = ReferenceSetBuilder(assembly="shardvar")
    b.add("chr1").add(contig)
    ref = b.to_file(tmp / "ref.fa")
    vb = VcfBuilder()
    vb.add("chr1", 8_011, alleles=(contig[8_010], GUIDE[10]), info={"AF": "0.5"})
    for _ in range(60):
        p = int(rng.integers(100, 19_000))
        alt = rng.choice([c for c in "ACGT" if c != contig[p - 1]])
        vb.add("chr1", p, alleles=(contig[p - 1], alt), info={"AF": "0.1"})
    return tmp, ref, vb.to_file(tmp / "v.vcf")


@pytest.mark.parametrize("what,n", [("variants", 2), ("variants", 8), ("fused", 3)])
def test_run_on_mesh_identical_table(variant_genome, tmp_path, what, n):
    """Full SearchReference: a mesh run equals the run without one and
    the JAX package's host engine, row for row: the reference and variant
    passes of one guide, and a fused group of two guides."""
    tmp, ref, vcf = variant_genome
    if what == "variants":
        kw = dict(guide=GUIDE + "nrg", guide_id="g", variants=vcf)
    else:
        kw = dict(guide_specs=[("a", GUIDE + "nrg", ()), ("b", "ACGTACATGCTCGATACGACnrg", ())])
    want = tmp / f"jax_{what}.txt"
    if not want.exists():
        jax_sr.run(ref=ref, output=want, engine="host", threads=1, **kw)
    port_sr.run(ref=ref, output=tmp_path / "one.txt", engine="gpu", device="cpu",
                threads=1, **kw)
    port_sr.run(ref=ref, output=tmp_path / "mesh.txt", engine="gpu", device="cpu",
                threads=1, mesh=cpu_mesh(n), **kw)
    assert _table(tmp_path / "mesh.txt") == _table(tmp_path / "one.txt") == _table(want)
    assert len(_table(want)) >= 4
    if what == "variants":
        assert any("0.500" in "\t".join(r) for r in _table(want))
