"""The port's genome screen against the JAX package: on-device encoding,
staged PAM annotation, flag bit packing, and whole-contig screens
(single span and segmented) against ``GenomeScreen(use_pallas=True,
interpret=True)``, flags and coarse ranges bit for bit, gate on and off.
Mirrors tests/test_screen.py's TestSegmentedScreen, TestWideWindowRanges,
TestAnnotateGenomePam, TestDeviceEncoding and TestBatchWindowsFor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calitas_tpu.ops.genome_screen as jax_gs
from calitas_tpu.core.guide import Guide
from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu.core.sequence import TARGET_MASK_TABLE, encode_query, revcomp
from calitas_tpu_torch.ops import dp_screen as port_dp
from calitas_tpu_torch.ops import genome_screen as port_gs

SCORER = derive_scorer()
GUIDE = Guide.parse("CTTGCCCCACAGGGCAGTAAnrg")
PLANTED = np.frombuffer(b"CTTGCCCCACAGGGCAGTAATGG", dtype=np.uint8)


def _contig(seed, n, plant_at=()):
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n, p=[.24] * 4 + [.04])
    for pos in plant_at:
        site = PLANTED if pos % 2 else np.frombuffer(
            revcomp(PLANTED.tobytes().decode()).encode(), np.uint8
        )
        bases[pos : pos + len(site)] = site
    return bases.astype(np.uint8)


class TestDeviceEncoding:
    def test_encode_all_byte_values(self):
        raw = np.arange(256, dtype=np.uint8)
        got = port_gs._encode_staged(torch.from_numpy(raw)).numpy()
        np.testing.assert_array_equal(got, TARGET_MASK_TABLE)
        want = np.asarray(jax_gs._encode_staged(jnp.asarray(raw)))
        np.testing.assert_array_equal(got, want)

    def test_stage_matches_jax_stage(self):
        bases = np.concatenate([
            np.arange(256, dtype=np.uint8),
            np.frombuffer(b"acgtnACGTNryswkmbdhvRYSWKMBDHVuU", np.uint8),
            _contig(1, 3001),
        ])
        port = port_gs.GenomeScreen(SCORER, "cpu", window=256).stage(bases)
        jax_screen = jax_gs.GenomeScreen(SCORER, window=256, pack_staging=False)
        np.testing.assert_array_equal(
            port.numpy(), np.asarray(jax_screen.stage(bases))
        )
        assert port.numel() == 1 << (len(bases) + 255).bit_length()

    def test_from_numpy_staged(self):
        arr = np.arange(64, dtype=np.uint8)
        t = port_gs.from_numpy_staged(arr, "cpu")
        assert t.dtype == torch.uint8 and t.shape == (64,)
        np.testing.assert_array_equal(t.numpy(), arr)


class TestAnnotateGenomePam:
    SPECS = [
        (("nrg",), 1, 3),
        (("ngg", "nag"), 1, 0),
        (("tttv",), 0, 2),
        (("nrg", "nnnrrt"), 2, 1),
    ]

    @pytest.mark.parametrize("spec", SPECS)
    @pytest.mark.parametrize("length", [777, 4096])
    def test_matches_jax(self, spec, length):
        masks = TARGET_MASK_TABLE[_contig(length, length)]
        enc = port_gs.encode_pam_spec(spec)
        got = port_gs.annotate_genome_pam(torch.from_numpy(masks), enc).numpy()
        want = np.asarray(jax_gs.annotate_genome_pam(jnp.asarray(masks), pam_spec=enc))
        np.testing.assert_array_equal(got, want)
        assert ((got & 15) == masks).all()
        assert (got >> 4).any()

    def test_ragged_tail_matches_chunked_jax(self, monkeypatch):
        """The reference annotates in chunks and recomputes a ragged tail;
        the port's one-pass annotation equals it bit for bit."""
        masks = TARGET_MASK_TABLE[_contig(6, 1501)]
        enc = port_gs.encode_pam_spec((("nrg",), 1, 3))
        monkeypatch.setattr(jax_gs, "_ENCODE_CHUNK", 512)
        want = np.asarray(jax_gs.annotate_genome_pam(jnp.asarray(masks), pam_spec=enc))
        got = port_gs.annotate_genome_pam(torch.from_numpy(masks), enc).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[1024:] >> 4).any()  # the tail is annotated

    def test_no_pams_means_no_gate(self):
        assert port_gs.encode_pam_spec(None) is None
        assert port_gs.encode_pam_spec(((), 1, 3)) is None
        assert port_gs.encode_pam_spec((("",), 1, 3)) is None


class TestAnnotateRoute:
    """The static route of ``annotate_genome_pam``: the CUDA kernel for a
    CUDA tensor whose spec is within ``dp_cuda``'s limits, the plain
    version for everything else, and no launch counted on the plain
    route.  (The kernel against the plain version, bit for bit, is a card
    test in tests/test_torch_dp_cuda.py.)"""

    WITHIN = [
        (("nrg",), 1, 3),
        (("tttv",), 0, 0),
        (("nnnnnnnnnnnnnnnn",) * 8, 255, 32),
    ]
    BEYOND = [
        (("nrg",) * 9, 1, 3),  # 9 PAMs
        (("nnnnnnnnnnnnnnnnn",), 1, 3),  # a 17-base PAM
        (("nrg",), 1, 33),  # max_gap 33
        (("nrg",), -1, 3),  # max_mm below 0: the plain version wraps it
        (("nrg",), 256, 3),  # max_mm above 255: likewise
    ]

    @staticmethod
    def _enc(spec):
        pams, max_mm, max_gap = spec
        enc = port_gs.encode_pam_spec((pams, 0, max_gap))
        return enc[0], max_mm, max_gap

    @pytest.mark.parametrize("spec", WITHIN)
    def test_cuda_within_limits_takes_the_kernel(self, spec):
        enc = self._enc(spec)
        assert port_gs.dp_cuda.annotates_on_kernel(enc, "cuda")
        assert port_gs.dp_cuda.annotates_on_kernel(enc, torch.device("cuda", 1))
        assert not port_gs.dp_cuda.annotates_on_kernel(enc, "cpu")

    @pytest.mark.parametrize("spec", BEYOND)
    def test_beyond_limits_takes_the_plain_version(self, spec):
        enc = self._enc(spec)
        assert not port_gs.dp_cuda.annotates_on_kernel(enc, "cuda")
        assert not port_gs.dp_cuda.annotates_on_kernel(enc, "cpu")

    @pytest.mark.parametrize("spec", WITHIN + BEYOND)
    def test_cpu_tensor_runs_the_plain_version_uncounted(self, spec):
        enc = self._enc(spec)
        masks = torch.from_numpy(TARGET_MASK_TABLE[_contig(5, 900)])
        launches = dict(port_gs.dp_cuda.launches)
        got = port_gs.annotate_genome_pam(masks, enc)
        assert port_gs.dp_cuda.launches == launches
        assert torch.equal(got, port_gs.annotate_genome_pam_reference(masks, enc))

    @pytest.mark.parametrize("spec", WITHIN + BEYOND)
    def test_route_follows_the_rule(self, spec, monkeypatch):
        """With the rule evaluated as for a CUDA tensor, a spec within the
        limits goes to ``dp_cuda.pam_annotate`` and one beyond them to the
        plain version, which counts no launch."""
        enc = self._enc(spec)
        rule = port_gs.dp_cuda.annotates_on_kernel
        called = []

        def kernel(genome, pam_spec):
            called.append(pam_spec)
            return port_gs.annotate_genome_pam_reference(genome, pam_spec)

        monkeypatch.setattr(port_gs.dp_cuda, "annotates_on_kernel",
                            lambda s, _device: rule(s, "cuda"))
        monkeypatch.setattr(port_gs.dp_cuda, "pam_annotate", kernel)
        masks = torch.from_numpy(TARGET_MASK_TABLE[_contig(8, 300)])
        launches = dict(port_gs.dp_cuda.launches)
        got = port_gs.annotate_genome_pam(masks, enc)
        assert called == ([enc] if spec in self.WITHIN else [])
        assert port_gs.dp_cuda.launches == launches
        assert torch.equal(got, port_gs.annotate_genome_pam_reference(masks, enc))

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        enc = port_gs.encode_pam_spec((("nrg",), 1, 3))
        with pytest.raises(ValueError, match="CUDA tensor"):
            port_gs.dp_cuda.pam_annotate(torch.zeros(64, dtype=torch.uint8), enc)
        with pytest.raises(ValueError, match="1-D uint8"):
            port_gs.dp_cuda.pam_annotate(torch.zeros(64, dtype=torch.int32), enc)


class TestFlagBitPacking:
    @pytest.mark.parametrize("shape", [(2, 128), (2, 8192), (4, 2, 1024), (1, 8)])
    def test_roundtrip_and_matches_jax(self, shape):
        flags = np.random.default_rng(3).random(shape) < 0.07
        packed = port_gs._pack_flag_bits(torch.from_numpy(flags)).numpy()
        want = np.asarray(jax_gs._pack_flag_bits(jnp.asarray(flags)))
        np.testing.assert_array_equal(packed, want)
        np.testing.assert_array_equal(
            port_gs._unpack_flag_bits(packed, shape[-1]), flags
        )

    def test_unpack_trims_padding(self):
        flags = np.zeros((2, 16), bool)
        flags[:, 15] = True
        packed = port_gs._pack_flag_bits(torch.from_numpy(flags)).numpy()
        out = port_gs._unpack_flag_bits(packed, 10)
        assert out.shape == (2, 10) and not out.any()


def _screens(window, batch_windows=1024):
    port = port_gs.GenomeScreen(
        SCORER, "cpu", window=window, batch_windows=batch_windows
    )
    jax_screen = jax_gs.GenomeScreen(
        SCORER, window=window, batch_windows=batch_windows, use_pallas=True,
        interpret=True, pack_staging=False,
    )
    return port, jax_screen


def _concat(segs):
    flags, ranges, spans = [], [], []
    for i0, n_seg, resolve in segs:
        cf, cr = resolve()
        assert cf.shape == (2, n_seg) and cr.shape == (2, n_seg, 2)
        flags.append(cf)
        ranges.append(cr)
        spans.append((i0, n_seg))
    return np.concatenate(flags, axis=1), np.concatenate(ranges, axis=1), spans


class TestScreenAgainstJax:
    """Whole-contig screens against the Pallas path in interpret mode."""

    @pytest.mark.parametrize(
        "window,n_bases,gate",
        [(256, 30_011, True), (256, 30_011, False), (2500, 20_003, True)],
    )
    def test_screen_contig(self, window, n_bases, gate):
        bases = _contig(window, n_bases, plant_at=(1_001, n_bases // 2, n_bases - 40))
        port, jax_screen = _screens(window)
        dpq = GUIDE.guide_fw
        step = window - (len(dpq) + 5 + 3 - 1)
        ms = 60 * len(dpq) - 5 * 122
        pam_spec = (tuple(GUIDE.pams_fw), 1, 3) if gate else None
        args = (n_bases, step, dpq, revcomp(dpq), ms)
        g_port, g_jax = port.stage(bases), jax_screen.stage(bases)
        got = port.screen_contig(g_port, *args, pam_spec=pam_spec,
                                 return_ranges=True)
        want = jax_screen.screen_contig(g_jax, *args, pam_spec=pam_spec,
                                        return_ranges=True)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].any(), "no planted hit flagged"
        got_async = _concat(port.screen_contig_async(
            g_port, *args, pam_spec=pam_spec, segments=3))
        want_async = _concat(jax_screen.screen_contig_async(
            g_jax, *args, pam_spec=pam_spec, segments=3))
        assert got_async[2] == want_async[2]
        np.testing.assert_array_equal(got_async[0], want_async[0])
        np.testing.assert_array_equal(got_async[1], want_async[1])

    def test_segmented_small_windows(self):
        """Window 40: thousands of windows in five batches, so segments
        1, 3 and 7 give different partitions; the ragged contig tail
        leaves the last windows running into the zero padding."""
        window, n_bases = 40, 60_007
        bases = _contig(40, n_bases, plant_at=(5_001, 33_333, n_bases - 30))
        port, jax_screen = _screens(window)
        dpq = GUIDE.guide_fw
        step = 13
        ms = 60 * len(dpq) - 5 * 122
        pam_spec = (tuple(GUIDE.pams_fw), 1, 3)
        g_port, g_jax = port.stage(bases), jax_screen.stage(bases)
        args = (n_bases, step, dpq, revcomp(dpq), ms)
        single = port.screen_contig(g_port, *args, pam_spec=pam_spec,
                                    return_ranges=True)
        for segments in (1, 3, 7):
            got = _concat(port.screen_contig_async(
                g_port, *args, pam_spec=pam_spec, segments=segments))
            want = _concat(jax_screen.screen_contig_async(
                g_jax, *args, pam_spec=pam_spec, segments=segments))
            assert got[2] == want[2]  # the same segment partition
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], single[0])
            np.testing.assert_array_equal(got[1], single[1])
        assert single[0].any()


class TestSegmentedScreen:
    def test_segments_equal_single_span(self):
        bases = _contig(41, 300_000, plant_at=(5_000, 123_457, 250_101))
        screen = port_gs.GenomeScreen(SCORER, "cpu", window=256, batch_windows=512)
        g = screen.stage(bases)
        dpq = GUIDE.guide_fw
        ms = 60 * len(dpq) - 5 * 122
        pam_spec = (tuple(GUIDE.pams_fw), 1, 3)
        args = (len(bases), 230, dpq, revcomp(dpq), ms)
        flags1, ranges1 = screen.screen_contig(
            g, *args, pam_spec=pam_spec, return_ranges=True
        )
        for segments in (None, 3, 7):
            flags2, ranges2, spans = _concat(screen.screen_contig_async(
                g, *args, pam_spec=pam_spec, segments=segments))
            assert spans == screen.segment_spans(flags1.shape[1], segments)
            assert [i0 for i0, _ in spans] == list(
                np.cumsum([0] + [n for _, n in spans])[:-1]
            )
            np.testing.assert_array_equal(flags2, flags1)
            np.testing.assert_array_equal(ranges2, ranges1)
        assert flags1.any(), "no planted hit flagged"

    def test_return_forms(self):
        bases = _contig(2, 5_000, plant_at=(1_001,))
        screen = port_gs.GenomeScreen(SCORER, "cpu", window=256)
        g = screen.stage(bases)
        dpq = GUIDE.guide_fw
        args = (len(bases), 230, dpq, revcomp(dpq), 60 * 20 - 5 * 122)
        chains = screen.screen_contig(g, *args, return_chains=True)
        assert chains.shape == (2, 22)
        np.testing.assert_array_equal(screen.screen_contig(g, *args), chains.any(0))
        empty = screen.screen_contig(g, 1, 230, dpq, revcomp(dpq), 0,
                                     return_ranges=True)
        assert empty[0].shape == (2, 0) and empty[1].shape == (2, 0, 2)
        assert screen.screen_contig_async(g, 1, 230, dpq, revcomp(dpq), 0) == []


class TestWideWindowRanges:
    def test_range_block_widths(self):
        for w, rb in [(256, 8), (2048, 8), (2049, 16), (4096, 16), (8192, 32),
                      (16384, 64), (32768, 128), (65536, 256)]:
            assert port_gs.range_block(w) == rb == jax_gs.range_block(w)
        for w in (2048, 16384, 32768, 1 << 20):
            assert w <= 256 * port_gs.range_block(w)

    def test_wide_ranges_bound_qualifying_columns(self):
        window = 4096
        n_bases = 14_000
        bases = _contig(7, n_bases, plant_at=(1_001, 4_667, 10_501))
        screen = port_gs.GenomeScreen(SCORER, "cpu", window=window)
        dpq = GUIDE.guide_fw
        step = window - 64
        ms = 60 * len(dpq) - 2 * 122
        flags, ranges = screen.screen_contig(
            screen.stage(bases), n_bases, step, dpq, revcomp(dpq), ms,
            return_ranges=True,
        )
        rb = port_gs.range_block(window)
        masks = np.zeros(n_bases + window, np.uint8)
        masks[:n_bases] = TARGET_MASK_TABLE[bases]
        starts = screen.window_starts(n_bases, step)
        wins = torch.from_numpy(np.stack([masks[s : s + window] for s in starts]))
        kw = dict(match=SCORER.match_score, mismatch=SCORER.mismatch_score,
                  qgap=SCORER.query_gap_score, tgap=SCORER.target_gap_score)
        any_hit = False
        for c, q in enumerate((dpq, revcomp(dpq))):
            rows = port_dp._final_rows(
                torch.from_numpy(encode_query(q)), wins, **kw
            ).numpy()
            for i in range(len(starts)):
                qual = np.nonzero(rows[i] >= ms)[0] + 1
                assert flags[c, i] == bool(len(qual))
                if not len(qual):
                    continue
                any_hit = True
                lo = int(ranges[c, i, 0]) * rb + 1
                hi = (int(ranges[c, i, 1]) + 1) * rb
                assert lo <= qual.min() and qual.max() <= hi
                assert qual.min() - lo < rb and hi - qual.max() < rb
        assert any_hit, "no planted hit qualified"


class TestBatchWindowsFor:
    """The batch sizing that shapes the segment partition, pinned to the
    reference's numbers."""

    def _screen(self, window, batch_windows=8192):
        return port_gs.GenomeScreen(
            SCORER, "cpu", window=window, batch_windows=batch_windows
        )

    def test_rounds_configured_batch_up_to_unit(self):
        s = self._screen(1024)
        assert s._batch_windows_for(1_000_000, 128) == 8192
        s.batch_windows = 8000
        assert s._batch_windows_for(1_000_000, 384) == 8064

    def test_trims_to_window_count(self):
        s = self._screen(1024)
        assert s._batch_windows_for(5, 128) == 128
        assert s._batch_windows_for(129, 128) == 256
        assert s._batch_windows_for(8192, 128) == 8192

    def test_budget_cap_at_wide_windows(self):
        s = self._screen(16384)
        bw = s._batch_windows_for(1_000_000, 128)
        assert bw * s.window <= port_gs.GenomeScreen.BATCH_ELEM_BUDGET
        assert bw == (port_gs.GenomeScreen.BATCH_ELEM_BUDGET // 16384) // 128 * 128

    def test_cap_never_below_unit(self):
        assert self._screen(1 << 24)._batch_windows_for(1_000_000, 128) == 128

    @pytest.mark.parametrize(
        "n,window,want",
        [
            (1, 1000, [(0, 1)]),
            (41_110, 1000, [(0, 41_110)]),  # chr21-scale: 6 batches, 1 span
            (200_000, 1000, [(i * 40_960, 40_960) for i in range(4)]
             + [(163_840, 36_160)]),  # 25 batches: 5 segments of 5
            (1_030_000, 1000, [(i * 65_536, 65_536) for i in range(15)]
             + [(983_040, 46_960)]),  # 1 Gb: 16 segments of 8 batches
            (20_000, 40, [(0, 20_000)]),
        ],
    )
    def test_segment_spans(self, n, window, want):
        """The reference's partition: whole batches per segment, at most
        SEGMENTS segments of at least MIN_BATCHES_PER_SEGMENT batches."""
        assert self._screen(window).segment_spans(n) == want
