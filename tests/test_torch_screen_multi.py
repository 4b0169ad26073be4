"""The port's multi-guide screen against the JAX package, bit for bit:
the plain version ``screen_multi_reference`` against the Pallas kernel
``_pallas_screen_multi`` in interpret mode; the multi-guide contig screen
against ``GenomeScreen(use_pallas=True, interpret=True)`` and against each
guide's own dual-chain screen; the slot screen against
``_slot_flags_multi(use_pallas=True, interpret=True)`` and, as a superset,
against ``ScreenKernel.max_scores``; and the wrappers' launch counters
under threads.  Mirrors tests/test_screen.py's TestMultiKernelPerChain,
TestMultiGuideFullContract, test_multi_async_wide_window_ranges and
TestSlotFlagsMulti.  The screen is exact int32 DP, so every comparison is
exact unless a test says it checks a superset."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calitas_tpu.ops.genome_screen as jax_gs
from calitas_tpu.core.guide import Guide
from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu.core.sequence import TARGET_MASK_TABLE, encode_query, revcomp
from calitas_tpu.ops.dp_pallas2 import _pallas_screen_multi, pack_tcols_jax
from calitas_tpu.ops.dp_screen import ScreenKernel
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops import dp_screen as port_dp
from calitas_tpu_torch.ops import genome_screen as port_gs

SCORER = derive_scorer()
SKW = dict(
    match=SCORER.match_score, mismatch=SCORER.mismatch_score,
    qgap=SCORER.query_gap_score, tgap=SCORER.target_gap_score,
)
B = 1024  # one Pallas grid cell of windows
G = 3


def _qvals(rng, Q, g=G):
    return rng.integers(1, 16, size=(g, 2, Q)).astype(np.int32)


def _multi_port(wins, qvals, mss, pam_gate, emit_ranges):
    n, T = wins.shape
    genome = torch.from_numpy(np.ascontiguousarray(wins).reshape(-1))
    best, ranges = port_dp.screen_multi_reference(
        genome, qvals, mss, base0=0, step=T, n_windows=n, window=T,
        pam_gate=pam_gate, emit_ranges=emit_ranges, **SKW
    )
    return best.numpy(), None if ranges is None else ranges.numpy()


class TestMultiReferenceAgainstPallas:
    # T % 4 in {0, 1, 2, 3}: the packed kernel masks the last word's tail
    @pytest.mark.parametrize(
        "Q,T,pam_gate,emit_ranges",
        [(12, 40, False, False), (20, 63, True, True), (20, 62, False, True),
         (23, 45, True, False), (7, 64, True, True)],
    )
    def test_matches_pallas_interpret(self, Q, T, pam_gate, emit_ranges):
        rng = np.random.default_rng(100 * Q + T)
        qvals = _qvals(rng, Q)
        wins = rng.integers(0, 64, size=(B, T), dtype=np.uint8)  # gate bits too
        best0, _ = _multi_port(wins, qvals, np.zeros(G, np.int32), pam_gate, False)
        # each guide its own threshold: some windows qualify, some do not
        mss = np.array(
            [int(np.quantile(best0[g], q)) for g, q in zip(range(G), (.3, .5, .8))],
            np.int32,
        )
        best, ranges = _multi_port(wins, qvals, mss, pam_gate, emit_ranges)
        want = _pallas_screen_multi(
            jnp.asarray(qvals), pack_tcols_jax(jnp.asarray(wins)),
            jnp.asarray(mss), Q=Q, pam_gate=pam_gate, emit_ranges=emit_ranges,
            T=T, interpret=True, **SKW
        )
        if emit_ranges:
            want_best, want_ranges = want
            np.testing.assert_array_equal(
                ranges, np.asarray(want_ranges).reshape(G, 2, 2, B)
            )
            for g in range(G):  # ranges count each guide's own threshold
                assert ((best[g] >= mss[g]) == (ranges[g, :, 1] > 0)).all()
        else:
            want_best = want
            assert ranges is None
        np.testing.assert_array_equal(best, np.asarray(want_best).reshape(G, 2, B))

    def test_unpacked_columns_match_pallas_interpret(self):
        rng = np.random.default_rng(5)
        Q, T = 16, 33
        qvals = _qvals(rng, Q)
        wins = rng.integers(0, 16, size=(B, T), dtype=np.uint8)
        best, _ = _multi_port(wins, qvals, np.zeros(G, np.int32), False, False)
        tcols = jnp.asarray(wins.T.astype(np.int32).reshape(T, B // 128, 128))
        want = _pallas_screen_multi(jnp.asarray(qvals), tcols, Q=Q, interpret=True, **SKW)
        np.testing.assert_array_equal(best, np.asarray(want).reshape(G, 2, B))


def test_multi_reference_equals_dual_per_guide():
    """Each guide of the plain multi screen is that guide's dual screen,
    on a grid that runs past the genome's end (read as zero)."""
    rng = np.random.default_rng(6)
    Q, T = 20, 77
    genome = torch.from_numpy(rng.integers(0, 64, size=5_000, dtype=np.uint8))
    qvals = _qvals(rng, Q, g=4)
    mss = np.array([300, 600, 800, -(10**6)], np.int32)
    grid = dict(base0=11, step=41, n_windows=130, window=T, pam_gate=True, **SKW)
    best, ranges = port_dp.screen_multi_reference(
        genome, qvals, mss, emit_ranges=True, **grid
    )
    for g in range(4):
        b, r = port_dp.screen_dual_reference(
            genome, qvals[g], min_score=int(mss[g]), **grid
        )
        assert torch.equal(best[g], b) and torch.equal(ranges[g], r)


class TestWrapper:
    KW = dict(base0=0, step=8, n_windows=4, window=8, pam_gate=False,
              emit_ranges=True, **SKW)

    def test_routes_cpu_tensors_to_the_plain_version(self):
        rng = np.random.default_rng(9)
        qvals = _qvals(rng, 8)
        mss = np.array([0, 100, 200], np.int32)
        genome = torch.from_numpy(rng.integers(0, 64, size=300, dtype=np.uint8))
        kw = dict(self.KW, step=20, n_windows=12, window=30, pam_gate=True)
        launches = dict(dp_cuda.launches)
        calls = port_dp.reference_calls["cpu"]
        got = dp_cuda.screen_multi(genome, qvals, mss, **kw)
        want = port_dp.screen_multi_reference(genome, qvals, mss, **kw)
        assert dp_cuda.launches == launches
        assert port_dp.reference_calls["cpu"] == calls + 2
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    @pytest.mark.parametrize(
        "qvals,mss",
        [(np.ones((3, 2, 4)), np.zeros(2)), (np.ones((2, 4)), np.zeros(2)),
         (np.ones((1, 3, 4)), np.zeros(1)), (np.full((1, 2, 4), 16), np.zeros(1)),
         (np.ones((0, 2, 4)), np.zeros(0))],
    )
    def test_rejects_what_the_kernel_does_not_take(self, qvals, mss):
        with pytest.raises(ValueError):
            dp_cuda.screen_multi(
                torch.zeros(64, dtype=torch.uint8), qvals, mss, **self.KW
            )

    def test_rejects_other_devices(self):
        genome = torch.zeros(64, dtype=torch.uint8, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            dp_cuda.screen_multi(genome, np.ones((1, 2, 4)), np.zeros(1), **self.KW)


def test_launch_counter_is_thread_safe():
    """Eight threads count launches at once, as the variant feed and the
    reference pass do: no increment is lost."""
    per_thread = 20_000
    saved = dict(dp_cuda.launches)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        dp_cuda.reset_launches()
        start = threading.Barrier(8)

        def count(name):
            start.wait(timeout=30)
            for _ in range(per_thread):
                dp_cuda._count_launch(name)

        threads = [
            threading.Thread(target=count, args=(name,))
            for name in ["screen_multi"] * 4 + ["screen_dual"] * 2
            + ["screen_rows"] * 2
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert dp_cuda.launches == {
            "screen_multi": 4 * per_thread, "screen_dual": 2 * per_thread,
            "screen_rows": 2 * per_thread,
        }
    finally:
        sys.setswitchinterval(interval)
        dp_cuda.launches.update(saved)


GUIDES = [
    Guide.parse("CTTGCCCCACAGGGCAGTAAnrg"),
    Guide.parse("ACGTACATGCTCGATACGACnrg"),
    Guide.parse("TTGACCAAGCAAAACAGACCnrg"),
]


def _contig(seed, n):
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n, p=[.24] * 4 + [.04])
    for g, pos in zip(GUIDES, (1_000, n // 2, n - 60)):
        site = np.frombuffer((g.guide + "AGG").encode(), np.uint8)
        if pos % 2:
            site = np.frombuffer(revcomp(site.tobytes().decode()).encode(), np.uint8)
        bases[pos : pos + len(site)] = site
    return bases.astype(np.uint8)


def _concat(segs, axis):
    flags, ranges, spans = [], [], []
    for i0, n_seg, resolve in segs:
        cf, cr = resolve()
        assert cf.shape[axis] == n_seg and cr.shape[axis] == n_seg
        flags.append(cf)
        ranges.append(cr)
        spans.append((i0, n_seg))
    return np.concatenate(flags, axis=axis), np.concatenate(ranges, axis=axis), spans


class TestContigMultiScreen:
    DQS = [(g.guide_fw, revcomp(g.guide_fw)) for g in GUIDES]
    MSS = [60 * len(g.guide_fw) - k * 122 for g, k in zip(GUIDES, (5, 4, 3))]

    @pytest.mark.parametrize("gate", [True, False])
    def test_matches_jax_pallas_and_per_guide_dual(self, gate):
        n_bases, window, step = 40_011, 64, 37  # 1,082 windows: two batches
        bases = _contig(77, n_bases)
        port = port_gs.GenomeScreen(SCORER, "cpu", window=window, batch_windows=1024)
        jax_screen = jax_gs.GenomeScreen(
            SCORER, window=window, batch_windows=1024, use_pallas=True,
            interpret=True, pack_staging=False,
        )
        pam_spec = (tuple(GUIDES[0].pams_fw), 1, 3) if gate else None
        g_port, g_jax = port.stage(bases), jax_screen.stage(bases)
        args = (n_bases, step, self.DQS, self.MSS)
        got = _concat(port.screen_contig_multi_async(
            g_port, *args, pam_spec=pam_spec, segments=2), axis=2)
        want = _concat(jax_screen.screen_contig_multi_async(
            g_jax, *args, pam_spec=pam_spec, segments=2), axis=2)
        assert got[2] == want[2] and len(got[2]) == 2  # the same segments
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        hit_windows = 0
        for gi, (dq, dq_rc) in enumerate(self.DQS):
            single = _concat(port.screen_contig_async(
                g_port, n_bases, step, dq, dq_rc, self.MSS[gi],
                pam_spec=pam_spec, segments=2), axis=1)
            np.testing.assert_array_equal(got[0][gi], single[0])
            np.testing.assert_array_equal(got[1][gi], single[1])
            hit_windows += int(single[0].any(axis=0).sum())
        assert hit_windows >= len(GUIDES)  # planted sites flagged

    def test_wide_window_ranges(self):
        """Window 4096 (16-column range blocks): flags and ranges equal
        each guide's own screen and the JAX package's (no gate, so the
        XLA path is exact here)."""
        n_bases, window, step = 30_000, 4096, 4000
        bases = _contig(78, n_bases)
        port = port_gs.GenomeScreen(SCORER, "cpu", window=window, batch_windows=256)
        jax_screen = jax_gs.GenomeScreen(
            SCORER, window=window, batch_windows=256, use_pallas=False,
            pack_staging=False,
        )
        g_port, g_jax = port.stage(bases), jax_screen.stage(bases)
        args = (n_bases, step, self.DQS, self.MSS)
        got = _concat(port.screen_contig_multi_async(g_port, *args), axis=2)
        want = _concat(jax_screen.screen_contig_multi_async(g_jax, *args), axis=2)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert port_gs.range_block(window) == 16
        any_hits = 0
        for gi, (dq, dq_rc) in enumerate(self.DQS):
            flags, ranges = port.screen_contig(
                g_port, n_bases, step, dq, dq_rc, self.MSS[gi], return_ranges=True
            )
            np.testing.assert_array_equal(got[0][gi], flags)
            np.testing.assert_array_equal(got[1][gi], ranges)
            any_hits += int(flags.any(axis=0).sum())
        assert any_hits >= len(GUIDES)

    def test_flags_only_screen_matches_jax(self):
        n_bases = 20_003
        bases = _contig(79, n_bases)
        port = port_gs.GenomeScreen(SCORER, "cpu", window=128)
        jax_screen = jax_gs.GenomeScreen(
            SCORER, window=128, use_pallas=True, interpret=True, pack_staging=False
        )
        args = (n_bases, 100, self.DQS, self.MSS)
        got = port_gs.screen_contig_multi(port, port.stage(bases), *args)
        want = jax_gs.screen_contig_multi(jax_screen, jax_screen.stage(bases), *args)
        assert got.shape == (G, 2, len(port.window_starts(n_bases, 100)))
        np.testing.assert_array_equal(got, want)
        assert got.any()
        assert port_gs.screen_contig_multi(port, port.stage(bases), 1, 100,
                                           self.DQS, self.MSS).shape == (G, 2, 0)
        assert port.screen_contig_multi_async(port.stage(bases), 1, 100,
                                              self.DQS, self.MSS) == []


class TestSlotFlagsMulti:
    def _batch(self, rng, n, T):
        tmasks = np.zeros((n, T), np.uint8)
        lengths = rng.integers(8, T + 1, size=n).astype(np.int32)
        for i in range(n):
            seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), lengths[i])
            tmasks[i, : lengths[i]] = TARGET_MASK_TABLE[seq]
        return tmasks, lengths

    def _groups(self, rng, lengths_q, mss):
        groups = []
        for Q in lengths_q:
            qs = ["".join(rng.choice(list("ACGT"), Q)) for _ in mss]
            qvals = np.stack(
                [np.stack([encode_query(q), encode_query(revcomp(q))]) for q in qs]
            ).astype(np.int32)
            groups.append((qs, qvals, np.asarray(mss, np.int32)))
        return groups

    @pytest.mark.parametrize("T", [64, 61])
    def test_matches_pallas_interpret(self, T):
        rng = np.random.default_rng(13 + T)
        tmasks, lengths = self._batch(rng, B, T)
        [(_qs, qvals, mss)] = self._groups(rng, [20], [300, 600, 900])
        [resolve] = port_gs.screen_slots_multi(SCORER, tmasks, [(qvals, mss)], "cpu")
        got = resolve()
        packed = jax_gs._slot_flags_multi(
            jnp.asarray(qvals), jnp.asarray(tmasks), jnp.asarray(lengths),
            jnp.asarray(mss), Q=20, G=G, use_pallas=True, interpret=True, **SKW
        )
        np.testing.assert_array_equal(got, jax_gs._unpack_flag_bits(np.asarray(packed), B))
        direct = port_gs._slot_flags_multi(SCORER, torch.from_numpy(tmasks), qvals, mss)
        np.testing.assert_array_equal(direct.numpy(), np.asarray(packed))
        assert got.shape == (G, B) and got.any() and not got.all()

    def test_superset_of_length_honouring_scores(self):
        """Slot lengths are ignored: the flags cover every flag the
        length-honouring screen raises, and equal it on full-length
        slots.  Two query lengths: two groups over one upload."""
        rng = np.random.default_rng(21)
        T = 64
        tmasks, lengths = self._batch(rng, 256, T)
        full = rng.random(256) < 0.5
        lengths[full] = T
        groups = self._groups(rng, [18, 24], [0, 400, 10**9])
        resolvers = port_gs.screen_slots_multi(
            SCORER, tmasks, [(qv, ms) for _qs, qv, ms in groups], "cpu"
        )
        kernel = ScreenKernel(SCORER)
        for (qs, _qv, mss), resolve in zip(groups, resolvers):
            got = resolve()
            for g, q in enumerate(qs):
                bf = kernel.max_scores(encode_query(q), tmasks, lengths)
                br = kernel.max_scores(encode_query(revcomp(q)), tmasks, lengths)
                exact = (bf >= mss[g]) | (br >= mss[g])
                assert (got[g] | exact == got[g]).all()  # no false negatives
                np.testing.assert_array_equal(got[g][full], exact[full])
            assert not got[2].any()  # an unreachable threshold flags nothing

    def test_batch_unit(self):
        assert port_gs.slot_batch_unit(True) == port_gs.BATCH_UNIT == 1024
        assert port_gs.slot_batch_unit(False) == 8
