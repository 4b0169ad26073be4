"""The port's row screen (``screen_rows_reference``, ``ScreenKernel``,
``CudaScreenKernel``, the ``screen_rows`` wrapper) against the JAX
package, bit for bit: in shared-query mode against the Pallas kernel
``_kernel`` (``PallasScreenKernelV2`` in interpret mode) and the XLA
``ScreenKernel``; in per-row mode against the pair screen's XLA scans
``_pair_scores_dual[_ranges]``.  The screen is exact int32 DP, so every
comparison is exact (tolerance 0).  The CUDA kernel against its plain
version is marked ``cuda`` and skips without a card; the JAX package is
imported inside the tests that use it, so the card's machine, which has
no jax, collects this file and runs those with
``python -m pytest tests/test_torch_screen_rows.py -m cuda``."""

import numpy as np
import pytest
import torch

from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops import dp_screen as port_dp

SCORER = derive_scorer()
SKW = dict(
    match=SCORER.match_score, mismatch=SCORER.mismatch_score,
    qgap=SCORER.query_gap_score, tgap=SCORER.target_gap_score,
)
NEG_INF = port_dp.NEG_INF
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _shared_case(seed, B=1024, T=64, Q=12):
    rng = np.random.default_rng(seed)
    qmask = rng.integers(1, 16, size=Q, dtype=np.uint8)
    tmasks = rng.integers(0, 16, size=(B, T), dtype=np.uint8)
    tmasks[5, 10 : 10 + Q] = qmask  # a perfect hit
    lengths = rng.integers(0, T + 1, size=B).astype(np.int32)
    lengths[:4] = [0, T, T + 7, 1]  # empty, full, past the end, one column
    lengths[5] = T
    return qmask, tmasks, lengths


@pytest.mark.parametrize("seed", [0, 1])
def test_shared_query_matches_pallas_interpret_and_xla(seed):
    """One Pallas grid cell (B 1024, T 64, Q 12) with ragged lengths,
    including 0 and T: the port == PallasScreenKernelV2(interpret) ==
    the XLA _screen_scores."""
    from calitas_tpu.ops import dp_screen as jax_dp
    from calitas_tpu.ops.dp_pallas2 import PallasScreenKernelV2

    qmask, tmasks, lengths = _shared_case(seed)
    pallas = PallasScreenKernelV2(SCORER, interpret=True).max_scores(
        qmask, tmasks, lengths
    )
    xla = np.asarray(jax_dp._screen_scores(qmask, tmasks, lengths, **SKW))
    np.testing.assert_array_equal(pallas, xla)
    best, ranges = port_dp.screen_rows_reference(
        qmask[None], torch.from_numpy(tmasks), torch.from_numpy(lengths), **SKW
    )
    assert ranges is None
    np.testing.assert_array_equal(best[0].numpy(), pallas)
    assert best[0, 0] == NEG_INF and best[0, 5] == SCORER.match_score * 12
    port_kernel = dp_cuda.CudaScreenKernel(SCORER, "cpu")
    np.testing.assert_array_equal(
        port_kernel.max_scores(qmask, tmasks, lengths), pallas
    )


@pytest.mark.parametrize(
    "kernel_cls", [port_dp.ScreenKernel, dp_cuda.CudaScreenKernel]
)
def test_screen_kernel_defaults_to_the_card(kernel_cls, monkeypatch):
    """``ScreenKernel(scorer)`` and ``CudaScreenKernel(scorer)`` resolve
    to ``cuda``: without a card they raise, and they run on the CPU only
    when asked for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        kernel_cls(SCORER)
    with pytest.raises(RuntimeError, match="is_available"):
        kernel_cls(SCORER, "cuda")
    assert kernel_cls(SCORER, "cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert kernel_cls(SCORER).device == torch.device("cuda", 0)


def test_shared_query_ranges_match_xla():
    from calitas_tpu.ops import dp_screen as jax_dp

    qmask, tmasks, lengths = _shared_case(2, B=64, T=50, Q=9)
    best = np.asarray(jax_dp._screen_scores(qmask, tmasks, lengths, **SKW))
    ms = int(np.median(best))
    want = jax_dp._screen_scores_ranges(qmask, tmasks, lengths, ms, **SKW)
    got_best, got_ranges = port_dp.screen_rows_reference(
        qmask[None], torch.from_numpy(tmasks), torch.from_numpy(lengths),
        np.full(64, ms, np.int32), **SKW,
    )
    np.testing.assert_array_equal(got_best[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got_ranges[0, 0].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got_ranges[0, 1].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize(
    "kernel_cls", [port_dp.ScreenKernel, dp_cuda.CudaScreenKernel]
)
def test_screen_kernel_api_matches_jax(kernel_cls):
    """Every method of the port's ScreenKernel (and of the kernel-backed
    CudaScreenKernel) equals the JAX ScreenKernel's."""
    from calitas_tpu.ops import dp_screen as jax_dp

    rng = np.random.default_rng(3)
    q1 = rng.integers(1, 16, size=20, dtype=np.uint8)
    q2 = rng.integers(1, 16, size=7, dtype=np.uint8)
    tmasks = rng.integers(0, 16, size=(33, 70), dtype=np.uint8)
    lengths = rng.integers(0, 71, size=33).astype(np.int32)
    jk = jax_dp.ScreenKernel(SCORER)
    pk = kernel_cls(SCORER, torch.device("cpu"))
    jprep = jk.prepare_targets(tmasks, lengths)
    pprep = pk.prepare_targets(tmasks, lengths)
    for q in (q1, q2):  # one prepared batch serves every query
        np.testing.assert_array_equal(
            pk.max_scores_prepared_async(q, pprep)(),
            jk.max_scores_prepared_async(q, jprep)(),
        )
    np.testing.assert_array_equal(
        pk.max_scores_async(q1, tmasks, lengths)(),
        jk.max_scores_async(q1, tmasks, lengths)(),
    )
    np.testing.assert_array_equal(
        pk.max_scores(q2, tmasks, lengths), jk.max_scores(q2, tmasks, lengths)
    )
    np.testing.assert_array_equal(
        pk.final_rows(q1, tmasks), jk.final_rows(q1, tmasks)
    )


def test_cuda_screen_kernel_supports_what_the_kernel_takes():
    from calitas_tpu.ops.dp_pallas2 import PallasScreenKernelV2

    assert PallasScreenKernelV2.supports(48) and not PallasScreenKernelV2.supports(49)
    for q in (1, 20, 48, 49, 50):
        assert dp_cuda.CudaScreenKernel.supports(q) == PallasScreenKernelV2.supports(q)


def _per_row_case(seed, Q, slot, B):
    rng = np.random.default_rng(seed)
    qa = rng.integers(1, 16, size=(B, Q), dtype=np.uint8)
    qb = rng.integers(1, 16, size=(B, Q), dtype=np.uint8)
    tmasks = rng.integers(0, 16, size=(B, slot), dtype=np.uint8)
    lengths = rng.integers(0, slot + 1, size=B).astype(np.int32)
    lengths[:2] = [0, slot]
    if Q <= slot // 2:  # one row with a perfect chain-A hit inside its length
        tmasks[2, 3 : 3 + Q] = qa[2]
        lengths[2] = max(lengths[2], 3 + Q)
    return qa, qb, tmasks, lengths, rng


PER_ROW_CASES = [  # (seed, Q, slot, B)
    (10, 1, 64, 64), (11, 20, 64, 64), (12, 24, 128, 48), (13, 48, 128, 40),
    (14, 50, 64, 32), (15, 20, 8192, 12), (16, 48, 8192, 8), (17, 24, 64, 17),
]


@pytest.mark.parametrize("seed,Q,slot,B", PER_ROW_CASES)
def test_per_row_matches_pair_scores_dual(seed, Q, slot, B):
    from calitas_tpu.ops.pair_screen import (
        _pair_scores_dual,
        _pair_scores_dual_ranges,
    )

    qa, qb, tmasks, lengths, rng = _per_row_case(seed, Q, slot, B)
    want = np.asarray(_pair_scores_dual(qa, qb, tmasks, lengths, **SKW))
    best, ranges = port_dp.screen_rows_reference(
        np.stack([qa, qb]), torch.from_numpy(tmasks), torch.from_numpy(lengths),
        **SKW,
    )
    assert ranges is None
    np.testing.assert_array_equal(best.numpy().reshape(-1), want)

    # per-row thresholds: around each row's best, plus rows whose
    # threshold admits the masked end columns (<= NEG_INF) or nothing
    ms = (want[:B] - rng.integers(0, 300, size=B)).astype(np.int32)
    ms[0], ms[1] = NEG_INF, NEG_INF - 5
    ms[-1] = 2**30
    wb, wmn, wmx = (
        np.asarray(x)
        for x in _pair_scores_dual_ranges(qa, qb, tmasks, lengths, ms, **SKW)
    )
    best, ranges = port_dp.screen_rows_reference(
        np.stack([qa, qb]), torch.from_numpy(tmasks), torch.from_numpy(lengths),
        ms, **SKW,
    )
    np.testing.assert_array_equal(best.numpy().reshape(-1), wb)
    np.testing.assert_array_equal(ranges[:, 0].numpy().reshape(-1), wmn)
    np.testing.assert_array_equal(ranges[:, 1].numpy().reshape(-1), wmx)
    assert len(np.unique(wmn)) > 2  # qualifying columns vary


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    qa, qb, tmasks, lengths, _ = _per_row_case(20, 12, 64, 16)
    tm, ln = torch.from_numpy(tmasks), torch.from_numpy(lengths)
    ms = np.full(16, 300, np.int32)
    for q in (qa[:1], np.stack([qa, qb])):
        launches = dict(dp_cuda.launches)
        calls = port_dp.reference_calls["cpu"]
        got = dp_cuda.screen_rows(q, tm, ln, ms, **SKW)
        want = port_dp.screen_rows_reference(q, tm, ln, ms, **SKW)
        assert dp_cuda.launches == launches
        assert port_dp.reference_calls["cpu"] == calls + 2
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize(
    "qmasks,tmasks,lengths,min_scores",
    [
        (np.ones((1, 4)), torch.zeros((8, 16), dtype=torch.int32), np.zeros(8), None),
        (np.ones((1, 4)), torch.zeros(16, dtype=torch.uint8), np.zeros(8), None),
        (np.ones((1, 4)), torch.zeros((8, 32), dtype=torch.uint8)[:, ::2],
         np.zeros(8), None),
        (np.ones((4,)), torch.zeros((8, 16), dtype=torch.uint8), np.zeros(8), None),
        (np.ones((2, 7, 4)), torch.zeros((8, 16), dtype=torch.uint8), np.zeros(8), None),
        (np.full((1, 4), 16), torch.zeros((8, 16), dtype=torch.uint8), np.zeros(8), None),
        (np.ones((1, 4)), torch.zeros((8, 16), dtype=torch.uint8), np.zeros(7), None),
        (np.ones((1, 4)), torch.zeros((8, 16), dtype=torch.uint8), np.zeros(8),
         np.zeros(3)),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(qmasks, tmasks, lengths,
                                                       min_scores):
    with pytest.raises(ValueError):
        dp_cuda.screen_rows(qmasks, tmasks, lengths, min_scores, **SKW)


def test_lanes_route_cpu_tensors_to_the_plain_version():
    """``_screen_rows_lanes`` on a CPU tensor runs the plain version and
    launches nothing: the lane count only matters on the card."""
    qa, qb, tmasks, lengths, _ = _per_row_case(21, 9, 64, 16)
    tm, ln = torch.from_numpy(tmasks), torch.from_numpy(lengths)
    ms = np.full(16, 300, np.int32)
    ms[:2] = INT32_MIN, INT32_MAX
    launches = dict(dp_cuda.launches)
    got = dp_cuda._screen_rows_lanes(np.stack([qa, qb]), tm, ln, ms, lanes=4, **SKW)
    want = port_dp.screen_rows_reference(np.stack([qa, qb]), tm, ln, ms, **SKW)
    assert dp_cuda.launches == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("Q,lanes,per_row", [
    (8, 3, True), (8, 8, True), (8, 4, False),  # not built
    (3, 4, True), (1, 2, False),  # over Q
    (8, -1, True), (20, 0, False),  # no lane count
])
def test_lanes_rejects_what_the_library_is_not_built_for(Q, lanes, per_row):
    """An L the library is not built for (3 and 8; shared-query L 4), an
    L over Q, or a lane count that is no count: refused before any route,
    on any device."""
    with pytest.raises(ValueError, match="lanes must be"):
        dp_cuda._screen_rows_lanes(
            np.ones((2, 8, Q) if per_row else (1, Q), np.uint8),
            torch.zeros((8, 16), dtype=torch.uint8), torch.zeros(8, dtype=torch.int32),
            lanes=lanes, **SKW)


def test_rows_lanes_lists_the_built_lane_counts():
    assert dp_cuda.rows_lanes(1, True) == (1,) and dp_cuda.rows_lanes(1, False) == (1,)
    assert dp_cuda.rows_lanes(3, True) == (1, 2)
    assert dp_cuda.rows_lanes(48, True) == (1, 2, 4)
    assert dp_cuda.rows_lanes(48, False) == (1, 2)


def test_prepared_launch_needs_a_cuda_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        dp_cuda._screen_rows_launcher(
            np.ones((1, 4), np.uint8), torch.zeros((8, 16), dtype=torch.uint8),
            torch.zeros(8, dtype=torch.int32), **SKW)


CHUNK_CASES = [  # (seed, Q, slot, B, lengths): the list tools' chunks, small
    (30, 20, 128, 40, (100, 128)),  # pairs20k, slot 128: targets of 100-128 bases
    (31, 24, 256, 36, (129, 200)),  # pairs20k, slot 256: 129-200 bases
    (32, 20, 256, 30, (201, 201)),  # a2r20k at -w 200: every target 201 bases
]


@pytest.mark.parametrize("seed,Q,slot,B,lengths", CHUNK_CASES)
def test_per_row_matches_pair_scores_dual_at_chunk_shapes(seed, Q, slot, B, lengths):
    """The per-row plain version against the JAX pair screen's XLA scans
    at small analogues of the chunks the list tools send: every length in
    (slot/2, slot], per-row thresholds with INT32_MIN and INT32_MAX among
    them.  Tolerance: exact."""
    from calitas_tpu.ops.pair_screen import (
        _pair_scores_dual,
        _pair_scores_dual_ranges,
    )

    qa, qb, tmasks, _lengths, rng = _per_row_case(seed, Q, slot, B)
    lengths = rng.integers(lengths[0], lengths[1] + 1, size=B).astype(np.int32)
    assert (lengths > slot // 2).all() and (lengths <= slot).all()
    tmasks[1, 7 : 7 + Q] = qb[1]  # a perfect chain-B hit inside every length
    want = np.asarray(_pair_scores_dual(qa, qb, tmasks, lengths, **SKW))
    best, ranges = port_dp.screen_rows_reference(
        np.stack([qa, qb]), torch.from_numpy(tmasks), torch.from_numpy(lengths), **SKW)
    assert ranges is None
    np.testing.assert_array_equal(best.numpy().reshape(-1), want)
    assert want[B + 1] == SCORER.match_score * Q

    ms = (want[:B] - rng.integers(0, 300, size=B)).astype(np.int32)
    ms[:4] = INT32_MIN, INT32_MAX, NEG_INF, NEG_INF + 1
    wb, wmn, wmx = (
        np.asarray(x)
        for x in _pair_scores_dual_ranges(qa, qb, tmasks, lengths, ms, **SKW)
    )
    best, ranges = port_dp.screen_rows_reference(
        np.stack([qa, qb]), torch.from_numpy(tmasks), torch.from_numpy(lengths), ms, **SKW)
    np.testing.assert_array_equal(best.numpy().reshape(-1), wb)
    np.testing.assert_array_equal(ranges[:, 0].numpy().reshape(-1), wmn)
    np.testing.assert_array_equal(ranges[:, 1].numpy().reshape(-1), wmx)
    assert wmn[0] == 1 and wmx[0] == slot  # INT32_MIN: every end column, tail included
    assert wmn[1] == slot + 1 and wmx[1] == 0  # INT32_MAX: none


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "Q,T,per_row,with_ranges",
    [(1, 64, False, True), (20, 1000, False, False), (24, 128, False, True),
     (33, 77, False, True), (48, 512, False, True), (1, 64, True, False),
     (20, 256, True, True), (24, 128, True, True), (32, 100, True, True),
     (48, 256, True, False), (48, 64, True, True)],
)
def test_kernel_matches_plain_version(cuda, Q, T, per_row, with_ranges):
    rng = np.random.default_rng(Q * 7919 + T + per_row)
    B = 5000
    tmasks = torch.from_numpy(rng.integers(0, 16, size=(B, T), dtype=np.uint8)).to(cuda)
    lengths = rng.integers(0, T + 1, size=B).astype(np.int32)
    lengths[:3] = [0, T, T + 5]
    ln = torch.from_numpy(lengths).to(cuda)
    shape = (2, B, Q) if per_row else (1, Q)
    qmasks = rng.integers(1, 16, size=shape).astype(np.uint8)
    best0, _ = port_dp.screen_rows_reference(qmasks, tmasks, ln, **SKW)
    ms = None
    if with_ranges:
        ms = (best0.amax(0).cpu().numpy() - rng.integers(0, 400, B)).astype(np.int32)
        ms[3], ms[4] = NEG_INF, 2**30
    launches = dp_cuda.launches["screen_rows"]
    got = dp_cuda.screen_rows(qmasks, tmasks, ln, ms, **SKW)
    torch.cuda.synchronize()
    assert dp_cuda.launches["screen_rows"] == launches + 1
    want = port_dp.screen_rows_reference(qmasks, tmasks, ln, ms, **SKW)
    assert torch.equal(got[0], want[0])
    if with_ranges:
        assert torch.equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.cuda
def test_kernel_rejects_long_queries_and_other_chain_counts(cuda):
    tmasks = torch.zeros((8, 64), dtype=torch.uint8, device=cuda)
    ln = torch.full((8,), 64, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="uses_kernel"):
        dp_cuda.screen_rows(np.ones((1, 49), np.uint8), tmasks, ln, **SKW)
    with pytest.raises(ValueError, match="CUDA row screen"):
        dp_cuda.screen_rows(np.ones((2, 8), np.uint8), tmasks, ln, **SKW)


LANE_CASES = [  # (Q, T, lanes, per_row): every built L at the split's edges and Q 20/24
    (Q, T, L, per_row)
    for Q, T in ((1, 64), (2, 100), (20, 128), (21, 256), (23, 201), (24, 256), (47, 128),
                 (48, 512))
    for per_row in (False, True)
    for L in dp_cuda.rows_lanes(Q, per_row)
]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T,lanes,per_row", LANE_CASES)
def test_lanes_match_plain_version(cuda, Q, T, lanes, per_row):
    """Each lane count in both modes, bit for bit, ranges on and off, on
    4,099 rows (not a multiple of any block's rows) whose lengths mix 0,
    1, L - 1, T and past T inside one warp, with min scores at INT32_MIN,
    INT32_MAX and NEG_INF beside ordinary ones."""
    rng = np.random.default_rng(Q * 100 + T + 10 * lanes + per_row)
    B = 4099
    tmasks = torch.from_numpy(rng.integers(0, 16, size=(B, T), dtype=np.uint8)).to(cuda)
    lengths = rng.integers(0, T + 1, size=B)
    edge = np.array([0, 1, lanes - 1, T, T + 9])
    lengths[:32] = edge[np.arange(32) % len(edge)]  # the first warp's rows
    lengths[-5:] = edge  # and the last, partial block's
    ln = torch.from_numpy(lengths.astype(np.int32)).to(cuda)
    q = rng.integers(1, 16, size=(2, B, Q) if per_row else (1, Q)).astype(np.uint8)
    best0, _ = port_dp.screen_rows_reference(q, tmasks, ln, **SKW)
    ms = (best0.amax(0).cpu().numpy() - rng.integers(0, 400, B)).astype(np.int32)
    ms[:5] = INT32_MIN, INT32_MAX, NEG_INF, NEG_INF + 1, INT32_MIN
    for min_scores in (torch.from_numpy(ms).to(cuda), None):
        launches = dp_cuda.launches["screen_rows"]
        got = dp_cuda._screen_rows_lanes(q, tmasks, ln, min_scores, lanes=lanes, **SKW)
        torch.cuda.synchronize()
        assert dp_cuda.launches["screen_rows"] == launches + 1
        want = port_dp.screen_rows_reference(q, tmasks, ln, min_scores, **SKW)
        assert torch.equal(got[0], want[0])
        if min_scores is None:
            assert got[1] is None
        else:
            assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
def test_kernel_refuses_scores_whose_shift_leaves_int32(cuda, per_row):
    """A mismatch score whose end shift Q * mismatch leaves int32: the
    kernel refuses the launch at every L and the wrapper raises; nothing
    runs the plain version in its place."""
    Q, B = 48, 70
    tmasks = torch.zeros((B, 64), dtype=torch.uint8, device=cuda)
    ln = torch.full((B,), 64, dtype=torch.int32, device=cuda)
    q = np.ones((2, B, Q) if per_row else (1, Q), np.uint8)
    kw = dict(SKW, mismatch=-(2**26))
    calls = port_dp.reference_calls.get("cuda", 0)
    with pytest.raises(RuntimeError, match="screen_rows launch failed"):
        dp_cuda.screen_rows(q, tmasks, ln, **kw)
    for lanes in dp_cuda.rows_lanes(Q, per_row):
        with pytest.raises(RuntimeError, match="screen_rows launch failed"):
            dp_cuda._screen_rows_lanes(q, tmasks, ln, lanes=lanes, **kw)
    assert port_dp.reference_calls.get("cuda", 0) == calls
