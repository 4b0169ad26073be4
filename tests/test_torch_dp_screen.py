"""The port's plain PyTorch DP screen against the JAX package: the XLA
scans of ``calitas_tpu.ops.dp_screen`` and the Pallas dual-chain kernel
``_pallas_screen_dual`` (interpret mode), bit for bit.  The screen is
exact int32 DP, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calitas_tpu.align.oracle import dp_matrix
from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu.ops import dp_screen as jax_dp
from calitas_tpu.ops.dp_pallas2 import _pallas_screen_dual, pack_tcols_jax
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops import dp_screen as port_dp

SCORER = derive_scorer()
SKW = dict(
    match=SCORER.match_score, mismatch=SCORER.mismatch_score,
    qgap=SCORER.query_gap_score, tgap=SCORER.target_gap_score,
)


def _random_case(seed, B, T, Q):
    rng = np.random.default_rng(seed)
    qmask = rng.integers(1, 16, size=Q, dtype=np.uint8)
    tmasks = rng.integers(0, 16, size=(B, T), dtype=np.uint8)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    return qmask, tmasks, lengths


@pytest.mark.parametrize("seed,B,T,Q", [(0, 16, 40, 12), (1, 9, 73, 20), (2, 5, 30, 48)])
def test_screen_scores_match_jax(seed, B, T, Q):
    qmask, tmasks, lengths = _random_case(seed, B, T, Q)
    want = np.asarray(jax_dp._screen_scores(qmask, tmasks, lengths, **SKW))
    got = port_dp._screen_scores(
        torch.from_numpy(qmask), torch.from_numpy(tmasks),
        torch.from_numpy(lengths), **SKW
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,B,T,Q", [(3, 16, 40, 12), (4, 7, 64, 23)])
def test_screen_scores_ranges_match_jax(seed, B, T, Q):
    qmask, tmasks, lengths = _random_case(seed, B, T, Q)
    best = np.asarray(jax_dp._screen_scores(qmask, tmasks, lengths, **SKW))
    ms = int(np.median(best))  # some windows qualify, some do not
    want = jax_dp._screen_scores_ranges(qmask, tmasks, lengths, ms, **SKW)
    got = port_dp._screen_scores_ranges(
        torch.from_numpy(qmask), torch.from_numpy(tmasks),
        torch.from_numpy(lengths), ms, **SKW
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_final_rows_match_jax_and_oracle():
    qmask, tmasks, _ = _random_case(5, 8, 50, 20)
    want = np.asarray(jax_dp._final_rows(qmask, tmasks, **SKW))
    got = port_dp._final_rows(
        torch.from_numpy(qmask), torch.from_numpy(tmasks), **SKW
    ).numpy()
    np.testing.assert_array_equal(got, want)
    for b in range(3):
        S = dp_matrix(qmask, tmasks[b], SCORER)
        np.testing.assert_array_equal(got[b], S[len(qmask), 1:])


def _dual_port(wins, qvals, ms, pam_gate, **grid):
    B, T = wins.shape
    genome = torch.from_numpy(np.ascontiguousarray(wins).reshape(-1))
    kw = dict(base0=0, step=T, n_windows=B, window=T)
    kw.update(grid)
    best, ranges = port_dp.screen_dual_reference(
        genome, qvals, min_score=ms, pam_gate=pam_gate, **kw, **SKW
    )
    return best.numpy(), ranges.numpy()


# Q in {1, 20, 23, 48}; T % 4 in {0, 1, 3}; gate on and off; random gate bits.
@pytest.mark.parametrize(
    "Q,T,pam_gate",
    [(1, 41, True), (20, 64, True), (20, 63, False), (23, 45, True),
     (48, 49, True)],
)
def test_screen_dual_reference_matches_pallas_interpret(Q, T, pam_gate):
    rng = np.random.default_rng(1000 * Q + T)
    B = 1024  # one Pallas grid cell
    qvals = rng.integers(1, 16, size=(2, Q)).astype(np.int32)
    wins = rng.integers(0, 64, size=(B, T), dtype=np.uint8)  # mask + gate bits
    best0, _ = _dual_port(wins, qvals, 0, pam_gate)
    ms = int(np.median(best0))  # some windows qualify, some do not
    best, ranges = _dual_port(wins, qvals, ms, pam_gate)
    want_best, want_ranges = _pallas_screen_dual(
        jnp.asarray(qvals), pack_tcols_jax(jnp.asarray(wins)), ms, Q=Q,
        pam_gate=pam_gate, emit_ranges=True, T=T, interpret=True, **SKW
    )
    np.testing.assert_array_equal(best, np.asarray(want_best).reshape(2, B))
    np.testing.assert_array_equal(
        ranges, np.asarray(want_ranges).reshape(2, 2, B)
    )
    assert len(np.unique(ranges[:, 0])) > 2  # qualifying columns vary


def test_screen_dual_reference_chain_a_is_the_oracle():
    """Ungated chain A is the oracle's final DP row: best = row max and the
    ranges bound exactly the qualifying end columns."""
    rng = np.random.default_rng(7)
    Q, T, B = 12, 60, 6
    qvals = rng.integers(1, 16, size=(2, Q)).astype(np.int32)
    wins = rng.integers(0, 16, size=(B, T), dtype=np.uint8)
    ms = SCORER.match_score * Q - 3 * 122
    best, ranges = _dual_port(wins, qvals, ms, False)
    for b in range(B):
        row = dp_matrix(qvals[0].astype(np.uint8), wins[b], SCORER)[Q, 1:]
        assert best[0, b] == row.max()
        qual = np.nonzero(row >= ms)[0] + 1
        want = (qual.min(), qual.max()) if len(qual) else (T + 1, 0)
        assert tuple(ranges[0, :, b]) == want


def test_screen_dual_reference_reads_past_end_as_zero():
    """Windows running past the genome's end see zero bytes, exactly as if
    the genome were zero-padded; base0 and step place the windows."""
    rng = np.random.default_rng(8)
    Q, T = 10, 33
    qvals = rng.integers(1, 16, size=(2, Q)).astype(np.int32)
    genome = rng.integers(0, 64, size=500, dtype=np.uint8)
    grid = dict(base0=7, step=29, n_windows=18, window=T)
    kw = dict(min_score=0, pam_gate=True, **grid, **SKW)
    short = port_dp.screen_dual_reference(torch.from_numpy(genome), qvals, **kw)
    padded = np.concatenate([genome, np.zeros(7 + 29 * 18 + T, np.uint8)])
    long = port_dp.screen_dual_reference(torch.from_numpy(padded), qvals, **kw)
    for s, l in zip(short, long):
        assert torch.equal(s, l)
    wins = np.stack([padded[7 + 29 * w : 7 + 29 * w + T] for w in range(18)])
    best, ranges = _dual_port(wins, qvals, 0, True)
    np.testing.assert_array_equal(short[0].numpy(), best)
    np.testing.assert_array_equal(short[1].numpy(), ranges)


@pytest.mark.parametrize("lanes", [None, 1, 2])
def test_wrapper_routes_cpu_tensors_to_the_plain_version(lanes):
    """``lanes`` None = ``screen_dual``; else ``_screen_dual_lanes``."""
    rng = np.random.default_rng(9)
    qvals = rng.integers(1, 16, size=(2, 8)).astype(np.int32)
    genome = torch.from_numpy(rng.integers(0, 64, size=300, dtype=np.uint8))
    kw = dict(base0=0, step=20, n_windows=12, window=30, min_score=0,
              pam_gate=True, **SKW)
    launches = dict(dp_cuda.launches)
    calls = port_dp.reference_calls["cpu"]
    if lanes is None:
        got = dp_cuda.screen_dual(genome, qvals, **kw)
    else:
        got = dp_cuda._screen_dual_lanes(genome, qvals, lanes=lanes, **kw)
    want = port_dp.screen_dual_reference(genome, qvals, **kw)
    assert dp_cuda.launches == launches
    assert port_dp.reference_calls["cpu"] == calls + 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "genome,qvals,grid",
    [
        (torch.zeros(64, dtype=torch.int32), np.ones((2, 4)), {}),
        (torch.zeros((8, 8), dtype=torch.uint8), np.ones((2, 4)), {}),
        (torch.zeros(64, dtype=torch.uint8)[::2], np.ones((2, 4)), {}),
        (torch.zeros(64, dtype=torch.uint8), np.ones((3, 4)), {}),
        (torch.zeros(64, dtype=torch.uint8), np.full((2, 4), 16), {}),
        (torch.zeros(64, dtype=torch.uint8), np.ones((2, 4)), {"step": 0}),
        (torch.zeros(64, dtype=torch.uint8), np.ones((2, 4)), {"base0": -1}),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(genome, qvals, grid):
    kw = dict(base0=0, step=8, n_windows=4, window=8, min_score=0,
              pam_gate=False, **SKW)
    kw.update(grid)
    with pytest.raises(ValueError):
        dp_cuda.screen_dual(genome, qvals, **kw)


def test_wrapper_rejects_other_devices():
    genome = torch.zeros(64, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dp_cuda.screen_dual(
            genome, np.ones((2, 4)), base0=0, step=8, n_windows=4, window=8,
            min_score=0, pam_gate=False, **SKW
        )


@pytest.mark.parametrize("Q,lanes", [(8, 3), (8, 16), (8, 4), (20, 8), (1, 2)])
def test_lanes_helper_rejects_what_the_kernel_is_not_built_for(Q, lanes):
    with pytest.raises(ValueError):
        dp_cuda._screen_dual_lanes(
            torch.zeros(64, dtype=torch.uint8), np.ones((2, Q)), lanes=lanes,
            base0=0, step=8, n_windows=4, window=8, min_score=0, pam_gate=False,
            **SKW
        )
