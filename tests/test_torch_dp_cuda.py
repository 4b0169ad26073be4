"""The CUDA screen kernels (dual-chain and multi-guide, each lane count
of their lane split) against their plain PyTorch versions, bit for
bit, on the card.  Skipped where torch
sees no CUDA device; run on the GPU machine with
``python -m pytest tests/test_torch_dp_cuda.py``."""

import numpy as np
import pytest
import torch

from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops.dp_screen import (
    screen_dual_reference,
    screen_multi_reference,
)

pytestmark = pytest.mark.cuda

SCORER = derive_scorer()
SKW = dict(
    match=SCORER.match_score, mismatch=SCORER.mismatch_score,
    qgap=SCORER.query_gap_score, tgap=SCORER.target_gap_score,
)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# The lane split's edge cases: each L <= Q of the dual kernel (Q not a
# multiple of L leaves the last lanes fewer rows, or none).
LANE_GRIDS = {1: (2500, 2489, True), 2: (40, 28, False), 21: (1000, 970, True),
              23: (1003, 973, False), 47: (64, 7, True), 48: (1003, 947, True)}


@pytest.mark.parametrize(
    "Q,window,step,pam_gate,lanes",
    [(1, 41, 13, True, None), (20, 1000, 973, True, None), (20, 63, 36, False, None),
     (23, 45, 18, True, None), (48, 2500, 2445, True, None), (48, 64, 9, False, None)]
    + [(Q, *grid, L) for Q, grid in LANE_GRIDS.items() for L in dp_cuda.DUAL_LANES if L <= Q],
)
def test_kernel_matches_plain_version(cuda, Q, window, step, pam_gate, lanes):
    """``lanes`` None = the launcher's table; else ``_screen_dual_lanes``."""
    rng = np.random.default_rng(Q * 7919 + window)
    genome = torch.from_numpy(
        rng.integers(0, 64, size=200_000, dtype=np.uint8)
    ).to(cuda)
    qvals = rng.integers(1, 16, size=(2, Q)).astype(np.int32)
    n = (genome.numel() - 1) // step + 1  # the last windows run past the end
    kw = dict(base0=0, step=step, n_windows=n, window=window, min_score=0,
              pam_gate=pam_gate, **SKW)
    best0, _ = screen_dual_reference(genome, qvals, **kw)
    kw["min_score"] = int(best0.float().median())
    launches = dp_cuda.launches["screen_dual"]
    if lanes is None:
        assert dp_cuda.screen_dual_default_lanes(Q) in dp_cuda.DUAL_LANES
        got = dp_cuda.screen_dual(genome, qvals, **kw)
    else:
        got = dp_cuda._screen_dual_lanes(genome, qvals, lanes=lanes, **kw)
    torch.cuda.synchronize()
    assert dp_cuda.launches["screen_dual"] == launches + 1
    want = screen_dual_reference(genome, qvals, **kw)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_long_query_raises_on_cuda(cuda):
    genome = torch.zeros(1000, dtype=torch.uint8, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dp_cuda.screen_dual(
            genome, np.ones((2, 49), np.int32), base0=0, step=10,
            n_windows=5, window=100, min_score=0, pam_gate=False, **SKW
        )


INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _multi_cases():
    """The launcher's cases; then each L <= Q of the multi-guide kernel at
    the lane split's edge Qs (G 1/4/17 in turn, ranges on and off in
    turn); then slot batches (B 8192 x T 64/128, flattened, gate and
    ranges off) at G 1 and 4 for each L."""
    cases = [(1, 41, 13, 1, True, True, None), (20, 1000, 973, 4, True, True, None),
             (20, 64, 64, 3, False, False, None), (24, 1003, 980, 17, True, True, None),
             (48, 128, 128, 5, False, False, None), (48, 2500, 2445, 2, True, True, None)]
    k = 0
    for Q, (window, step, gate) in LANE_GRIDS.items():
        for L in (L for L in dp_cuda.MULTI_LANES if L <= Q):
            cases.append((Q, window, step, (1, 4, 17)[k % 3], gate, k % 2 == 0, L))
            k += 1
    for T in (64, 128):
        for G in (1, 4):
            cases += [(20, T, T, G, False, False, L) for L in dp_cuda.MULTI_LANES]
    return cases


@pytest.mark.parametrize("Q,window,step,G,pam_gate,emit_ranges,lanes", _multi_cases())
def test_multi_kernel_matches_plain_version(cuda, Q, window, step, G, pam_gate,
                                            emit_ranges, lanes):
    """``lanes`` None = the launcher's table; else ``_screen_multi_lanes``.
    Windows of ``step == window`` are a slot batch of 8,192 rows; the
    others' last windows run past the genome's end.  With two guides or
    more the first two thresholds are INT32_MIN and INT32_MAX."""
    rng = np.random.default_rng(Q * 7919 + window + G + 31 * (lanes or 0))
    slots = step == window and window in (64, 128) and lanes is not None
    size = 8192 * window if slots else 200_000
    genome = torch.from_numpy(
        rng.integers(0, 16 if slots else 64, size=size, dtype=np.uint8)
    ).to(cuda)
    qvals = rng.integers(1, 16, size=(G, 2, Q)).astype(np.int32)
    n = (genome.numel() - 1) // step + 1  # the last windows run past the end
    kw = dict(base0=0, step=step, n_windows=n, window=window,
              pam_gate=pam_gate, emit_ranges=emit_ranges, **SKW)
    best0, _ = screen_multi_reference(genome, qvals, np.zeros(G, np.int32), **kw)
    mss = best0.float().quantile(0.7, dim=-1).amax(dim=-1).to(torch.int32)
    mss = mss.cpu().numpy() - np.arange(G, dtype=np.int32)  # one per guide
    if lanes is not None and G >= 2:
        mss[:2] = (INT32_MIN, INT32_MAX)
    launches = dp_cuda.launches["screen_multi"]
    if lanes is None:
        L = dp_cuda.screen_multi_default_lanes(Q, n, G, emit_ranges)
        assert L in dp_cuda.MULTI_LANES and L <= Q
        got = dp_cuda.screen_multi(genome, qvals, mss, **kw)
    else:
        got = dp_cuda._screen_multi_lanes(genome, qvals, mss, lanes=lanes, **kw)
    torch.cuda.synchronize()
    assert dp_cuda.launches["screen_multi"] == launches + 1
    want = screen_multi_reference(genome, qvals, mss, **dict(kw, emit_ranges=True))
    assert torch.equal(got[0], want[0])
    if emit_ranges:
        assert torch.equal(got[1], want[1])
    else:
        assert got[1] is None


def test_multi_long_query_raises_on_cuda(cuda):
    genome = torch.zeros(1000, dtype=torch.uint8, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dp_cuda.screen_multi(
            genome, np.ones((2, 2, 49), np.int32), np.zeros(2, np.int32),
            base0=0, step=10, n_windows=5, window=100, pam_gate=False,
            emit_ranges=True, **SKW
        )
