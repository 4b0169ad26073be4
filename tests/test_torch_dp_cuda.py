"""The CUDA screen kernels (dual-chain and multi-guide) against their
plain PyTorch versions, bit for bit, on the card.  Skipped where torch
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


@pytest.mark.parametrize(
    "Q,window,step,pam_gate",
    [(1, 41, 13, True), (20, 1000, 973, True), (20, 63, 36, False),
     (23, 45, 18, True), (48, 2500, 2445, True), (48, 64, 9, False)],
)
def test_kernel_matches_plain_version(cuda, Q, window, step, pam_gate):
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
    got = dp_cuda.screen_dual(genome, qvals, **kw)
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


@pytest.mark.parametrize(
    "Q,window,step,G,pam_gate,emit_ranges",
    [(1, 41, 13, 1, True, True), (20, 1000, 973, 4, True, True),
     (20, 64, 64, 3, False, False), (24, 1003, 980, 17, True, True),
     (48, 128, 128, 5, False, False), (48, 2500, 2445, 2, True, True)],
)
def test_multi_kernel_matches_plain_version(cuda, Q, window, step, G, pam_gate,
                                            emit_ranges):
    rng = np.random.default_rng(Q * 7919 + window + G)
    genome = torch.from_numpy(
        rng.integers(0, 64, size=200_000, dtype=np.uint8)
    ).to(cuda)
    qvals = rng.integers(1, 16, size=(G, 2, Q)).astype(np.int32)
    n = (genome.numel() - 1) // step + 1  # the last windows run past the end
    kw = dict(base0=0, step=step, n_windows=n, window=window,
              pam_gate=pam_gate, emit_ranges=emit_ranges, **SKW)
    best0, _ = screen_multi_reference(genome, qvals, np.zeros(G, np.int32), **kw)
    mss = best0.float().quantile(0.7, dim=-1).amax(dim=-1).to(torch.int32)
    mss = mss.cpu().numpy() - np.arange(G, dtype=np.int32)  # one per guide
    launches = dp_cuda.launches["screen_multi"]
    got = dp_cuda.screen_multi(genome, qvals, mss, **kw)
    torch.cuda.synchronize()
    assert dp_cuda.launches["screen_multi"] == launches + 1
    want = screen_multi_reference(genome, qvals, mss, **kw)
    assert torch.equal(got[0], want[0])
    if emit_ranges:
        assert torch.equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


def test_multi_long_query_raises_on_cuda(cuda):
    genome = torch.zeros(1000, dtype=torch.uint8, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dp_cuda.screen_multi(
            genome, np.ones((2, 2, 49), np.int32), np.zeros(2, np.int32),
            base0=0, step=10, n_windows=5, window=100, pam_gate=False,
            emit_ranges=True, **SKW
        )
