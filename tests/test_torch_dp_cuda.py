"""The CUDA dual-chain screen kernel against its plain PyTorch version,
bit for bit, on the card.  Skipped where torch sees no CUDA device; run
on the GPU machine with ``python -m pytest tests/test_torch_dp_cuda.py``."""

import numpy as np
import pytest
import torch

from calitas_tpu.core.scoring import derive_scorer
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops.dp_screen import screen_dual_reference

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
    launches = dp_cuda.launches
    got = dp_cuda.screen_dual(genome, qvals, **kw)
    torch.cuda.synchronize()
    assert dp_cuda.launches == launches + 1
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
