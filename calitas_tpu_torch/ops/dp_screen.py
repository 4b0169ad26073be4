"""Batched glocal-DP screening in plain PyTorch.

Counterpart of ``calitas_tpu/ops/dp_screen.py`` (``_screen_scores``,
``_screen_scores_ranges``, ``_final_rows``, the ``ScreenKernel`` library
API), plus the full contracts of the Pallas kernels
``calitas_tpu/ops/dp_pallas2.py::_kernel2`` (:func:`screen_dual_reference`),
``_kernel_multi`` (:func:`screen_multi_reference`) and ``_kernel``
(:func:`screen_rows_reference`, which also carries the per-row-query pair
screen of ``calitas_tpu/ops/pair_screen.py``), PAM gate and end-column
ranges included.  The JAX XLA screen applies no PAM gate; the gated
contract exists only in those kernels and here.  These functions are the
CPU path of the port, the plain route for queries longer than the CUDA
kernels take, and the oracles the CUDA kernels (``ops/dp_cuda.py``) are
held against, bit for bit.

Recurrence (matches calitas_tpu.align.oracle.dp_matrix):

    S[0, j] = 0
    S[i, 0] = i * target_gap
    S[i, j] = max(S[i-1, j-1] + pair, S[i-1, j] + tgap, S[i, j-1] + qgap)

Layout: a Python loop scans target columns and carries the DP column
``[C, B, Q+1]`` (C chains of B windows).  The in-column "up" chain is a
max-plus prefix scan, ``cummax(tmp - i*tgap) + i*tgap`` along the Q axis.
All arithmetic is int32 and exact.
"""

from __future__ import annotations

import numpy as np
import torch

from calitas_tpu.core.scoring import Scorer

NEG_INF = -(2**30)
#: gate sentinel for PAM-less chain-B starts: far below any reachable DP
#: value, far above int32 overflow when path costs accumulate
NEG_GATE = -(2**26)

#: calls of the plain screens (:func:`screen_dual_reference`,
#: :func:`screen_multi_reference`, :func:`screen_rows_reference`) by
#: device type: a run on the card shows with it which screens took a plain
#: version there
reference_calls = {"cpu": 0, "cuda": 0}


def _count_call(device: torch.device) -> None:
    reference_calls[device.type] = reference_calls.get(device.type, 0) + 1


def _column(state, tcol, qv, idec, row0, match, mismatch, qgap):
    """One DP column.  state [C, B, Q+1] int32 (previous column), tcol
    [B] uint8 target masks, qv [C, 1, Q] (one query per chain) or
    [C, B, Q] (one per row) uint8 query masks, idec [Q+1] int32 =
    i*tgap, row0 [C, B] int32 (or broadcastable) free-start row."""
    compat = (qv & tcol[None, :, None]) != 0
    pair = compat.to(torch.int32) * (match - mismatch) + mismatch
    tmp = torch.maximum(state[..., :-1] + pair, state[..., 1:] + qgap)
    row0 = torch.as_tensor(row0, dtype=torch.int32, device=state.device)
    full = torch.cat([row0.expand(state.shape[:-1]).unsqueeze(-1), tmp], dim=-1)
    return torch.cummax(full - idec, dim=-1).values + idec


def _init(C, B, Q, tgap, device):
    idec = torch.arange(Q + 1, dtype=torch.int32, device=device) * tgap
    return idec, idec.expand(C, B, Q + 1).clone()


def _screen_rows(qv, tmasks, lengths, min_scores, match, mismatch, qgap, tgap):
    """The row screen on tensors of one device: qv [C, 1|B, Q] uint8,
    tmasks [B, T] uint8, lengths [B] int32, min_scores [B] int32 (or a
    scalar tensor) or None.  Returns best [C, B] and (min, max) end
    columns [C, B] each (None, None without min_scores)."""
    B, T = tmasks.shape
    C, _, Q = qv.shape
    dev = tmasks.device
    idec, state = _init(C, B, Q, tgap, dev)
    best = torch.full((C, B), NEG_INF, dtype=torch.int32, device=dev)
    mn = mx = None
    if min_scores is not None:
        mn = torch.full((C, B), T + 1, dtype=torch.int32, device=dev)
        mx = torch.zeros((C, B), dtype=torch.int32, device=dev)
    for j in range(1, T + 1):
        state = _column(state, tmasks[:, j - 1], qv, idec, 0, match, mismatch, qgap)
        end = torch.where(j <= lengths, state[..., Q], NEG_INF)
        best = torch.maximum(best, end)
        if min_scores is not None:
            qual = end >= min_scores
            mn = torch.where(qual, torch.clamp(mn, max=j), mn)
            mx = torch.where(qual, j, mx)
    return best, mn, mx


def _screen_scores(qmask, tmasks, lengths, match, mismatch, qgap, tgap):
    """Best final-row score over valid end columns, per batch row.

    qmask [Q] uint8, tmasks [B, T] uint8, lengths [B] int32 (end columns
    past a row's length are ignored) -> [B] int32."""
    qv = qmask.to(torch.uint8)[None, None]
    return _screen_rows(qv, tmasks, lengths, None, match, mismatch, qgap, tgap)[0][0]


def _screen_scores_ranges(
    qmask, tmasks, lengths, min_score, match, mismatch, qgap, tgap
):
    """Like :func:`_screen_scores`, also returning the (min, max) 1-based
    end columns scoring >= ``min_score`` (min = T+1 / max = 0 when none)."""
    qv = qmask.to(torch.uint8)[None, None]
    ms = torch.tensor(min_score, dtype=torch.int32, device=tmasks.device)
    best, mn, mx = _screen_rows(qv, tmasks, lengths, ms, match, mismatch, qgap, tgap)
    return best[0], mn[0], mx[0]


def _on(x, device, dtype) -> torch.Tensor:
    """A host array or tensor as a tensor of ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def screen_rows_reference(
    qmasks,
    tmasks: torch.Tensor,
    lengths: torch.Tensor,
    min_scores=None,
    *,
    match: int,
    mismatch: int,
    qgap: int,
    tgap: int,
):
    """Final-row screen of a row-major target batch with a per-row
    length mask: the contract of the Pallas kernel
    ``calitas_tpu/ops/dp_pallas2.py::_kernel`` (one shared query) and of
    the pair screen ``calitas_tpu/ops/pair_screen.py::_pair_scores_dual
    [_ranges]`` (one query per row, both chains).

    ``qmasks`` is ``[C, Q]`` (one query per chain, shared by every row)
    or ``[C, B, Q]`` (one query per row per chain), a host array or a
    tensor; ``tmasks`` is ``[B, T]`` uint8 and ``lengths`` ``[B]`` int32,
    both on the device the screen runs on.  Returns ``best`` [C, B]
    int32, the max over end columns ``1 <= j <= min(T, lengths[b])`` of
    S[Q, j] (NEG_INF when there is none), and, when ``min_scores`` [B]
    is given, ``ranges`` [C, 2, B] int32: the (min, max) 1-based end
    column whose score reaches that row's min score, T+1 / 0 when none
    (end columns past a row's length score NEG_INF); else None."""
    dev = tmasks.device
    _count_call(dev)
    qv = _on(qmasks, dev, torch.uint8)
    if qv.dim() == 2:
        qv = qv[:, None, :]
    ln = _on(lengths, dev, torch.int32)
    ms = None if min_scores is None else _on(min_scores, dev, torch.int32)
    best, mn, mx = _screen_rows(
        qv, tmasks, ln, ms, match, mismatch, qgap, tgap
    )
    return best, None if ms is None else torch.stack([mn, mx], dim=1)


def _final_rows(qmask, tmasks, match, mismatch, qgap, tgap):
    """Full final DP row per batch element: [B, T] int32 with entry j-1 =
    S[Q, j]."""
    B, T = tmasks.shape
    Q = qmask.shape[0]
    qv = qmask.to(torch.uint8)[None, None]
    idec, state = _init(1, B, Q, tgap, tmasks.device)
    rows = []
    for j in range(T):
        state = _column(state, tmasks[:, j], qv, idec, 0, match, mismatch, qgap)
        rows.append(state[0, :, Q])
    return torch.stack(rows, dim=1)


def _screen_grid_chains(
    genome, qvals, min_scores, *, base0, step, n_windows, window, match,
    mismatch, qgap, tgap, pam_gate,
):
    """The window-grid screen for C = 2G chains, guide g's chain A at
    row 2g and chain B at 2g+1: qvals [C, Q] host masks, min_scores [C]
    host thresholds.  Returns best [C, n] and ranges [C, 2, n] int32."""
    dev = genome.device
    _count_call(dev)
    T = window
    L = genome.numel()
    qv = torch.as_tensor(np.asarray(qvals, dtype=np.uint8), device=dev)
    C, Q = qv.shape
    qv = qv[:, None, :]
    ms = torch.as_tensor(
        np.asarray(min_scores, dtype=np.int32), device=dev
    ).reshape(C, 1)
    chain_b = torch.arange(C, device=dev) % 2 == 1
    idec, state = _init(C, n_windows, Q, tgap, dev)
    best = torch.full((C, n_windows), NEG_INF, dtype=torch.int32, device=dev)
    mn = torch.full((C, n_windows), T + 1, dtype=torch.int32, device=dev)
    mx = torch.zeros((C, n_windows), dtype=torch.int32, device=dev)
    pos = base0 + step * torch.arange(n_windows, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    row0 = torch.zeros((C, n_windows), dtype=torch.int32, device=dev)
    for j in range(1, T + 1):
        inside = pos < L
        raw = torch.where(inside, genome[pos.clamp(max=max(L - 1, 0))], zero)
        pos = pos + 1
        if pam_gate:
            start_ok = (raw & 32) != 0
            row0 = torch.where(chain_b[:, None] & ~start_ok, NEG_GATE, 0)
        state = _column(state, raw & 15, qv, idec, row0, match, mismatch, qgap)
        end = state[..., Q]
        if pam_gate:
            end_ok = (raw & 16) != 0
            end = torch.where(chain_b[:, None] | end_ok, end, NEG_INF)
        best = torch.maximum(best, end)
        qual = end >= ms
        mn = torch.where(qual, torch.clamp(mn, max=j), mn)
        mx = torch.where(qual, j, mx)
    return best, torch.stack([mn, mx], dim=1)


def screen_dual_reference(
    genome: torch.Tensor,
    qvals: np.ndarray,
    *,
    base0: int,
    step: int,
    n_windows: int,
    window: int,
    min_score: int,
    match: int,
    mismatch: int,
    qgap: int,
    tgap: int,
    pam_gate: bool,
):
    """Both-strand screen of the window grid ``base0 + w*step``,
    ``w < n_windows``, over an annotated genome (bits 0-3 target mask,
    bit 4 chain-A END gate, bit 5 chain-B START gate; bytes at or past
    the end of ``genome`` read as 0).

    ``qvals`` is the host [2, Q] array of chain A's and chain B's query
    masks.  Returns ``best`` [2, n_windows] int32, the per-chain max
    final-row score, and ``ranges`` [2, 2, n_windows] int32, the
    per-chain (min, max) 1-based end column scoring >= ``min_score``
    (T+1 / 0 when none).  With ``pam_gate`` chain-A end columns whose bit
    4 is clear score NEG_INF, and chain B's free start at column j >= 1
    is 0 only where bit 5 is set (else NEG_GATE)."""
    return _screen_grid_chains(
        genome, qvals, [min_score, min_score], base0=base0, step=step,
        n_windows=n_windows, window=window, match=match, mismatch=mismatch,
        qgap=qgap, tgap=tgap, pam_gate=pam_gate,
    )


def screen_multi_reference(
    genome: torch.Tensor,
    qvals: np.ndarray,
    min_scores: np.ndarray,
    *,
    base0: int,
    step: int,
    n_windows: int,
    window: int,
    match: int,
    mismatch: int,
    qgap: int,
    tgap: int,
    pam_gate: bool,
    emit_ranges: bool,
):
    """The :func:`screen_dual_reference` contract for G same-length
    guides over one window grid: the full contract of the Pallas kernel
    ``calitas_tpu/ops/dp_pallas2.py::_kernel_multi``.

    ``qvals`` is the host [G, 2, Q] array of each guide's chain A and
    chain B masks, ``min_scores`` the host [G] per-guide thresholds.
    Returns ``best`` [G, 2, n_windows] int32 and, with ``emit_ranges``,
    ``ranges`` [G, 2, 2, n_windows] int32 counting the end columns that
    reach that guide's own min score (else None).  A slot batch [B, T]
    is the grid ``base0=0, step=T, window=T`` over its flattened rows."""
    qvals = np.asarray(qvals)
    G, _, Q = qvals.shape
    best, ranges = _screen_grid_chains(
        genome, qvals.reshape(2 * G, Q),
        np.repeat(np.asarray(min_scores, dtype=np.int32), 2),
        base0=base0, step=step, n_windows=n_windows, window=window,
        match=match, mismatch=mismatch, qgap=qgap, tgap=tgap,
        pam_gate=pam_gate,
    )
    best = best.reshape(G, 2, n_windows)
    return best, ranges.reshape(G, 2, 2, n_windows) if emit_ranges else None


class ScreenKernel:
    """The library API of ``calitas_tpu/ops/dp_screen.py::ScreenKernel``
    on an explicit ``torch.device``: final-row screens of one query
    against a batch of length-masked target rows, in plain PyTorch.
    ``ops/dp_cuda.py::CudaScreenKernel`` runs the same API through the
    CUDA row screen."""

    def __init__(self, scorer: Scorer, device="cpu"):
        self.scorer = scorer
        self.device = torch.device(device)

    def _scores(self) -> dict:
        s = self.scorer
        return dict(match=s.match_score, mismatch=s.mismatch_score,
                    qgap=s.query_gap_score, tgap=s.target_gap_score)

    def prepare_targets(self, tmasks: np.ndarray, lengths: np.ndarray):
        """Upload a target batch once; the handle serves every query."""
        return (_on(tmasks, self.device, torch.uint8),
                _on(lengths, self.device, torch.int32))

    def _best(self, qmask: np.ndarray, tm, ln) -> torch.Tensor:
        best, _ = screen_rows_reference(
            np.asarray(qmask)[None], tm, ln, **self._scores()
        )
        return best[0]

    def max_scores_prepared_async(self, qmask: np.ndarray, prepared):
        """Launch the screen on a prepared batch and return a zero-arg
        resolver of the [B] int32 maxima: the device computes while the
        host prepares the next batch."""
        best = self._best(qmask, *prepared)
        return lambda: best.cpu().numpy()

    def max_scores_async(
        self, qmask: np.ndarray, tmasks: np.ndarray, lengths: np.ndarray
    ):
        return self.max_scores_prepared_async(
            qmask, self.prepare_targets(tmasks, lengths)
        )

    def max_scores(
        self, qmask: np.ndarray, tmasks: np.ndarray, lengths: np.ndarray
    ) -> np.ndarray:
        return self.max_scores_async(qmask, tmasks, lengths)()

    def final_rows(self, qmask: np.ndarray, tmasks: np.ndarray) -> np.ndarray:
        """Full final DP row per target: [B, T] int32, entry j-1 = S[Q, j]."""
        return _final_rows(
            _on(qmask, self.device, torch.uint8),
            _on(tmasks, self.device, torch.uint8), **self._scores(),
        ).cpu().numpy()
