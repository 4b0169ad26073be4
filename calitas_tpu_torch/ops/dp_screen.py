"""Batched glocal-DP screening in plain PyTorch.

Counterpart of ``calitas_tpu/ops/dp_screen.py`` (``_screen_scores``,
``_screen_scores_ranges``, ``_final_rows``), plus the full contracts of
the Pallas kernels ``calitas_tpu/ops/dp_pallas2.py::_kernel2``
(:func:`screen_dual_reference`) and ``_kernel_multi``
(:func:`screen_multi_reference`), PAM gate and end-column ranges
included.  The JAX XLA screen applies no PAM gate; the gated contract
exists only in those kernels and here.  Both functions are the CPU path
of the port and the oracles the CUDA kernels (``ops/dp_cuda.py``) are
held against, bit for bit; they share one implementation over C chains.

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

NEG_INF = -(2**30)
#: gate sentinel for PAM-less chain-B starts: far below any reachable DP
#: value, far above int32 overflow when path costs accumulate
NEG_GATE = -(2**26)

#: calls of the plain window-grid screens (:func:`screen_dual_reference`,
#: :func:`screen_multi_reference`) by device type: a run on the card
#: shows with it that the main path never took a plain version
reference_calls = {"cpu": 0, "cuda": 0}


def _column(state, tcol, qv, idec, row0, match, mismatch, qgap):
    """One DP column.  state [C, B, Q+1] int32 (previous column), tcol
    [B] uint8 target masks, qv [C, Q] uint8 query masks, idec [Q+1]
    int32 = i*tgap, row0 [C, B] int32 (or broadcastable) free-start row."""
    compat = (qv[:, None, :] & tcol[None, :, None]) != 0
    pair = compat.to(torch.int32) * (match - mismatch) + mismatch
    tmp = torch.maximum(state[..., :-1] + pair, state[..., 1:] + qgap)
    row0 = torch.as_tensor(row0, dtype=torch.int32, device=state.device)
    full = torch.cat([row0.expand(state.shape[:-1]).unsqueeze(-1), tmp], dim=-1)
    return torch.cummax(full - idec, dim=-1).values + idec


def _init(C, B, Q, tgap, device):
    idec = torch.arange(Q + 1, dtype=torch.int32, device=device) * tgap
    return idec, idec.expand(C, B, Q + 1).clone()


def _screen_scores(qmask, tmasks, lengths, match, mismatch, qgap, tgap):
    """Best final-row score over valid end columns, per batch row.

    qmask [Q] uint8, tmasks [B, T] uint8, lengths [B] int32 (end columns
    past a row's length are ignored) -> [B] int32."""
    return _screen_scores_ranges(
        qmask, tmasks, lengths, NEG_INF, match, mismatch, qgap, tgap
    )[0]


def _screen_scores_ranges(
    qmask, tmasks, lengths, min_score, match, mismatch, qgap, tgap
):
    """Like :func:`_screen_scores`, also returning the (min, max) 1-based
    end columns scoring >= ``min_score`` (min = T+1 / max = 0 when none)."""
    B, T = tmasks.shape
    Q = qmask.shape[0]
    dev = tmasks.device
    qv = qmask.to(torch.uint8)[None]
    idec, state = _init(1, B, Q, tgap, dev)
    best = torch.full((B,), NEG_INF, dtype=torch.int32, device=dev)
    mn = torch.full((B,), T + 1, dtype=torch.int32, device=dev)
    mx = torch.zeros((B,), dtype=torch.int32, device=dev)
    for j in range(1, T + 1):
        state = _column(state, tmasks[:, j - 1], qv, idec, 0, match, mismatch, qgap)
        end = torch.where(j <= lengths, state[0, :, Q], NEG_INF)
        best = torch.maximum(best, end)
        qual = end >= min_score
        mn = torch.where(qual, torch.clamp(mn, max=j), mn)
        mx = torch.where(qual, j, mx)
    return best, mn, mx


def _final_rows(qmask, tmasks, match, mismatch, qgap, tgap):
    """Full final DP row per batch element: [B, T] int32 with entry j-1 =
    S[Q, j]."""
    B, T = tmasks.shape
    Q = qmask.shape[0]
    qv = qmask.to(torch.uint8)[None]
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
    reference_calls[dev.type] = reference_calls.get(dev.type, 0) + 1
    T = window
    L = genome.numel()
    qv = torch.as_tensor(np.asarray(qvals, dtype=np.uint8), device=dev)
    C, Q = qv.shape
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
