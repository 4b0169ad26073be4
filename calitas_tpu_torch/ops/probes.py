"""The roofline probes on the card (``csrc/probes.cu``), their plain
PyTorch versions, the bound of a kernel's work, and :func:`roofline`.

:func:`ceiling_probe` replaces ``benchmarks/screen_ab.py::_ceiling_kernel``
and :func:`peak_probe` replaces ``_peak_kernel`` (both launched there
through ``_probe_call``).  The ceiling probe is the DP recurrence's
dependency shape at one add and one max per cell; the peak probe runs
``PEAK_C`` independent add+max streams.  Their layout is ``tcols`` [T, N]
int32 (column j of lane n at ``[j, n]``) and an [N] int32 result; the TPU
kernels' [T, nb*8, 128] is the same with N = nb*8*128.  A CUDA tensor
goes to the kernel or raises; a CPU tensor goes to the plain version.

The bound of a call is the larger of its operations over the card's
int32 rate and its bytes (each input read once, each output written
once) over the memory rate.  Operations are 2 int32 ops (one add, one
max) per DP cell the inputs need; the memory rate is the H100 SXM data
sheet's 3.35 TB/s.  The int32 rate is the larger of SMs x 64 INT32 lanes
per SM (Hopper architecture white paper) x the card's maximum SM clock,
and the peak probe's measured add+max rate: the compiler issues most of
its adds as IMAD, beside the maxes, so that mix runs above the INT32
lanes' count, and a bound must not exceed the least time the card takes.
"""

from __future__ import annotations

import math
import subprocess

import numpy as np
import torch

from calitas_tpu_torch.core.scoring import derive_scorer
from calitas_tpu_torch.ops import dp_cuda

#: independent accumulators of the peak probe (screen_ab.py's PEAK_C)
PEAK_C = 8
#: INT32 lanes per SM on Hopper (white paper: 64 INT32 units per SM)
INT32_LANES_PER_SM = 64
#: H100 SXM device memory rate, bytes/s (data sheet)
HBM_BYTES_PER_S = 3.35e12
_NEG_INF = -(2**30)


def _check(tcols: torch.Tensor, q_len: int, bias: int) -> tuple[int, int]:
    if tcols.dtype != torch.int32 or tcols.dim() != 2:
        raise ValueError(
            f"tcols must be a [T, N] int32 tensor, got {tcols.dtype} "
            f"{tuple(tcols.shape)}"
        )
    if not tcols.is_contiguous():
        raise ValueError("tcols must be contiguous")
    T, N = tcols.shape
    if T < 1 or N < 1 or q_len < 1:
        raise ValueError(f"need T, N, Q >= 1, got T={T} N={N} Q={q_len}")
    if not -(2**31) <= int(bias) < 2**31:
        raise ValueError(f"bias {bias} exceeds int32")
    if tcols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tcols.device}")
    return T, N


def ceiling_probe_reference(tcols: torch.Tensor, q_len: int, bias: int = 0) -> torch.Tensor:
    """Plain version of the ceiling probe: per lane, Q+1 int32 state from
    0 and ``best`` from -2^30; per column ``new[0] = tcol + bias``,
    ``new[i] = max(state[i] + 1, new[i-1])``, ``best = max(best,
    new[Q])``.  Returns ``best`` [N] int32."""
    T, N = _check(tcols, q_len, bias)
    state = [torch.zeros(N, dtype=torch.int32, device=tcols.device)] * (q_len + 1)
    best = torch.full((N,), _NEG_INF, dtype=torch.int32, device=tcols.device)
    for j in range(T):
        new = [tcols[j] + bias]
        for i in range(1, q_len + 1):
            new.append(torch.maximum(state[i] + 1, new[i - 1]))
        state = new
        best = torch.maximum(best, new[q_len])
    return best


def peak_probe_reference(tcols: torch.Tensor, q_len: int, bias: int = 0) -> torch.Tensor:
    """Plain version of the peak probe: per lane, PEAK_C accumulators
    starting at c; per column, Q times ``acc[c] = max(acc[c] + (c+1),
    tcol + bias)``.  Returns the max over the accumulators, [N] int32."""
    T, N = _check(tcols, q_len, bias)
    dev = tcols.device
    acc = torch.arange(PEAK_C, dtype=torch.int32, device=dev)[:, None].repeat(1, N)
    inc = torch.arange(1, PEAK_C + 1, dtype=torch.int32, device=dev)[:, None]
    for j in range(T):
        t = tcols[j] + bias
        for _ in range(q_len):
            acc = torch.maximum(acc + inc, t)
    return acc.max(dim=0).values


def _probe(name: str, tcols: torch.Tensor, q_len: int, bias: int) -> torch.Tensor:
    T, N = _check(tcols, q_len, bias)
    if tcols.device.type == "cpu":
        plain = ceiling_probe_reference if name == "ceiling_probe" else peak_probe_reference
        return plain(tcols, q_len, bias)
    if q_len > dp_cuda.Q_MAX:
        raise NotImplementedError(
            f"the CUDA {name} takes Q up to {dp_cuda.Q_MAX} (got {q_len})"
        )
    dev = tcols.device
    out = torch.empty(N, dtype=torch.int32, device=dev)
    lib = dp_cuda.library("probes")
    fn = lib.calitas_ceiling_probe if name == "ceiling_probe" else lib.calitas_peak_probe
    with torch.cuda.device(dev):
        err = fn(tcols.data_ptr(), T, N, q_len, int(bias), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    dp_cuda._raise_on(lib, err, name)
    dp_cuda._count_launch(name)
    return out


def ceiling_probe(tcols: torch.Tensor, q_len: int, bias: int = 0) -> torch.Tensor:
    """The ceiling probe over ``tcols`` [T, N] int32: ``best`` [N] int32
    (contract: :func:`ceiling_probe_reference`).  CUDA tensors launch the
    kernel on the current stream; CPU tensors run the plain version.
    Q > 48 on CUDA raises NotImplementedError."""
    return _probe("ceiling_probe", tcols, q_len, bias)


def peak_probe(tcols: torch.Tensor, q_len: int, bias: int = 0) -> torch.Tensor:
    """The peak probe over ``tcols`` [T, N] int32: [N] int32 (contract:
    :func:`peak_probe_reference`).  CUDA tensors launch the kernel on the
    current stream; CPU tensors run the plain version.  Q > 48 on CUDA
    raises NotImplementedError."""
    return _probe("peak_probe", tcols, q_len, bias)


# ---------------------------------------------------------------------------
# Work and bounds
# ---------------------------------------------------------------------------

def probe_work(name: str, T: int, N: int, q_len: int) -> tuple[int, int]:
    """``(int32 ops, bytes)`` of one probe call: 2 ops per add+max pair;
    tcols and bias read once, the result written once."""
    pairs = q_len * T * N * (PEAK_C if name == "peak_probe" else 1)
    return 2 * pairs, 4 * T * N + 4 + 4 * N


def grid_work(genome_len: int, base0: int, step: int, n_windows: int, window: int,
              q_len: int, guides: int = 1, emit_ranges: bool = True) -> tuple[int, int]:
    """``(int32 ops, bytes)`` of a dual-chain (``guides`` = 1) or
    multi-guide window-grid screen: every window's columns, both chains,
    each guide; the genome span the windows cover read once (bytes past
    the genome's end read as zeros, from no memory), the masks and
    thresholds read once, best and ranges written once."""
    cells = guides * 2 * q_len * n_windows * window
    end = base0 + (n_windows - 1) * step + window if n_windows else base0
    span = max(0, min(genome_len, end) - base0)
    out = guides * 2 * n_windows * 4 * (3 if emit_ranges else 1)
    return 2 * cells, span + guides * (2 * q_len * 4 + 4) + out


def rows_work(lengths, q_len: int, chains: int, per_row_query: bool,
              ranges: bool) -> tuple[int, int]:
    """``(int32 ops, bytes)`` of a row screen: each row's own length of
    columns (the kernel stops there; the masked tail is settled in closed
    form), ``chains`` chains; those target bytes, the lengths, the query
    masks (per row or one shared) and thresholds read once, best and
    ranges written once."""
    lengths = np.asarray(lengths, dtype=np.int64)
    B = len(lengths)
    cols = int(lengths.sum())
    qbytes = chains * B * q_len if per_row_query else q_len
    out = chains * B * 4 * (3 if ranges else 1)
    return 2 * cols * q_len * chains, cols + 4 * B + qbytes + (4 * B if ranges else 0) + out


def max_sm_clock_mhz(device) -> float:
    """The card's maximum SM clock, from ``nvidia-smi``."""
    index = torch.device(device).index or 0
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.strip().splitlines()[0])


def peak_int32_ops_per_s(device) -> float:
    """SMs x INT32 lanes per SM x maximum SM clock: the card's int32 rate
    outside the tensor cores."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * INT32_LANES_PER_SM * max_sm_clock_mhz(device) * 1e6


def bound_ms(ops: int, nbytes: int, peak_ops_per_s: float) -> tuple[float, str]:
    """The least time for ``ops`` int32 operations and ``nbytes`` of
    device memory traffic, in ms, and which of the two bounds it:
    ``"operations"`` or ``"bytes"``."""
    t_ops = 1e3 * ops / peak_ops_per_s
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the current CUDA stream: CUDA events
    around ``reps`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_times_ms(launches: dict, *, replay_ms: float = 2.0, trials: int = 5) -> dict:
    """``{key: ms}`` for ``launches``, ``{key: launch}``: the least over
    ``trials`` of the mean ms per call of each ``launch`` (a zero-arg
    function that only enqueues work on the current stream, such as
    ``dp_cuda._screen_multi_launcher``'s), with its calls captured in one
    CUDA graph.  The host's per-call cost stays out of the time, so
    launches of a few microseconds are timed as the card runs them back to
    back.  Each graph holds enough calls (3 to 1000) for one replay to take
    about ``replay_ms``, so that the replay's own start-up is a small share
    of the mean; each trial replays every key's graph in turn, so that a
    change of clock during the run falls on all keys alike.  CUDA events
    around each replay, after a warm-up call and a warm-up replay.  The
    graphs are captured on a stream of the current device, which is the
    device the launches must use."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    capture = torch.cuda.Stream()
    graphs = {}
    for key, launch in launches.items():
        launch()
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        reps = min(1000, max(3, math.ceil(replay_ms / max(start.elapsed_time(end), 1e-3))))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture):
            for _ in range(reps):
                launch()
        graph.replay()
        graphs[key] = graph, reps
    torch.cuda.synchronize()
    best = dict.fromkeys(graphs, float("inf"))
    for _ in range(trials):
        for key, (graph, reps) in graphs.items():
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            best[key] = min(best[key], start.elapsed_time(end) / reps)
    return best


def _row(ms: float, work: tuple[int, int], peak: float) -> dict:
    ops, nbytes = work
    b_ms, b_by = bound_ms(ops, nbytes, peak)
    return {"ms": ms, "ops": ops, "bytes": nbytes, "ops_per_s": 1e3 * ops / ms,
            "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms}


def roofline(device, *, reps: int = 20, seed: int = 0) -> dict:
    """Times, with CUDA events after a warm-up, both probes and the three
    screen kernels at their main-path shapes on seeded inputs made on the
    card, and returns each one's ms, op/s, bound (ms and whether
    operations or bytes set it) and share of its bound.  The int32 rate
    of the bounds is ``bound_ops_per_s``: the larger of the white-paper
    rate (``peak_int32_ops_per_s``) and the peak probe's on a
    card-filling shape (``peak_probe_ops_per_s``).

    Probe shapes: T 1024, Q 20 at N 32,768 (``screen_ab.py``'s) and at N
    = SMs x 2048 (every SM full).  Screen shapes: config3's grid (41,238
    windows of 1000 columns, step 973, Q 20, PAM gate and ranges on) for
    the dual kernel and the multi-guide kernel at G 4; the variant pass's
    slot batch (8,192 rows x 64 columns, flattened, one guide, gate and
    ranges off, launches timed as a CUDA graph) for the multi-guide
    kernel; 41,238 ragged rows x 1000 columns, one shared Q 20 query, and
    20,000 rows x slot 256, per-row queries, both chains, ranges on, for
    the row kernel (both timed as CUDA graphs).  Raises ValueError when
    ``device`` is not CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"roofline needs a CUDA device, got {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    peak = peak_int32_ops_per_s(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    Q, T = 20, 1024
    out = {"peak_int32_ops_per_s": peak, "max_sm_clock_mhz": max_sm_clock_mhz(device),
           "sms": sms, "probes": {}, "kernels": {}}

    probe_ms = {}
    for N in (32_768, sms * 2048):
        tcols = torch.randint(1, 16, (T, N), generator=gen, device=device,
                              dtype=torch.int32) | (3 << 4)
        for name, fn in (("ceiling_probe", ceiling_probe), ("peak_probe", peak_probe)):
            probe_ms[name, N] = cuda_time_ms(lambda: fn(tcols, Q), reps)
        del tcols
    fill = sms * 2048
    peak_probe_rate = 1e3 * probe_work("peak_probe", T, fill, Q)[0] / probe_ms["peak_probe", fill]
    out["peak_probe_ops_per_s"] = peak_probe_rate
    peak = out["bound_ops_per_s"] = max(peak, peak_probe_rate)
    for (name, N), ms in probe_ms.items():
        out["probes"][f"{name} N={N}"] = _row(ms, probe_work(name, T, N, Q), peak)

    scorer = derive_scorer()
    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    min_score = scorer.match_score * Q - 5 * 122  # five genome gaps below a perfect hit
    contig, window, step = 40_000_000, 1000, 973
    n_windows = (contig - window) // step + 1
    genome = (torch.randint(1, 16, (contig,), generator=gen, device=device,
                            dtype=torch.uint8) | (3 << 4)).contiguous()
    qv = rng.choice(np.array([1, 2, 4, 8], np.int32), (4, 2, Q))
    grid = dict(base0=0, step=step, n_windows=n_windows, window=window,
                pam_gate=True, **sk)
    ms = cuda_time_ms(lambda: dp_cuda.screen_dual(
        genome, qv[0], min_score=min_score, **grid), reps)
    out["kernels"]["screen_dual"] = _row(
        ms, grid_work(contig, 0, step, n_windows, window, Q), peak)
    mss = np.full(4, min_score, np.int32)
    ms = cuda_time_ms(lambda: dp_cuda.screen_multi(
        genome, qv, mss, emit_ranges=True, **grid), reps)
    out["kernels"]["screen_multi G=4"] = _row(
        ms, grid_work(contig, 0, step, n_windows, window, Q, guides=4), peak)
    del genome
    # The variant pass's slot batch, flattened: one wrapper call at a time
    # is paced by the host's mask upload, so the launches run as a graph.
    B, slot = 8192, 64
    slots = torch.randint(0, 16, (B * slot,), generator=gen, device=device, dtype=torch.uint8)
    launch, _out = dp_cuda._screen_multi_launcher(
        slots, qv[:1], mss[:1], base0=0, step=slot, n_windows=B, window=slot,
        pam_gate=False, emit_ranges=False, **sk)
    out["kernels"]["screen_multi slots G=1"] = _row(
        graph_times_ms({0: launch})[0], grid_work(B * slot, 0, slot, B, slot, Q,
                                              emit_ranges=False), peak)
    del slots, _out

    B, T_rows = n_windows, 1000
    tm = torch.randint(1, 16, (B, T_rows), generator=gen, device=device, dtype=torch.uint8)
    lens = rng.integers(0, T_rows + 1, B).astype(np.int32)
    ln = torch.from_numpy(lens).to(device)
    q = rng.choice(np.array([1, 2, 4, 8], np.uint8), (1, Q))
    launch, _out = dp_cuda._screen_rows_launcher(q, tm, ln, **sk)
    out["kernels"]["screen_rows shared"] = _row(
        graph_times_ms({0: launch})[0], rows_work(lens, Q, 1, False, False), peak)
    B, slot = 20_000, 256
    tm = torch.randint(1, 16, (B, slot), generator=gen, device=device, dtype=torch.uint8)
    lens = rng.integers(0, slot + 1, B).astype(np.int32)
    ln = torch.from_numpy(lens).to(device)
    qd = torch.from_numpy(rng.choice(np.array([1, 2, 4, 8], np.uint8), (2, B, Q))).to(device)
    ms_rows = torch.full((B,), min_score, dtype=torch.int32, device=device)
    launch, _out = dp_cuda._screen_rows_launcher(qd, tm, ln, ms_rows, **sk)
    out["kernels"]["screen_rows per-row"] = _row(
        graph_times_ms({0: launch})[0], rows_work(lens, Q, 2, True, True), peak)
    return out
