"""Device-resident genome screening: the port of
``calitas_tpu/ops/genome_screen.py``'s single-guide reference path.

A contig's raw bytes are staged to the device once and IUPAC-encoded
there; the PAM-gate bits 4/5 are stamped into that array once per screen
(:func:`annotate_genome_pam`); then the dual-chain DP kernel screens every
window start ``0, step, 2*step, ...`` on both strands, and the per-chain
flags (bit-packed) and coarse end-column ranges (uint8) come back to the
host.

Strand handling: screening query q against revcomp(window) is equivalent
to screening revcomp(q) against the window, so both strands run against
the same forward genome with two queries.
"""

from __future__ import annotations

import numpy as np
import torch

from calitas_tpu.core.scoring import Scorer
from calitas_tpu.core.sequence import IUPAC_MASK, encode_query
from calitas_tpu_torch.ops import dp_cuda

#: windows per screen batch unit.  The port's kernel needs no block
#: granularity; this keeps the segment partition of
#: :meth:`GenomeScreen.screen_contig_async` identical to the reference's
#: (``calitas_tpu.ops.dp_pallas2.BLOCK_W``).
BATCH_UNIT = 1024


def range_block(window: int) -> int:
    """Column width of one coarse end-column range block at this window:
    the smallest power-of-two multiple of 8 with ``window <= 256 *
    block``, so one uint8 (min, max) block pair per chain covers any
    window width."""
    rb = 8
    while window > rb * 256:
        rb *= 2
    return rb


def from_numpy_staged(arr: np.ndarray, device) -> torch.Tensor:
    """A staged (or annotated) genome from the JAX package (``np.asarray``
    of its device array) as this package's 1-D uint8 tensor."""
    return torch.from_numpy(np.array(arr, dtype=np.uint8).reshape(-1)).to(device)


def _encode_staged(raw: torch.Tensor) -> torch.Tensor:
    """Raw contig bytes -> 4-bit IUPAC target masks, on the tensor's
    device: ``x & 0xDF`` folds case (non-letters cannot alias a letter),
    N and unknown bytes (the zero padding included) encode to 0.  Equals
    ``TARGET_MASK_TABLE[raw]`` (core/sequence.py)."""
    u = raw & 0xDF
    m = torch.zeros_like(raw)
    for ch, mask in IUPAC_MASK.items():
        if ch != "N":
            m.masked_fill_(u == ord(ch), mask)
    return m


def _rc_mask(m: int) -> int:
    return ((m & 1) << 3) | ((m & 2) << 1) | ((m & 4) >> 1) | ((m & 8) >> 3)


def encode_pam_spec(pam_spec):
    """(dp-orientation PAM strings, max_mm, max_gap) -> (PAM mask tuples,
    max_mm, max_gap); None when there is no gate (no PAMs)."""
    if pam_spec is None:
        return None
    pams, max_pam_mm, max_gap = pam_spec
    if not pams or any(len(p) == 0 for p in pams):
        return None
    return (
        tuple(tuple(int(m) for m in encode_query(p)) for p in pams),
        int(max_pam_mm),
        int(max_gap),
    )


def annotate_genome_pam(genome: torch.Tensor, pam_spec) -> torch.Tensor:
    """The staged mask array with the PAM-gate bits stamped in: bit 4 =
    some PAM fits (<= max_mm mismatches) at a gap offset o <= max_gap
    right after a chain-A alignment ending here; bit 5 = some revcomp'd
    PAM fits right before a chain-B alignment starting after here.
    Positions outside the array read as mask 0 (a mismatch for every PAM
    base).  ``pam_spec`` is the encoded form of :func:`encode_pam_spec`.

    Bit for bit the staged form of the reference
    (``calitas_tpu.ops.genome_screen.annotate_genome_pam``), computed over
    the whole array at once instead of in chunks."""
    pams, max_mm, max_gap = pam_spec
    L = genome.numel()
    pad = max(len(p) for p in pams) + max_gap + 2
    gp = torch.cat([genome.new_zeros(pad), genome, genome.new_zeros(pad)])
    ext = L + max_gap
    end = torch.zeros(L, dtype=torch.bool, device=genome.device)
    start = torch.zeros(L, dtype=torch.bool, device=genome.device)
    for pam in pams:
        plen = len(pam)
        rc_pam = tuple(_rc_mask(m) for m in reversed(pam))
        # fit_e[t]: the PAM fits starting at genome position t+1;
        # fit_s[t]: the revcomp'd PAM fits starting at t-max_gap-plen+1
        mm_e = torch.zeros(ext, dtype=torch.uint8, device=genome.device)
        mm_s = torch.zeros(ext, dtype=torch.uint8, device=genome.device)
        s0 = pad - max_gap - plen + 1
        for k in range(plen):
            mm_e += (gp[pad + 1 + k : pad + 1 + k + ext] & pam[k]) == 0
            mm_s += (gp[s0 + k : s0 + k + ext] & rc_pam[k]) == 0
        fit_e = mm_e <= max_mm
        fit_s = mm_s <= max_mm
        for o in range(max_gap + 1):
            end |= fit_e[o : o + L]
            start |= fit_s[max_gap - o : max_gap - o + L]
    return genome | (end.to(torch.uint8) << 4) | (start.to(torch.uint8) << 5)


def _pack_flag_bits(flags: torch.Tensor) -> torch.Tensor:
    """[..., N] bool (N % 8 == 0) -> [..., N//8] uint8 bitmasks, bit k =
    element k (little-endian)."""
    b = flags.to(torch.uint8).reshape(*flags.shape[:-1], -1, 8)
    weights = torch.tensor(
        [1 << k for k in range(8)], dtype=torch.uint8, device=flags.device
    )
    return (b * weights).sum(dim=-1, dtype=torch.uint8)


def _unpack_flag_bits(packed: np.ndarray, n: int) -> np.ndarray:
    """Host-side inverse of :func:`_pack_flag_bits`, trimmed to n flags."""
    flat = np.unpackbits(packed, axis=-1, bitorder="little")
    return flat[..., :n].astype(bool)


class GenomeScreen:
    """Per-contig device screen: stage once, screen every window layout.

    Every call runs on ``device``: the CUDA kernel for a CUDA device, its
    plain PyTorch version for the CPU."""

    #: segments per contig for the pipelined screen: the host finishes
    #: segment N's candidates while the device screens segment N+1
    SEGMENTS = 16
    #: below this many window batches per segment, screen in one span
    MIN_BATCHES_PER_SEGMENT = 4
    #: windows per batch are capped so batch * window stays within this
    #: (the reference's extraction budget; here it only shapes segments)
    BATCH_ELEM_BUDGET = 8 << 20

    def __init__(
        self,
        scorer: Scorer,
        device,
        window: int = 1024,
        batch_windows: int = 8192,
    ):
        if batch_windows < 1:
            raise ValueError("batch_windows must be >= 1")
        self.scorer = scorer
        self.device = torch.device(device)
        self.window = window
        self.batch_windows = batch_windows

    def stage(self, contig_bases: np.ndarray) -> torch.Tensor:
        """Upload a contig's raw bytes as a zero-padded mask array: one
        H2D copy from pinned memory, then the IUPAC encode on device."""
        n = len(contig_bases)
        padded_len = 1 << (n + self.window - 1).bit_length()
        host = torch.zeros(
            padded_len, dtype=torch.uint8,
            pin_memory=self.device.type == "cuda",
        )
        host.numpy()[:n] = contig_bases
        return _encode_staged(host.to(self.device))

    def window_starts(self, contig_len: int, step: int) -> np.ndarray:
        """The reference's window starts: range(0, len-1, step)
        (SearchReference.scala:52)."""
        return np.arange(0, max(contig_len - 1, 0), step, dtype=np.int64)

    def _batch_windows_for(self, n: int, unit: int) -> int:
        """Windows per batch: the configured batch rounded up to the unit,
        trimmed to the window count, capped by BATCH_ELEM_BUDGET."""
        cap = max(
            unit,
            (self.BATCH_ELEM_BUDGET // max(self.window, 1)) // unit * unit,
        )
        bw = min(-(-self.batch_windows // unit) * unit, -(-n // unit) * unit)
        return min(bw, cap)

    def segment_spans(self, n: int, segments: int | None = None) -> list:
        """``(start_index, n_windows)`` of each segment of an n-window grid,
        in window order: the reference's partition (whole batches per
        segment, SEGMENTS at most, MIN_BATCHES_PER_SEGMENT each unless
        ``segments`` is given)."""
        if n == 0:
            return []
        bw = self._batch_windows_for(n, BATCH_UNIT)
        n_batches = -(-n // bw)
        if segments is None:
            segments = max(
                1,
                min(self.SEGMENTS, n_batches // self.MIN_BATCHES_PER_SEGMENT),
            )
        segments = max(1, min(segments, n_batches))
        bps = -(-n_batches // segments)  # batches per segment
        return [
            (b0 * bw, min(n - b0 * bw, bps * bw))
            for b0 in range(0, n_batches, bps)
        ]

    @staticmethod
    def _empty_result(return_chains: bool, return_ranges: bool):
        chains = np.zeros((2, 0), dtype=bool)
        if return_ranges:
            return chains, np.zeros((2, 0, 2), dtype=np.uint8)
        if return_chains:
            return chains
        return np.zeros(0, dtype=bool)

    def _prepare(self, genome, dp_query, dp_query_rc, pam_spec):
        spec = encode_pam_spec(pam_spec)
        if spec is not None:
            genome = annotate_genome_pam(genome, spec)
        qvals = np.stack(
            [encode_query(dp_query), encode_query(dp_query_rc)]
        ).astype(np.int32)
        return genome, qvals, spec is not None

    def _screen_span(self, genome, qvals, pam_gate, base0, n, step, min_score):
        """One kernel launch over windows [base0/step, +n): device tensors
        of bit-packed flags [2, ceil(n/8)] and coarse ranges [2, n, 2]."""
        s = self.scorer
        best, ranges = dp_cuda.screen_dual(
            genome, qvals, base0=base0, step=step, n_windows=n,
            window=self.window, min_score=min_score, match=s.match_score,
            mismatch=s.mismatch_score, qgap=s.query_gap_score,
            tgap=s.target_gap_score, pam_gate=pam_gate,
        )
        flags = best >= min_score
        pad = -n % 8
        if pad:
            flags = torch.cat([flags, flags.new_zeros((2, pad))], dim=1)
        rb = range_block(self.window)
        coarse = (
            torch.div(ranges - 1, rb, rounding_mode="floor")
            .clamp_(0, 255)
            .to(torch.uint8)
        )
        return _pack_flag_bits(flags), coarse.permute(0, 2, 1).contiguous()

    def screen_contig(
        self,
        genome: torch.Tensor,
        contig_len: int,
        step: int,
        dp_query: str,
        dp_query_rc: str,
        min_score: int,
        pam_spec=None,  # (dp-orientation pam strings, max_pam_mm, max_gap)
        return_chains: bool = False,
        return_ranges: bool = False,
    ):
        """Boolean hit flags for every window start, in one launch.

        A True flag means some end column of the window reaches
        ``min_score`` on either strand (a superset of the windows with
        hits).  ``return_chains`` gives per-chain flags [2, n];
        ``return_ranges`` also gives [2, n, 2] uint8 (min_block,
        max_block) coarse ranges in blocks of ``range_block(window)``
        columns: qualifying 1-based end columns of window i on chain c lie
        in [min_block*rb + 1, (max_block+1)*rb]."""
        n = len(self.window_starts(contig_len, step))
        if n == 0:
            return self._empty_result(return_chains, return_ranges)
        genome, qvals, gate = self._prepare(genome, dp_query, dp_query_rc, pam_spec)
        packed, ranges = self._screen_span(genome, qvals, gate, 0, n, step, min_score)
        chain_flags = _unpack_flag_bits(packed.cpu().numpy(), n)
        if return_ranges:
            return chain_flags, ranges.cpu().numpy()
        if return_chains:
            return chain_flags
        return chain_flags.any(axis=0)

    def screen_contig_async(
        self,
        genome: torch.Tensor,
        contig_len: int,
        step: int,
        dp_query: str,
        dp_query_rc: str,
        min_score: int,
        pam_spec=None,
        segments: int | None = None,
    ) -> list:
        """The pipelined :meth:`screen_contig` (per-chain flags + coarse
        ranges): launches every segment of the window grid at once and
        returns ``(start_index, n_windows, resolve)`` triples in window
        order.  Each segment's results are copied to pinned host memory
        without blocking, behind a recorded CUDA event; ``resolve()`` waits
        on that event and returns ``(chain_flags [2, n_seg] bool, ranges
        [2, n_seg, 2] uint8)``.  Values equal one :meth:`screen_contig`
        call over the same windows."""
        spans = self.segment_spans(
            len(self.window_starts(contig_len, step)), segments
        )
        if not spans:
            return []
        genome, qvals, gate = self._prepare(genome, dp_query, dp_query_rc, pam_spec)
        cuda = self.device.type == "cuda"
        out = []
        for i0, n_seg in spans:
            dev_out = self._screen_span(
                genome, qvals, gate, i0 * step, n_seg, step, min_score
            )
            event = None
            if cuda:
                host = tuple(
                    torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in dev_out
                )
                for h, t in zip(host, dev_out):
                    h.copy_(t, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            else:
                host = dev_out

            def resolve(host=host, event=event, n_seg=n_seg):
                if event is not None:
                    event.synchronize()
                return (
                    _unpack_flag_bits(host[0].numpy(), n_seg),
                    host[1].numpy(),
                )

            out.append((i0, n_seg, resolve))
        return out
