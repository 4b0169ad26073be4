"""Device-resident genome screening: the port of
``calitas_tpu/ops/genome_screen.py``'s reference-pass and slot screens.

A contig's raw bytes are staged to the device once and IUPAC-encoded
there; the PAM-gate bits 4/5 are stamped into that array once per screen
(:func:`annotate_genome_pam`, one kernel pass on the card); then a DP
kernel screens every window start ``0, step, 2*step, ...`` on both
strands, and the per-chain flags
(bit-packed) and coarse end-column ranges (uint8) come back to the host.
One guide runs the dual-chain kernel; a group of same-length guides
sharing a step and PAM spec runs the multi-guide kernel, one launch per
segment for the whole group.  The variant pass's slot batches run the
multi-guide kernel too (:func:`screen_slots_multi`).  A query longer than
the kernels take (``dp_cuda.Q_MAX``) runs the plain PyTorch screen on the
same device instead, by the static rule of ``dp_cuda.uses_kernel``.

Across a device mesh (``parallel/mesh.py``), :class:`ShardedGenomeScreen`
stages each contig once per distinct device and splits every segment's
windows into contiguous spans, one per mesh entry, each launched on that
entry's own CUDA stream; the sharded slot batches split their rows the
same way.  Flags and ranges are bit-identical to the one-device screen.

Strand handling: screening query q against revcomp(window) is equivalent
to screening revcomp(q) against the window, so both strands run against
the same forward genome with two queries.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from calitas_tpu_torch import spans
from calitas_tpu_torch.core.scoring import Scorer
from calitas_tpu_torch.core.sequence import IUPAC_MASK, encode_query
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops.dp_screen import (
    screen_dual_reference,
    screen_multi_reference,
)

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


def staged_length(n: int, window: int) -> int:
    """Length of a staged n-base contig: the power of two that holds every
    window of ``window`` bases starting in the contig."""
    return 1 << (n + window - 1).bit_length()


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

    By the static rule of ``dp_cuda.annotates_on_kernel``: a CUDA tensor
    with a spec within the kernel's limits runs ``csrc/pam_annotate.cu``
    (one pass, ``dp_cuda.pam_annotate``), anything else
    :func:`annotate_genome_pam_reference`; both give the same bits."""
    if dp_cuda.annotates_on_kernel(pam_spec, genome.device):
        return dp_cuda.pam_annotate(genome, pam_spec)
    return annotate_genome_pam_reference(genome, pam_spec)


def annotate_genome_pam_reference(genome: torch.Tensor, pam_spec) -> torch.Tensor:
    """:func:`annotate_genome_pam` in plain PyTorch ops on the tensor's
    device: bit for bit the staged form of the reference
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


def _pack_padded(flags: torch.Tensor) -> torch.Tensor:
    """:func:`_pack_flag_bits` of [..., n] flags zero-padded to a whole
    byte: [..., ceil(n/8)] uint8."""
    pad = -flags.shape[-1] % 8
    if pad:
        flags = torch.cat(
            [flags, flags.new_zeros((*flags.shape[:-1], pad))], dim=-1
        )
    return _pack_flag_bits(flags)


def _flags_and_coarse_ranges(best, ranges, min_scores, window):
    """Threshold and readback form of a grid screen: ``best`` [..., 2, n]
    against ``min_scores`` (broadcast over the chains and windows) as
    bit-packed [..., 2, ceil(n/8)] flags; ``ranges`` [..., 2, 2, n] as
    [..., 2, n, 2] uint8 blocks of ``range_block(window)`` columns."""
    rb = range_block(window)
    coarse = (
        torch.div(ranges - 1, rb, rounding_mode="floor")
        .clamp_(0, 255)
        .to(torch.uint8)
    )
    return _pack_padded(best >= min_scores), coarse.movedim(-2, -1).contiguous()


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
        host = torch.zeros(
            staged_length(n, self.window), dtype=torch.uint8,
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

    def _prepare(self, genome, dp_queries, pam_spec):
        """The genome annotated for ``pam_spec`` (once for a whole guide
        group), the [G, 2, Q] int32 query masks of ``dp_queries``
        [(dp_query, dp_query_rc), ...], and whether the gate is on."""
        spec = encode_pam_spec(pam_spec)
        if spec is not None:
            with spans.span("annotate"):
                genome = annotate_genome_pam(genome, spec)
        qvals = np.stack(
            [np.stack([encode_query(q), encode_query(qrc)]) for q, qrc in dp_queries]
        ).astype(np.int32)
        return genome, qvals, spec is not None

    def _screen_span(self, genome, qvals, pam_gate, base0, n, step, min_score):
        """One screen over windows [base0/step, +n), the kernel or the
        plain version by ``dp_cuda.uses_kernel``: device tensors of
        bit-packed flags [2, ceil(n/8)] and coarse ranges [2, n, 2]."""
        s = self.scorer
        screen = (
            dp_cuda.screen_dual
            if dp_cuda.uses_kernel(qvals.shape[-1], genome.device)
            else screen_dual_reference
        )
        best, ranges = screen(
            genome, qvals, base0=base0, step=step, n_windows=n,
            window=self.window, min_score=min_score, match=s.match_score,
            mismatch=s.mismatch_score, qgap=s.query_gap_score,
            tgap=s.target_gap_score, pam_gate=pam_gate,
        )
        return _flags_and_coarse_ranges(best, ranges, min_score, self.window)

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
        genome, qvals, gate = self._prepare(genome, [(dp_query, dp_query_rc)], pam_spec)
        packed, ranges = self._screen_span(genome, qvals[0], gate, 0, n, step, min_score)
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
        genome, qvals, gate = self._prepare(genome, [(dp_query, dp_query_rc)], pam_spec)

        def launch(g, s0, n):
            return self._screen_span(g, qvals[0], gate, s0 * step, n, step, min_score)

        return [(i0, n_seg, self._segment(genome, i0, n_seg, launch))
                for i0, n_seg in spans]

    def _upload(self, genome, arr: np.ndarray) -> dict:
        """``{device: arr}`` on the device of ``genome``, once per guide
        group."""
        return {genome.device: dp_cuda.to_device(arr, genome.device)}

    def _segment(self, genome, i0: int, n: int, launch):
        """``resolve`` of windows [i0, i0 + n): ``launch(genome, i0, n)``'s
        device results, read back without blocking (``dp_cuda.readback``)
        as (chain flags [..., 2, n] bool, ranges [..., 2, n, 2] uint8)."""
        with spans.span("segment_launch"):
            return dp_cuda.readback(launch(genome, i0, n), _chain_result(n))

    def _screen_span_multi(
        self, genome, qvals, min_scores, ms_dev, pam_gate, base0, n, step
    ):
        """One multi-guide screen over windows [base0/step, +n), routed
        as :meth:`_screen_span`: device tensors of bit-packed flags [G, 2,
        ceil(n/8)] and coarse ranges [G, 2, n, 2].  ``ms_dev`` is
        ``min_scores`` as a [G, 1, 1] tensor on the genome's device."""
        s = self.scorer
        best, ranges = _multi_screen(qvals, genome.device)(
            genome, qvals, min_scores, base0=base0, step=step, n_windows=n,
            window=self.window, match=s.match_score,
            mismatch=s.mismatch_score, qgap=s.query_gap_score,
            tgap=s.target_gap_score, pam_gate=pam_gate, emit_ranges=True,
        )
        return _flags_and_coarse_ranges(best, ranges, ms_dev, self.window)

    def screen_contig_multi_async(
        self,
        genome: torch.Tensor,
        contig_len: int,
        step: int,
        dp_queries: list,  # [(dp_query, dp_query_rc), ...] all same length
        min_scores: list,  # [G] per-guide qualifying thresholds
        pam_spec=None,  # shared (dp-orientation pams, max_pam_mm, max_gap)
        segments: int | None = None,
    ) -> list:
        """The multi-guide form of :meth:`screen_contig_async`: the genome
        is annotated once for the whole group and each segment is one
        multi-guide kernel launch.  Guides share a query length and (when
        given) a PAM spec.  Returns ``(start_index, n_windows, resolve)``
        triples; ``resolve()`` -> ``(chain_flags [G, 2, n_seg] bool,
        ranges [G, 2, n_seg, 2] uint8)``.  Per guide, values equal that
        guide's own :meth:`screen_contig_async`."""
        spans = self.segment_spans(
            len(self.window_starts(contig_len, step)), segments
        )
        if not spans or not dp_queries:
            return []
        genome, qvals, gate = self._prepare(genome, dp_queries, pam_spec)
        ms = np.asarray(min_scores, dtype=np.int32)
        ms_dev = self._upload(genome, ms.reshape(-1, 1, 1))

        def launch(g, s0, n):
            return self._screen_span_multi(
                g, qvals, ms, ms_dev[g.device], gate, s0 * step, n, step
            )

        return [(i0, n_seg, self._segment(genome, i0, n_seg, launch))
                for i0, n_seg in spans]


def _multi_screen(qvals, device):
    """The multi-guide screen for [G, 2, Q] ``qvals`` on ``device``: the
    kernel's wrapper or the plain version, by ``dp_cuda.uses_kernel``."""
    if dp_cuda.uses_kernel(qvals.shape[-1], device):
        return dp_cuda.screen_multi
    return screen_multi_reference


def _chain_result(n: int):
    """``finish`` of a grid screen's readback: (chain flags [..., 2, n]
    bool, coarse ranges [..., 2, n, 2] uint8)."""
    return lambda packed, ranges: (_unpack_flag_bits(packed, n), ranges)


def screen_contig_multi(
    screen: GenomeScreen,
    genome: torch.Tensor,
    contig_len: int,
    step: int,
    dp_queries: list,  # [(dp_query, dp_query_rc), ...] all same length
    min_scores: list,
) -> np.ndarray:
    """Per-chain boolean hit flags [G, 2, n_windows] for a same-length
    guide group, in one launch, with no PAM gate (chain 0 = DP query over
    the forward genome, 1 = its revcomp)."""
    n = len(screen.window_starts(contig_len, step))
    if n == 0:
        return np.zeros((len(dp_queries), 2, 0), dtype=bool)
    _, qvals, _ = screen._prepare(genome, dp_queries, None)
    ms = np.asarray(min_scores, dtype=np.int32)
    s = screen.scorer
    best, _ = _multi_screen(qvals, genome.device)(
        genome, qvals, ms, base0=0, step=step, n_windows=n,
        window=screen.window, match=s.match_score, mismatch=s.mismatch_score,
        qgap=s.query_gap_score, tgap=s.target_gap_score, pam_gate=False,
        emit_ranges=False,
    )
    ms_dev = dp_cuda.to_device(ms.reshape(-1, 1, 1), best.device)
    return _unpack_flag_bits(_pack_padded(best >= ms_dev).cpu().numpy(), n)


def slot_batch_unit(any_kernel: bool, mesh=None) -> int:
    """Row granularity of one slot batch: :data:`BATCH_UNIT` rows when a
    group runs the CUDA kernel (the reference's block), else the flag
    packer's 8; per mesh entry when the batch is split over a ``mesh``."""
    unit = BATCH_UNIT if any_kernel else 8
    if mesh is not None:
        unit *= len(mesh)
    return unit


def _slot_flags_multi(scorer: Scorer, tmasks: torch.Tensor, qvals, min_scores):
    """Candidate flags of G same-length guides over one [B, T] slot batch
    in one launch: the batch, flattened, is the window grid ``base0=0,
    step=T, window=T`` with the gate off; flags ``(best >= min_score)
    .any(chain)`` come back bit-packed as [G, B/8] uint8.  Slot lengths
    are ignored, as the Pallas slot path ignores them: zero padding only
    adds candidate end columns, so the flags are a superset that the
    exact host finish resolves."""
    B, T = tmasks.shape
    s = scorer
    best, _ = _multi_screen(qvals, tmasks.device)(
        tmasks.reshape(-1), qvals, min_scores, base0=0, step=T, n_windows=B,
        window=T, match=s.match_score, mismatch=s.mismatch_score,
        qgap=s.query_gap_score, tgap=s.target_gap_score, pam_gate=False,
        emit_ranges=False,
    )
    ms = dp_cuda.to_device(
        np.asarray(min_scores, dtype=np.int32).reshape(-1, 1, 1), best.device
    )
    return _pack_padded((best >= ms).any(dim=1))


def screen_slots_multi(
    scorer: Scorer,
    tmasks: np.ndarray,  # [B, T] uint8, B a multiple of 8
    groups,  # [(qvals [G, 2, Q] int32, min_scores [G]), ...]
    device,
    mesh=None,
) -> list:
    """Screen one slot batch for several same-length guide groups: the
    batch goes to the device once, and each group costs one launch plus
    one bit-packed readback.  Returns one zero-arg resolver per group;
    resolving waits for that group's readback and returns [G, B] bool
    flags.

    With a ``mesh`` of two or more entries (``parallel/mesh.py``) the
    rows split into contiguous spans, one per entry (:func:`mesh_spans`):
    each span goes to its entry's device and every group launches on it,
    on that entry's own stream; a resolver concatenates its group's spans
    in row order.  This is the counterpart of the reference's
    ``make_sharded_slot_flags``; the flags are bit-identical to the
    one-device screen's."""
    tmasks = tmasks.astype(np.uint8, copy=False)
    B = tmasks.shape[0]
    if mesh is None or len(mesh) < 2:
        entries = [(torch.device(device), None, 0, B)]
    else:
        streams = _mesh_streams(mesh)
        entries = [(mesh[k], streams[k], r0, n) for k, r0, n in mesh_spans(len(mesh), 0, B)]
    per_group = [[] for _ in groups]
    for dev, stream, r0, n in entries:
        with _on_stream(stream, dev):
            tm = dp_cuda.to_device(tmasks[r0 : r0 + n], dev)
            for resolves, (qvals, min_scores) in zip(per_group, groups):
                resolves.append(dp_cuda.readback(
                    (_slot_flags_multi(scorer, tm, qvals, min_scores),),
                    lambda packed, n=n: _unpack_flag_bits(packed, n),
                ))
    return [_concat_resolve(resolves, _cat_axis_last) for resolves in per_group]


# ---------------------------------------------------------------------------
# The window split over a device mesh
# ---------------------------------------------------------------------------

def mesh_spans(n_entries: int, i0: int, n: int) -> list:
    """``(entry, first, count)`` of each span of the n items (windows or
    slot rows) from ``i0`` split over ``n_entries`` mesh entries:
    contiguous, in order, each a whole number of bytes of packed flags (a
    multiple of 8 items) but the last; entries past the last item get no
    span (the reference's live-batch clip)."""
    per = -(-n // n_entries)
    per = -(-per // 8) * 8
    return [(k, i0 + k * per, min(per, n - k * per))
            for k in range(n_entries) if k * per < n]


def _mesh_streams(mesh) -> list:
    """One new stream per CUDA entry of ``mesh`` (None for a CPU entry):
    two entries on one card get two streams."""
    return [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in mesh]


@contextlib.contextmanager
def _on_stream(stream, dev, *inputs):
    """Run the block on ``stream``, a side stream of CUDA device ``dev``
    (with that device current: the kernels launch on the thread's current
    device), after all that the current stream of ``dev`` has queued so
    far; ``inputs``, made on that stream, stay allocated until ``stream``
    is done with them.  With no stream (a CPU entry) the block just runs."""
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(dev))
    for t in inputs:
        t.record_stream(stream)
    with torch.cuda.stream(stream):
        yield


def _cat_axis_last(parts):
    return np.concatenate(parts, axis=-1)


def _cat_chain_results(parts):
    """Spans' (chain flags [..., 2, n_k], ranges [..., 2, n_k, 2]) joined
    in window order."""
    return (np.concatenate([f for f, _r in parts], axis=-1),
            np.concatenate([r for _f, r in parts], axis=-2))


def _concat_resolve(resolves: list, cat):
    """One ``resolve`` over several spans' resolves, joined by ``cat``;
    a single span resolves as it is."""
    if len(resolves) == 1:
        return resolves[0]
    return lambda: cat([r() for r in resolves])


class ShardedGenomeScreen(GenomeScreen):
    """:class:`GenomeScreen` over a device mesh (``parallel/mesh.py``): the
    counterpart of the reference's ``ShardedGenomeScreen`` and its
    ``shard_map`` programs ``make_sharded_grid_screen[_multi]``.

    Same interface and bit-identical output (PAM gate, per-chain flags,
    coarse ranges).  :meth:`stage` returns ``{device: genome}``, the
    contig staged once per distinct device of the mesh; the screens also
    take a one-device genome (a resident contig staged by a
    :class:`GenomeScreen`) and copy it to the other devices.  Every
    segment of :meth:`GenomeScreen.segment_spans` splits into contiguous
    spans, one per mesh entry (:func:`mesh_spans`), each launched on that
    entry's own stream; a segment's ``resolve`` joins its spans in window
    order.  Entries may repeat a device: ``(cuda:0,) * 4`` runs four
    streams on one card, which share the one staged contig."""

    def __init__(self, scorer: Scorer, mesh, window: int = 1024,
                 batch_windows: int = 8192):
        mesh = tuple(torch.device(d) for d in mesh)
        if not mesh:
            raise ValueError("a ShardedGenomeScreen needs a mesh of one or more devices")
        super().__init__(scorer, mesh[0], window=window, batch_windows=batch_windows)
        self.mesh = mesh
        self._streams = _mesh_streams(mesh)

    def stage(self, contig_bases: np.ndarray) -> dict:
        """The contig uploaded as :meth:`GenomeScreen.stage` does, to the
        first device, then copied to each other distinct device of the
        mesh: ``{device: genome}``."""
        return self._replicas(super().stage(contig_bases))

    def _replicas(self, genome) -> dict:
        if isinstance(genome, dict):
            return genome
        out = {}
        for dev in self.mesh:
            if dev not in out:
                if genome.device == dev:
                    out[dev] = genome
                    continue
                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    out[dev] = genome.to(dev)
        return out

    def _prepare(self, genome, dp_queries, pam_spec):
        """:meth:`GenomeScreen._prepare` on every device's replica:
        ``({device: annotated genome}, qvals, gate)``."""
        out = {}
        for dev, g in self._replicas(genome).items():
            out[dev], qvals, gate = super()._prepare(g, dp_queries, pam_spec)
        return out, qvals, gate

    def _upload(self, genome: dict, arr: np.ndarray) -> dict:
        """``{device: arr}`` on every device of the replicas ``genome``,
        once per guide group, kept allocated until each entry's stream is
        done with it."""
        out = {dev: dp_cuda.to_device(arr, dev) for dev in genome}
        for dev, stream in zip(self.mesh, self._streams):
            if stream is not None:
                out[dev].record_stream(stream)
        return out

    def _segment(self, genome: dict, i0: int, n: int, launch):
        """Windows [i0, i0 + n) as one span per mesh entry, each launched
        by ``launch(replica, first, count)`` on the entry's stream after
        the replica's annotation, and read back on that stream."""
        resolves = []
        for k, s0, n_k in mesh_spans(len(self.mesh), i0, n):
            dev = self.mesh[k]
            with _on_stream(self._streams[k], dev, genome[dev]):
                resolves.append(super()._segment(genome[dev], s0, n_k, launch))
        return _concat_resolve(resolves, _cat_chain_results)

    def screen_contig(
        self,
        genome,
        contig_len: int,
        step: int,
        dp_query: str,
        dp_query_rc: str,
        min_score: int,
        pam_spec=None,
        return_chains: bool = False,
        return_ranges: bool = False,
    ):
        """:meth:`GenomeScreen.screen_contig` over the mesh: the whole
        window grid as one segment split into the entries' spans."""
        n = len(self.window_starts(contig_len, step))
        if n == 0:
            return self._empty_result(return_chains, return_ranges)
        [(_i0, _n, resolve)] = self.screen_contig_async(
            genome, contig_len, step, dp_query, dp_query_rc, min_score,
            pam_spec=pam_spec, segments=1,
        )
        chain_flags, ranges = resolve()
        if return_ranges:
            return chain_flags, ranges
        if return_chains:
            return chain_flags
        return chain_flags.any(axis=0)
