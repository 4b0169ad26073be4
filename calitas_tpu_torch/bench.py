"""End-to-end SearchReference throughput of the port on one CUDA device
(or a mesh): the counterpart of the root ``bench.py``, with the same
workload and the same metric.

Workload: a synthetic 1 Gb contig (``genome_mb`` Mb, 1024 by default)
written as FASTA with its ``.fai``; the guide ``CTTGCCCCACAGGGCAGTAAnrg``
at ``-d 5 -p 1 -g 3``, ``max_total_diffs`` 9, ``max_overlap`` 10, window
1000, step 970, ``min(4, cpu_count)`` finish threads.  The device screens
every window on both strands with the dual-chain kernel
(``csrc/screen_dual.cu``), the host finishes the flagged windows from the
FASTA with the native aligner, and the hits go through the global
overlap dedup, dictionary sort and 34-column TSV serialization
(``search/hits.py::dedup_sort_serialize``).  Rows are collected as
``tools/search_reference.py::run`` collects them: each finished block
whole.

The contig's bases are a murmur3 fmix32 stream of the position, made on
the host for the FASTA (:func:`genome_codes`) and on the device as the
staged mask array (:func:`device_genome_masks`), so the timed runs start
from a genome already on the device, as a resident genome would.  The
production staging from the FASTA (``GenomeScreen.stage``) is timed once
beside it and must give the same array.

The measured region is one end-to-end run of ``screened_search(...,
prestaged=)`` plus the dedup and serialization; the headline is the best
of three runs after one warm run.  Also reported: the dedup and
serialization's share of the best run, the screen alone over the same
segments, both stagings, the hit counts, the dual kernel's launches per
run, the peak device memory of the runs, and the card's name and power
limit.

Baseline: the port's NumPy oracle DP (``align/oracle.py::dp_matrix``) on
a seeded 24-window sample, one strand, best of three, taken before and
after the runs, doubled for both strands and scaled to 8 threads.

``python -m calitas_tpu_torch.bench [genome_mb] [--device cuda|cpu]``
prints one JSON line as its last stdout line (``metric``, ``value``,
``unit``, ``vs_baseline``) and the breakdown on stderr.  The device is
``cuda`` unless ``--device cpu`` is given (the plain PyTorch screen); no
card raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from calitas_tpu_torch import utils
from calitas_tpu_torch.align.engine import SequentialAligner
from calitas_tpu_torch.align.oracle import dp_matrix
from calitas_tpu_torch.core.guide import Guide
from calitas_tpu_torch.core.sequence import encode_query, revcomp
from calitas_tpu_torch.device import resolve_device
from calitas_tpu_torch.io.fasta import (
    DictEntry,
    IndexedFasta,
    SequenceDictionary,
    build_fai,
)
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops.genome_screen import (
    GenomeScreen,
    ShardedGenomeScreen,
    staged_length,
)
from calitas_tpu_torch.parallel.screen_runner import GuideTask, screened_search
from calitas_tpu_torch.search.hits import RenderedBlock, dedup_sort_serialize

GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"
WINDOW = 1000
ALIGN_KWARGS = dict(
    max_guide_diffs=5, max_pam_diffs=1, max_gaps_between_guide_and_pam=3,
    max_total_diffs=9, max_overlap=10,
)
STEP = WINDOW - (len(GUIDE) + 5 + 3 - 1)
HIT_TIMESTAMP = "Mon Jan 01 00:00:00 UTC 2026"
METRIC = (
    "genome bases searched/s end-to-end (SearchReference: device screen + "
    "native finish + dedup + TSV, 1 chip)"
)

#: murmur3 fmix32 of ``position * _MIX_M1``: the same stream on the host
#: (the FASTA) and on the device (the staged masks)
_MIX_M1, _MIX_M2, _MIX_M3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
#: positions per device generator step: the temporaries stay near 100 MB
CHUNK = 1 << 22
_LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def genome_codes(start: int, count: int) -> np.ndarray:
    """2-bit base codes (0-3 for A, C, G, T) of positions [start,
    start + count), uint8: fmix32 of the position times ``_MIX_M1``, all
    in uint32 arithmetic (wrapping)."""
    x = np.arange(count, dtype=np.uint32)
    x += np.uint32(start & 0xFFFFFFFF)
    x *= np.uint32(_MIX_M1)
    x ^= x >> 16
    x *= np.uint32(_MIX_M2)
    x ^= x >> 13
    x *= np.uint32(_MIX_M3)
    x ^= x >> 16
    return (x & 3).astype(np.uint8)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2**32`` for int64 ``x`` in [0, 2**32): the multiply is
    split at bit 16 of ``m`` so that no product leaves int64."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF


def genome_mask_block(start: int, count: int, device) -> torch.Tensor:
    """The staged masks (``1 << code``: A 1, C 2, G 4, T 8) of positions
    [start, start + count) on ``device``, uint8: :func:`genome_codes` in
    int64 torch arithmetic."""
    x = torch.arange(start, start + count, dtype=torch.int64, device=device)
    x &= 0xFFFFFFFF
    x = _mul32(x, _MIX_M1)
    x ^= x >> 16
    x = _mul32(x, _MIX_M2)
    x ^= x >> 13
    x = _mul32(x, _MIX_M3)
    x ^= x >> 16
    return (1 << (x & 3)).to(torch.uint8)


def device_genome_masks(padded_len: int, G: int, device) -> torch.Tensor:
    """The staged genome ([padded_len] uint8 on ``device``: ``1 << code``
    inside the G-base contig, 0 in the pad), the array
    ``GenomeScreen.stage`` makes of the FASTA, generated on the device in
    chunks of :data:`CHUNK` positions into one preallocated tensor."""
    out = torch.zeros(padded_len, dtype=torch.uint8, device=device)
    for c0 in range(0, min(G, padded_len), CHUNK):
        n = min(CHUNK, G - c0, padded_len - c0)
        out[c0 : c0 + n] = genome_mask_block(c0, n, device)
    return out


def write_fasta(path: str, bases: np.ndarray, line: int = 100) -> None:
    """One contig ``chr1`` of ``bases`` (ASCII) as FASTA, ``line`` bases
    per line."""
    n = len(bases)
    rows = n // line
    out = np.empty((rows, line + 1), dtype=np.uint8)
    out[:, :line] = bases[: rows * line].reshape(rows, line)
    out[:, line] = ord("\n")
    with open(path, "wb") as fh:
        fh.write(b">chr1\n")
        fh.write(out.tobytes())
        tail = bases[rows * line :]
        if len(tail):
            fh.write(tail.tobytes() + b"\n")


def make_genome(directory: str, G: int) -> tuple:
    """The benchmark contig of G bases written to ``directory/ref.fa`` with
    its ``.fai``: ``(fasta path, bases)``, bases as ASCII uint8 [G]."""
    bases = np.empty(G, dtype=np.uint8)
    for off in range(0, G, 1 << 26):
        n = min(1 << 26, G - off)
        bases[off : off + n] = _LETTERS[genome_codes(off, n)]
    fa = os.path.join(directory, "ref.fa")
    write_fasta(fa, bases)
    build_fai(fa)
    return fa, bases


def host_seconds(aligner: SequentialAligner, guide: Guide) -> float:
    """Best of three of the oracle DP over the seeded 24-window sample, one
    strand."""
    qmask = encode_query(guide.guide_fw)
    sample = np.random.default_rng(7).integers(1, 15, size=(24, WINDOW), dtype=np.uint8)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for row in sample:
            dp_matrix(qmask, row, aligner.scorer)
        best = min(best, time.perf_counter() - t0)
    return best


def _synchronize(devices) -> None:
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def pam_spec(guide: Guide) -> tuple:
    """The screen's PAM gate of ``guide`` at the bench's limits."""
    return (tuple(guide.pams_fw), ALIGN_KWARGS["max_pam_diffs"],
            ALIGN_KWARGS["max_gaps_between_guide_and_pam"])


def screen_only(screen: GenomeScreen, genome, G: int, guide: Guide, min_score: int) -> tuple:
    """The bench's screen alone (PAM annotation, every segment's launch and
    readback) over a staged ``genome``: ``(seconds, chain flags [2, n]
    bool, ranges [2, n, 2] uint8)``."""
    dq = guide.guide_fw
    t0 = time.perf_counter()
    parts = [resolve() for _i0, _n, resolve in screen.screen_contig_async(
        genome, G, STEP, dq, revcomp(dq), min_score, pam_spec=pam_spec(guide),
    )]
    seconds = time.perf_counter() - t0
    return (seconds, np.concatenate([f for f, _r in parts], axis=-1),
            np.concatenate([r for _f, r in parts], axis=-2))


def card_names() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one card per ``; ``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return "; ".join(out.stdout.strip().splitlines())


def search_bench(fasta: str, G: int, *, device=None, mesh=None) -> dict:
    """The bench on the G-base contig ``fasta`` (from :func:`make_genome`),
    on ``device`` (default ``cuda``; ``cpu`` runs the plain screen) or
    split over ``mesh`` (a tuple of devices, ``parallel/mesh.py``): one
    warm run, then the best of three timed ones.  Raises when a run
    degrades to the host or the staged arrays differ.  Returns the
    numbers, with ``body`` (the table without its header), ``bases_per_s``
    and ``vs_baseline``."""
    threads = min(4, os.cpu_count() or 1)
    guide = Guide.parse(GUIDE)
    aligner = SequentialAligner()
    if mesh is None:
        screen = GenomeScreen(aligner.scorer, resolve_device(device), window=WINDOW)
        devices = [screen.device]
    else:
        screen = ShardedGenomeScreen(aligner.scorer, mesh, window=WINDOW)
        devices = list(dict.fromkeys(screen.mesh))
    degraded = sum(utils.DEGRADED.values())
    host_s = host_seconds(aligner, guide)

    _synchronize(devices)  # the CUDA context exists before staging is timed
    t0 = time.perf_counter()
    masks = {dev: device_genome_masks(staged_length(G, WINDOW), G, dev) for dev in devices}
    _synchronize(devices)
    stage_once = time.perf_counter() - t0
    genome = masks if mesh is not None else masks[devices[0]]

    ref_file = IndexedFasta(fasta)
    t0 = time.perf_counter()
    staged = screen.stage(ref_file.get_bases("chr1"))
    _synchronize(devices)
    stage_fasta = time.perf_counter() - t0
    staged = staged if mesh is not None else {devices[0]: staged}
    if any(not torch.equal(staged[dev], masks[dev]) for dev in devices):
        raise RuntimeError("GenomeScreen.stage of the FASTA differs from the generated masks")
    del staged
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    dictionary = SequenceDictionary([DictEntry(name="chr1", length=G, assembly="bench")])
    tasks = [GuideTask(guide_id="bench", guide=guide, guide_length=len(GUIDE),
                       step_size=STEP)]
    hit_spec = dict(ref_path=fasta, aligner_id="CALITAS:SearchReference",
                    arguments="bench", vcf_id=None, timestamp=HIT_TIMESTAMP)

    def e2e_once() -> tuple:
        """(raw hits, kept hits, table body, seconds of the dedup and
        serialization) of one run."""
        hits = []
        for _t, _c, _s, rows in screened_search(
            ref_file, None, tasks, aligner, window_size=WINDOW, threads=threads,
            swallow_errors=True, hit_spec=hit_spec, screen=screen,
            prestaged={"chr1": genome}, **ALIGN_KWARGS,
        ):
            if type(rows) is RenderedBlock:
                hits.append(rows)
            else:
                hits.extend(rows)
        t0 = time.perf_counter()
        body, n_keep, _n_fwd = dedup_sort_serialize(
            hits, ALIGN_KWARGS["max_overlap"], dictionary)
        return sum(len(rows) for rows in hits), n_keep, body, time.perf_counter() - t0

    before = dp_cuda.launches["screen_dual"]
    n_raw, n_kept, body, _dedup = e2e_once()  # warm: the finish pool spawns
    launches = dp_cuda.launches["screen_dual"] - before
    times, dedups = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        dedups.append(e2e_once()[3])
        times.append(time.perf_counter() - t0)
    min_score = aligner.min_guide_score(guide, ALIGN_KWARGS["max_guide_diffs"])
    screen_s, _flags, _ranges = screen_only(screen, genome, G, guide, min_score)
    # the host's speed drifts: the faster of two samples is the baseline
    host_s = min(host_s, host_seconds(aligner, guide))
    if sum(utils.DEGRADED.values()) != degraded:
        raise RuntimeError(f"the bench degraded to the host: {utils.DEGRADED}")

    best = int(np.argmin(times))
    e2e_best = times[best]
    bases_per_s = G / e2e_best
    host_bps = 24 * STEP / (host_s * 2) * 8  # both strands, 8 threads
    return {
        "genome_bases": G,
        "devices": [str(d) for d in (screen.mesh if mesh is not None else devices)],
        "threads": threads,
        "e2e_best": e2e_best,
        "e2e_runs": times,
        "dedup": dedups[best],
        "screen": screen_s,
        "stage_once": stage_once,
        "stage_fasta": stage_fasta,
        "raw_hits": n_raw,
        "kept": n_kept,
        "table_bytes": len(body),
        "launches": launches,
        "segments": len(screen.segment_spans(len(screen.window_starts(G, STEP)))),
        "peak_device_bytes": {str(d): torch.cuda.max_memory_allocated(d)
                              for d in devices if d.type == "cuda"},
        "host8t_baseline": host_bps,
        "bases_per_s": bases_per_s,
        "vs_baseline": bases_per_s / host_bps,
        "body": body,
    }


def metric_line(result: dict) -> dict:
    """The bench's one JSON line of a one-device result."""
    return {
        "metric": METRIC,
        "value": round(result["bases_per_s"]),
        "unit": "bases/s",
        "vs_baseline": round(result["vs_baseline"], 2),
    }


def breakdown(result: dict) -> str:
    """The result's numbers (all but the table) as one ``# key=value``
    line."""
    return "# " + " ".join(f"{k}={v}" for k, v in result.items() if k != "body")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m calitas_tpu_torch.bench")
    ap.add_argument("genome_mb", nargs="?", type=float, default=1024.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch screen)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # no card and no --device cpu: raises
    G = int(args.genome_mb * 1e6)
    with tempfile.TemporaryDirectory(prefix="calitas_bench_") as tmp:
        fasta, _bases = make_genome(tmp, G)
        del _bases
        result = search_bench(fasta, G, device=device)
    card = card_names() if device.type == "cuda" else "cpu"
    print(f"# card: {card}", file=sys.stderr)
    print(breakdown(result), file=sys.stderr)
    print(json.dumps(metric_line(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
