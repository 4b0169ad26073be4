#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (calitas_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX.  Phases, each raising on failure:

1. Device: a CUDA device is required; prints the card's name and power
   limit and whether the native host finish library loaded.
2. Build: compiles the CUDA screen kernel from ``calitas_tpu_torch/csrc``.
3. Kernel vs plain: on a seeded 40 Mb annotated genome with planted guide
   sites, the kernel's best scores and end-column ranges must equal its
   plain PyTorch version bit for bit (query lengths 20/24/48, PAM gate on
   and off, windows 40/64/1000/1003/2500); times both at the main path's
   shape (window 1000, 20-base guide, one segment of the 40 Mb contig).
4. Main path: golden config 3 (benchmarks/run_configs.py: a 40 Mb
   synthetic chr21-scale contig with 40 planted sites) through the port's
   CLI with ``--engine gpu``; the table must equal
   benchmarks/golden/config3.txt.gz with time_stamp and aligner_version
   blanked, the kernel must have launched at least once per segment, and
   the plain version never on the card.

The line before the last is a JSON object describing the kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, without
that line, when there is no CUDA device or the repository is missing.
"""

from __future__ import annotations

import gzip
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"
CONTIG = 40_000_000  # golden config 3's chr21-scale contig


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def synthetic_genome(np, n: int, seed: int, protos: list) -> "np.ndarray":
    """Random ACGT bytes with mutated copies of each protospacer (plus a
    PAM, on either strand) planted throughout."""
    from calitas_tpu.core.sequence import revcomp

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n, dtype=np.uint8)]
    for proto in protos:
        for _ in range(60):
            site = list(proto)
            for _ in range(int(rng.integers(0, 5))):
                i = int(rng.integers(0, len(site)))
                site[i] = "ACGT"[int(rng.integers(0, 4))]
            seq = "".join(site) + ("AGG", "TGG", "CAG")[int(rng.integers(0, 3))]
            if rng.random() < 0.5:
                seq = revcomp(seq)
            pos = int(rng.integers(0, n - len(seq)))
            bases[pos : pos + len(seq)] = np.frombuffer(seq.encode(), np.uint8)
    return bases


def cuda_time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events, after
    one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(torch, np, dp_cuda, dp_screen, gs, scorer, device):
    """Phase 3: returns (max_abs_err over all cases, kernel ms, plain ms)."""
    rng = np.random.default_rng(11)
    protos = {
        20: GUIDE[:20],
        24: "".join("ACGT"[i] for i in rng.integers(0, 4, 24)),
        48: "".join("ACGT"[i] for i in rng.integers(0, 4, 48)),
    }
    from calitas_tpu.core.sequence import encode_query, revcomp

    t0 = time.perf_counter()
    raw = synthetic_genome(np, CONTIG, 7, list(protos.values()))
    screen = gs.GenomeScreen(scorer, device, window=1000)
    genome = gs.annotate_genome_pam(
        screen.stage(raw), gs.encode_pam_spec((("nrg",), 1, 3))
    )
    torch.cuda.synchronize()
    log(f"[kernel] 40 Mb annotated genome staged in {time.perf_counter() - t0:.3f} s")
    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    cases = [  # (Q, window, pam_gate, max windows compared)
        (20, 1000, True, None), (20, 1000, False, None), (20, 1003, True, None),
        (24, 40, True, 200_000), (24, 64, False, 200_000),
        (24, 2500, False, None), (48, 64, True, 200_000),
        (48, 1001, False, None), (48, 2500, True, None),
    ]
    max_err = 0
    main_kw = None
    for Q, window, gate, cap in cases:
        step = window - (Q + 3 + 5 + 3 - 1)  # the CLI's step for a Q+3 guide
        n = len(screen.window_starts(CONTIG, step))
        if cap is not None:
            n = min(n, cap)
        qvals = np.stack(
            [encode_query(protos[Q]), encode_query(revcomp(protos[Q]))]
        ).astype(np.int32)
        kw = dict(base0=0, step=step, n_windows=n, window=window,
                  min_score=scorer.match_score * Q - 5 * 122, pam_gate=gate, **sk)
        got = dp_cuda.screen_dual(genome, qvals, **kw)
        want = dp_screen.screen_dual_reference(genome, qvals, **kw)
        torch.cuda.synchronize()
        err = max(
            int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            for g, w in zip(got, want)
        )
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        flagged = int((got[0] >= kw["min_score"]).any(0).sum())
        log(f"[kernel] Q={Q} window={window} gate={gate} windows={n} "
            f"flagged={flagged} bit-identical={same} max_abs_err={err}")
        if not same:
            raise AssertionError(f"kernel != plain at Q={Q} window={window} gate={gate}")
        max_err = max(max_err, err)
        if (Q, window, gate) == (20, 1000, True):
            main_kw = (qvals, kw)
            if flagged == 0:
                raise AssertionError("no planted site flagged")
    qvals, kw = main_kw
    spans = screen.segment_spans(kw["n_windows"])
    kw["n_windows"] = spans[0][1]  # one segment of the 40 Mb contig
    kernel_ms = cuda_time_ms(torch, lambda: dp_cuda.screen_dual(genome, qvals, **kw), 20)
    plain_ms = cuda_time_ms(
        torch, lambda: dp_screen.screen_dual_reference(genome, qvals, **kw), 3
    )
    log(f"[kernel] main-path shape (window 1000, Q 20, gate on, one segment of "
        f"{kw['n_windows']} windows of the 40 Mb contig): kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return max_err, kernel_ms, plain_ms


def norm_rows(text: str) -> list:
    """Table rows with the run-varying columns blanked."""
    lines = text.splitlines()
    hdr = lines[0].split("\t")
    varying = [i for i, c in enumerate(hdr) if c in ("time_stamp", "aligner_version")]
    out = [tuple(hdr)]
    for line in lines[1:]:
        f = line.split("\t")
        for i in varying:
            f[i] = ""
        out.append(tuple(f))
    return out


def main_path(torch, dp_cuda, dp_screen, gs, scorer, device, tmp: Path) -> int:
    """Phase 4: golden config 3 through the port's CLI; returns the
    kernel launches of that run."""
    from calitas_tpu.io.fasta import IndexedFasta
    from calitas_tpu_torch import cli

    spec = importlib.util.spec_from_file_location(
        "run_configs", ROOT / "benchmarks" / "run_configs.py"
    )
    configs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(configs)
    configs.OUT = tmp
    t0 = time.perf_counter()
    ref = configs.build_ref(CONTIG, 3, "c3chr21")
    log(f"[config3] reference built in {time.perf_counter() - t0:.3f} s")
    out = tmp / "config3.txt"
    argv = ["SearchReference", "-i", GUIDE, "-I", "bench", "-r", str(ref),
            "-o", str(out), "-d", "5", "-p", "1", "--engine", "gpu"]

    dp_cuda.launches = 0
    dp_screen.reference_calls["cuda"] = 0
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = dp_cuda.launches
    plain_on_card = dp_screen.reference_calls["cuda"]
    if rc != 0:
        raise RuntimeError(f"SearchReference exited {rc}")

    got = norm_rows(out.read_text())
    want = norm_rows(
        gzip.decompress((ROOT / "benchmarks/golden/config3.txt.gz").read_bytes()).decode()
    )
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w) if len(got) == len(want) else None
        raise AssertionError(
            f"config3 table differs from golden: {len(got)} vs {len(want)} lines, "
            f"first differing line {bad}"
        )
    fasta = IndexedFasta(ref)
    step = 1000 - (len(GUIDE) + 5 + 3 - 1)  # the CLI's step at -d 5 -g 3
    n = len(gs.GenomeScreen(scorer, device, window=1000).window_starts(CONTIG, step))
    n_segments = len(gs.GenomeScreen(scorer, device, window=1000).segment_spans(n))
    log(f"[config3] table == golden ({len(got) - 1} rows); kernel launches "
        f"{launches} (segments {n_segments}); plain version on the card {plain_on_card}")
    if launches < n_segments:
        raise AssertionError(f"kernel launched {launches} times, < {n_segments} segments")
    if plain_on_card != 0:
        raise AssertionError("the main path ran the plain screen on the card")
    log(f"[config3] end to end {e2e:.3f} s, {CONTIG / e2e:.6g} bases/s")

    # Screen alone on the same contig: stage + annotate + kernel + readback.
    screen = gs.GenomeScreen(scorer, device, window=1000)
    from calitas_tpu.core.sequence import revcomp

    q = GUIDE[:20]
    bases = fasta.get_bases("chr21")
    for attempt in range(2):  # the first pass warms the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        genome = screen.stage(bases)
        segs = screen.screen_contig_async(
            genome, CONTIG, step, q, revcomp(q), 60 * 20 - 5 * 122,
            pam_spec=(("nrg",), 1, 3),
        )
        flags = [resolve()[0] for _i0, _n, resolve in segs]
        dt = time.perf_counter() - t0
    cand = int(sum(f.any(axis=0).sum() for f in flags))
    log(f"[config3] screen only (stage + annotate + kernel + readback): {dt:.4f} s, "
        f"{n} windows, {cand} candidates")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA device "
              "is required", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from calitas_tpu import native
    from calitas_tpu.core.scoring import derive_scorer
    from calitas_tpu_torch.device import resolve_device
    from calitas_tpu_torch.ops import dp_cuda, dp_screen
    from calitas_tpu_torch.ops import genome_screen as gs

    # 1. Device
    device = resolve_device("cuda")
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(device)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"native finish library loaded: {native.available()}")

    # 2. Build
    t0 = time.perf_counter()
    dp_cuda.library()
    log(f"[build] {dp_cuda.SOURCE.relative_to(ROOT)} built and loaded in "
        f"{time.perf_counter() - t0:.3f} s")

    # 3. Kernel vs plain, on the card
    scorer = derive_scorer()
    max_err, kernel_ms, plain_ms = kernel_vs_plain(
        torch, np, dp_cuda, dp_screen, gs, scorer, device
    )

    # 4. Main path at chr21 scale
    with tempfile.TemporaryDirectory() as tmp:
        launches = main_path(torch, dp_cuda, dp_screen, gs, scorer, device, Path(tmp))

    from calitas_tpu.parallel import host_pool

    if host_pool._SHARED_POOL is not None:  # stop the finish workers
        host_pool._SHARED_POOL.shutdown(wait=True)

    log(smi)
    print(json.dumps({"kernels": [{
        "name": "screen_dual",
        "route": "cuda",
        "source": "calitas_tpu_torch/csrc/screen_dual.cu",
        "replaces": "calitas_tpu/ops/dp_pallas2.py:221",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
