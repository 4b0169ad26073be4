#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (calitas_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX and nothing of the JAX package ``calitas_tpu``:
the golden configurations' inputs come from ``calitas_tpu_torch.goldens``.
Phases, each raising on failure:

1. Device: a CUDA device is required; prints the card's name and power
   limit and whether the port's native host finish library loaded.
2. Build: compiles the CUDA kernels from ``calitas_tpu_torch/csrc`` (the
   three screens and the roofline probes), one nvcc per source, started
   together.
3. Kernel vs plain: on a seeded 40 Mb annotated genome with planted guide
   sites, the kernel's best scores and end-column ranges must equal its
   plain PyTorch version bit for bit (query lengths 20/24/48, PAM gate on
   and off, windows 40/64/1000/1003/2500); times both at the main path's
   shape (window 1000, 20-base guide, one segment of the 40 Mb contig).
4. Main path: golden config 3 (a 40 Mb synthetic chr21-scale contig with
   40 planted sites) through the port's
   CLI with ``--engine gpu``; the table must equal
   benchmarks/golden/config3.txt.gz with time_stamp and aligner_version
   blanked, the kernel must have launched at least once per segment, and
   the plain version never on the card.
5. Multi-guide kernel vs plain: on phase 3's genome, the multi-guide
   kernel's best scores and ranges must equal its plain PyTorch version
   bit for bit on window grids (G 1/4/17, Q 20/24/48, gate on and off,
   windows 40/64/1000/1003) and on slot batches (B 8192, T 64/128/512, gate
   off); times the kernel at G 4/8/16 and the plain version at G 4 on one
   segment of the main path's shape.
6. Golden config 5s: config 5s's four same-length guides over
   its 10 Mb contig, as a ``--guide-file`` through the port's CLI; the
   table must equal benchmarks/golden/config5s.txt.gz, the multi-guide
   kernel must have launched at least once per segment, the dual kernel
   and the plain versions never.  Times the fused screen against four
   dual-kernel launches at that shape.
7. Golden config 4: config 4's 5 Mb contig and 2,000 SNVs, prepared with
   the port's PrepareVcf, through the CLI with ``-v``; the table must
   equal benchmarks/golden/config4.txt and the slot-mode multi-guide
   kernel must have launched.
8. Variant pass at scale: config 3's 40 Mb contig with 160,000 seeded
   SNVs (one per 250 bases) through the CLI with ``-v``, on the card and
   with ``--device cpu`` (the plain versions); the tables must be
   identical and the finish pool must not break.  Prints each pass's wall
   time, the variant-window count and the pool's size.
9. Row kernel vs plain: the row screen (``csrc/screen_rows.cu``) must equal
   its plain PyTorch version bit for bit in shared-query mode (B 8192 x T
   64/128/512, and B 41,238 x T 1000 with ragged lengths, at Q 1/20/24/48)
   and in per-row mode (B 20,000 x slots 64/128/256, lengths 0..slot,
   ranges on and off); times both at B 41,238 x T 1000, Q 20 (shared) and
   20,000 x 256 (per-row).
10. Golden configs 1 (PairwiseAlignSequences) and 2 (AlignToReference)
   through the port's CLI with ``--engine gpu`` and ``--engine host``: the
   tables must equal the goldens, the row kernel must have launched and
   no plain version may run on the card (each pair-screen chunk makes one
   screen call, so then every chunk launched the kernel).
11. The list tools at scale: 20,000 hit-dense pairs, and AlignToReference
   all-hits (``-w 200 -d 4 -p 1 -O 5``) at 20,000 loci on config 3's 40 Mb
   contig, each with config 3's guide and a 24-base 5'-PAM guide, on
   ``--engine gpu`` and ``--engine host``: the tables must be identical
   and the finish pool must not break.  Prints both wall times.
12. A guide whose DP query is 50 bases (over the kernels' 48) through
   SearchReference on config 2's 2 Mb contig on the card and with
   ``--device cpu``: the tables must be identical, the route must be
   logged, the plain screen must have run on the card and no screen
   kernel for it.
13. Roofline probes: the Q 20 probes' SASS must hold at least one max
   instruction per add+max pair of a column (nothing folded); each probe
   (``csrc/probes.cu``) must equal its plain
   PyTorch version bit for bit at a small shape and at
   benchmarks/screen_ab.py's (T 1024, N 32,768, Q 20); times both there;
   then ``ops/probes.py::roofline`` times both probes there and on a
   card-filling shape (N = SMs x 2048) and the three screen kernels at
   their main-path shapes, and prints each one's bound and share.

After the phases, passed or not, it stops every process it started and
waits for each to end: the finish pool's workers, then the resource
tracker of the pool's spawn context, then any other descendant.

The line before the last is a JSON object describing the kernels (the
launch counts are those of the main paths: phase 4 for the dual kernel,
phases 6 and 7 for the multi-guide kernel, the gpu runs of phases 10 and
11 for the row kernel, phase 13's roofline run for the probes; the row
kernel's times are those of the list tools' per-row mode; each bound is
that of the timed call's inputs); the last line is ``{"ok":
true, "device": {...}}``.  Exits non-zero, without that line, when there
is no CUDA device or the repository is missing.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"
CONTIG = 40_000_000  # golden config 3's chr21-scale contig
DEFAULT_STEP = 1000 - (len(GUIDE) + 5 + 3 - 1)  # the CLI's step at -w 1000 -d 5 -g 3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(path: Path) -> str:
    """Registers per kernel instantiation and spill bytes, from ptxas's
    ``-v`` report of one build (written beside the library at build
    time; a library built by an earlier process has its report too)."""
    import re

    text = path.read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
    probes = {k: [int(r) for r in re.findall(
        rf"{k}ILi(?:20|48)E.*?\n.*?\n.*?Used (\d+) registers", text)]
        for k in ("ceiling_kernel", "peak_kernel")}
    return (f"{len(regs)} instantiations, registers {min(regs)}-{max(regs)}, "
            f"{sum(1 for b in spills if b)} with spills ({sum(spills)} bytes)"
            + (f"; Q 20/48: {probes}" if any(probes.values()) else ""))


def synthetic_genome(np, n: int, seed: int, protos: list) -> "np.ndarray":
    """Random ACGT bytes with mutated copies of each protospacer (plus a
    PAM, on either strand) planted throughout."""
    from calitas_tpu_torch.core.sequence import revcomp

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
    from calitas_tpu_torch.ops.probes import cuda_time_ms as timed

    return timed(fn, reps)


def kernel_vs_plain(torch, np, dp_cuda, dp_screen, gs, scorer, device):
    """Phase 3: returns (max_abs_err over all cases, kernel ms, plain ms,
    the annotated genome, the timed call's window count)."""
    rng = np.random.default_rng(11)
    protos = {
        20: GUIDE[:20],
        24: "".join("ACGT"[i] for i in rng.integers(0, 4, 24)),
        48: "".join("ACGT"[i] for i in rng.integers(0, 4, 48)),
    }
    from calitas_tpu_torch.core.sequence import encode_query, revcomp

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
    return max_err, kernel_ms, plain_ms, genome, kw["n_windows"]


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


def golden_rows(config: str) -> list:
    from calitas_tpu_torch.goldens import GOLDEN

    name = GOLDEN[config]
    path = ROOT / "benchmarks" / "golden" / name
    data = path.read_bytes()
    return norm_rows((gzip.decompress(data) if name.endswith(".gz") else data).decode())


def assert_same_table(got: list, want: list, what: str) -> None:
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w) if len(got) == len(want) else None
        raise AssertionError(
            f"{what}: {len(got)} vs {len(want)} lines, first differing line {bad}"
        )


def run_cli(torch, cli, argv: list) -> float:
    """The port's CLI in this process; returns its wall seconds."""
    argv = [str(a) for a in argv]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def main_path(torch, dp_cuda, dp_screen, gs, scorer, device, tmp: Path) -> int:
    """Phase 4: golden config 3 through the port's CLI; returns the
    kernel launches of that run."""
    from calitas_tpu_torch import cli, goldens
    from calitas_tpu_torch.io.fasta import IndexedFasta

    t0 = time.perf_counter()
    argv = goldens.config3(tmp)
    ref = argv[argv.index("-r") + 1]
    log(f"[config3] reference built in {time.perf_counter() - t0:.3f} s")
    out = tmp / "config3.txt"
    argv = [*argv, "-o", str(out), "--engine", "gpu"]

    dp_cuda.reset_launches()
    dp_screen.reference_calls["cuda"] = 0
    e2e = run_cli(torch, cli, argv)
    launches = dp_cuda.launches["screen_dual"]
    plain_on_card = dp_screen.reference_calls["cuda"]

    got = norm_rows(out.read_text())
    want = golden_rows("3")
    assert_same_table(got, want, "config3 table differs from golden")
    fasta = IndexedFasta(ref)
    step = DEFAULT_STEP
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
    from calitas_tpu_torch.core.sequence import revcomp

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


def guide_qvals(np, protos: list) -> "np.ndarray":
    """[G, 2, Q] int32 chain-A and chain-B query masks of the protospacers."""
    from calitas_tpu_torch.core.sequence import encode_query, revcomp

    return np.stack(
        [np.stack([encode_query(p), encode_query(revcomp(p))]) for p in protos]
    ).astype(np.int32)


def multi_vs_plain(torch, np, dp_cuda, dp_screen, gs, scorer, genome, screen):
    """Phase 5: returns (max_abs_err over all cases, {G: kernel ms},
    plain ms at G=4)."""
    rng = np.random.default_rng(12)

    def protos(G, Q):
        out = [GUIDE[:20]] if Q == 20 else []
        return out + ["".join("ACGT"[i] for i in rng.integers(0, 4, Q))
                      for _ in range(G - len(out))]

    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)

    def compare(what, genome, qvals, mss, kw):
        got = dp_cuda.screen_multi(genome, qvals, mss, **kw)
        want = dp_screen.screen_multi_reference(genome, qvals, mss, **kw)
        torch.cuda.synchronize()
        pairs = [(got[0], want[0])] + ([(got[1], want[1])] if kw["emit_ranges"] else [])
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in pairs)
        same = all(torch.equal(g, w) for g, w in pairs)
        flagged = int((got[0] >= torch.as_tensor(mss, device=got[0].device)
                       .reshape(-1, 1, 1)).any(1).sum())
        log(f"[multi] {what} windows={kw['n_windows']} flagged={flagged} "
            f"bit-identical={same} max_abs_err={err}")
        if not same:
            raise AssertionError(f"multi kernel != plain: {what}")
        return err

    max_err = 0
    grid_cases = [  # (G, Q, window, gate, max windows compared)
        (1, 20, 1000, True, None), (4, 20, 1000, True, None),
        (17, 20, 1003, False, None), (4, 24, 40, True, 200_000),
        (17, 24, 1003, True, None), (4, 48, 1003, False, None),
        (17, 48, 64, True, 200_000), (1, 48, 1000, False, None),
    ]
    for G, Q, window, gate, cap in grid_cases:
        step = window - (Q + 3 + 5 + 3 - 1)
        n = len(screen.window_starts(CONTIG, step))
        if cap is not None:
            n = min(n, cap)
        mss = np.array([60 * Q - (3 + g % 4) * 122 for g in range(G)], np.int32)
        kw = dict(base0=0, step=step, n_windows=n, window=window,
                  pam_gate=gate, emit_ranges=True, **sk)
        max_err = max(max_err, compare(
            f"grid G={G} Q={Q} window={window} gate={gate}",
            genome, guide_qvals(np, protos(G, Q)), mss, kw))

    masks = genome & 15
    for G, T in ((4, 64), (17, 128), (1, 512)):
        B = 8192
        starts = torch.as_tensor(rng.integers(0, CONTIG - T, B), device=genome.device)
        lens = torch.as_tensor(rng.integers(T // 2, T + 1, B), device=genome.device)
        cols = torch.arange(T, device=genome.device)
        slots = masks[starts[:, None] + cols] * (cols < lens[:, None])
        Q = 20
        qvals = guide_qvals(np, protos(G, Q))
        mss = np.array([60 * Q - (3 + g % 4) * 122 for g in range(G)], np.int32)
        kw = dict(base0=0, step=T, n_windows=B, window=T, pam_gate=False,
                  emit_ranges=False, **sk)
        max_err = max(max_err, compare(
            f"slots G={G} B={B} T={T}", slots.reshape(-1).contiguous(), qvals, mss, kw))
        flags = gs._slot_flags_multi(scorer, slots, qvals, mss)
        if not torch.equal(flags.cpu(), gs._slot_flags_multi(scorer, slots.cpu(), qvals, mss)):
            raise AssertionError(f"slot flags differ from the plain version at T={T}")

    step = DEFAULT_STEP
    n = screen.segment_spans(len(screen.window_starts(CONTIG, step)))[0][1]
    kernel_ms = {}
    for G in (4, 8, 16):
        qvals = guide_qvals(np, protos(G, 20))
        mss = np.full(G, 60 * 20 - 5 * 122, np.int32)
        kw = dict(base0=0, step=step, n_windows=n, window=1000, pam_gate=True,
                  emit_ranges=True, **sk)
        kernel_ms[G] = cuda_time_ms(
            torch, lambda: dp_cuda.screen_multi(genome, qvals, mss, **kw), 20)
        if G == 4:
            plain_ms = cuda_time_ms(
                torch, lambda: dp_screen.screen_multi_reference(genome, qvals, mss, **kw), 2)
    log(f"[multi] main-path shape (window 1000, Q 20, gate on, ranges on, one "
        f"segment of {n} windows of the 40 Mb contig): kernel "
        + ", ".join(f"G={G} {ms:.4f} ms" for G, ms in kernel_ms.items())
        + f"; plain G=4 {plain_ms:.4f} ms")
    return max_err, kernel_ms, plain_ms


def config5s(torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp: Path) -> int:
    """Phase 6: golden config 5s through the port's CLI with a guide file;
    returns the multi-guide kernel's launches in that run."""
    from calitas_tpu_torch import cli, goldens

    n_bases = 10_000_000
    t0 = time.perf_counter()
    argv = goldens.config5s(tmp)
    ref = argv[argv.index("-r") + 1]
    guides = goldens.config5s_guides()
    log(f"[config5s] reference built in {time.perf_counter() - t0:.3f} s; guides "
        + " ".join(g for _i, g in guides))
    out = tmp / "config5s.txt"
    dp_cuda.reset_launches()
    dp_screen.reference_calls["cuda"] = 0
    e2e = run_cli(torch, cli, [*argv, "-o", str(out), "--engine", "gpu"])
    launches = dict(dp_cuda.launches)
    plain_on_card = dp_screen.reference_calls["cuda"]
    got = norm_rows(out.read_text())
    assert_same_table(got, golden_rows("5s"), "config5s table differs from golden")
    screen = gs.GenomeScreen(scorer, device, window=1000)
    n = len(screen.window_starts(n_bases, DEFAULT_STEP))
    n_segments = len(screen.segment_spans(n))
    log(f"[config5s] table == golden ({len(got) - 1} rows); multi-guide kernel "
        f"launches {launches['screen_multi']} (segments {n_segments}); dual kernel "
        f"launches {launches['screen_dual']}; plain versions on the card {plain_on_card}; "
        f"end to end {e2e:.3f} s, {len(guides) * n_bases / e2e:.6g} guide-bases/s")
    if launches["screen_multi"] < n_segments:
        raise AssertionError(f"multi kernel launched {launches['screen_multi']} times, "
                             f"< {n_segments} segments")
    if launches["screen_dual"] != 0 or plain_on_card != 0:
        raise AssertionError("config5s took the dual kernel or the plain version")

    # The fused screen against four dual launches at this shape.
    from calitas_tpu_torch.io.fasta import IndexedFasta

    genome = gs.annotate_genome_pam(
        screen.stage(IndexedFasta(ref).get_bases("chr21")),
        gs.encode_pam_spec((("nrg",), 1, 3)),
    )
    protos = [g[:-3] for _i, g in guides]
    qvals = guide_qvals(np, protos)
    ms = 60 * 20 - 5 * 122
    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    grid = dict(base0=0, step=DEFAULT_STEP, n_windows=n, window=1000, pam_gate=True, **sk)
    fused_ms = cuda_time_ms(torch, lambda: dp_cuda.screen_multi(
        genome, qvals, np.full(4, ms, np.int32), emit_ranges=True, **grid), 20)
    dual_ms = cuda_time_ms(torch, lambda: [
        dp_cuda.screen_dual(genome, qvals[g], min_score=ms, **grid) for g in range(4)
    ], 20)
    log(f"[config5s] screen kernels at this shape ({n} windows): fused G=4 "
        f"{fused_ms:.4f} ms, four dual launches {dual_ms:.4f} ms")
    return launches["screen_multi"]


def config4(torch, dp_cuda, dp_screen, tmp: Path) -> int:
    """Phase 7: golden config 4 (5 Mb + 2,000 PrepareVcf'd SNVs) through
    the port's CLI with -v; returns the multi-guide kernel's launches."""
    from calitas_tpu_torch import cli, goldens

    t0 = time.perf_counter()
    argv = goldens.config4(tmp)
    log(f"[config4] reference and VCF built in {time.perf_counter() - t0:.3f} s")
    out = tmp / "config4.txt"
    dp_cuda.reset_launches()
    dp_screen.reference_calls["cuda"] = 0
    e2e = run_cli(torch, cli, [*argv, "-o", str(out), "--engine", "gpu"])
    launches = dict(dp_cuda.launches)
    plain_on_card = dp_screen.reference_calls["cuda"]
    got = norm_rows(out.read_text())
    assert_same_table(got, golden_rows("4"), "config4 table differs from golden")
    log(f"[config4] table == golden ({len(got) - 1} rows); slot-mode multi-guide kernel "
        f"launches {launches['screen_multi']}; dual kernel launches "
        f"{launches['screen_dual']}; plain versions on the card {plain_on_card}; "
        f"end to end {e2e:.3f} s")
    if launches["screen_multi"] < 1 or launches["screen_dual"] < 1:
        raise AssertionError(f"config4 kernel launches {launches}: each kernel must run")
    if plain_on_card != 0:
        raise AssertionError("config4 ran the plain version on the card")
    return launches["screen_multi"]


class PoolWatch(logging.Handler):
    """Warnings of the port's loggers that say the finish pool broke, and
    the finish pool's size at the end of a phase."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.broken = []

    def emit(self, record):
        msg = record.getMessage()
        if "Worker pool broken" in msg:
            self.broken.append(f"{record.name}: {msg}")

    def __enter__(self):
        logging.getLogger("calitas_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("calitas_tpu_torch").removeHandler(self)

    def check(self, what: str) -> int:
        """Raises if the pool broke; returns the pool's worker count (0 =
        every finish ran in-process: no stream was long enough to fan
        out)."""
        from calitas_tpu_torch.parallel import host_pool

        if self.broken:
            raise AssertionError(f"{what}: the finish pool broke: {self.broken[:2]}")
        return host_pool._SHARED_POOL_SIZE if host_pool._SHARED_POOL is not None else 0


class PassClock(logging.Handler):
    """perf_counter readings of the SearchReference log lines that close
    each pass."""

    MARKS = ("Aligning to reference genome without variants.",
             "Reference windows processed.", "Variant windows processed.")

    def __init__(self):
        super().__init__(logging.INFO)
        self.at = {}

    def emit(self, record):
        msg = record.getMessage()
        if msg in self.MARKS:
            self.at[msg] = time.perf_counter()

    def passes(self):
        a, r, v = (self.at[m] for m in self.MARKS)
        return r - a, v - r


def variants_at_scale(torch, np, dp_cuda, tmp: Path) -> None:
    """Phase 8: 40 Mb + 160,000 SNVs, on the card and through the plain
    versions on the CPU; the two tables must be identical and the finish
    pool must not break."""
    from calitas_tpu_torch import cli, goldens
    from calitas_tpu_torch.io.fasta import IndexedFasta
    from calitas_tpu_torch.io.vcf import VcfIndex
    from calitas_tpu_torch.search.variants import _WindowBlock, variant_window_iterator

    ref = goldens.build_ref(tmp, CONTIG, 3, "c3chr21")
    bases = IndexedFasta(ref).get_bases("chr21")
    rng = np.random.default_rng(160_000)
    n_snv = CONTIG // 250  # one per 250 bases: 160,000 on the 40 Mb contig
    pos = np.arange(n_snv, dtype=np.int64) * 250 + rng.integers(1, 251, n_snv)
    vcf = tmp / "snv160k.vcf"
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=AF,Number=A,Type=Float,Description="AF">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        alt_k = rng.integers(1, 4, n_snv)
        afs = rng.uniform(0.01, 0.5, n_snv)
        for p, k, af in zip(pos.tolist(), alt_k.tolist(), afs.tolist()):
            ref_b = chr(bases[p - 1])
            alt = "ACGT"[("ACGT".index(ref_b) + k) % 4]
            fh.write(f"chr21\t{p}\t.\t{ref_b}\t{alt}\t50\tPASS\tAF={af:.3f}\n")
    padding = len(GUIDE) - 1 + 5 + 3
    n_windows = sum(
        b.n if isinstance(b, _WindowBlock) else 1 for b in variant_window_iterator(
            IndexedFasta(ref), VcfIndex(vcf), None, padding, 16, blocks=True)
    )
    argv = ["SearchReference", "-i", GUIDE, "-I", "bench", "-r", str(ref), "-v",
            str(vcf), "-d", "5", "-p", "1", "--engine", "gpu"]
    clock = PassClock()
    logging.getLogger("calitas_tpu_torch.SearchReference").addHandler(clock)
    try:
        with PoolWatch() as pool:
            dp_cuda.reset_launches()
            e2e = run_cli(torch, cli, [*argv, "-o", str(tmp / "v_cuda.txt")])
            launches = dict(dp_cuda.launches)
            ref_s, var_s = clock.passes()
            # Again, warm: the finish pool's workers are up.
            e2e_warm = run_cli(torch, cli, [*argv, "-o", str(tmp / "v_cuda2.txt")])
            ref_warm, var_warm = clock.passes()
            t0 = time.perf_counter()
            run_cli(torch, cli, [*argv, "-o", str(tmp / "v_cpu.txt"), "--device", "cpu"])
            cpu_s = time.perf_counter() - t0
    finally:
        logging.getLogger("calitas_tpu_torch.SearchReference").removeHandler(clock)
    workers = pool.check("variant run")
    got = norm_rows((tmp / "v_cuda.txt").read_text())
    for other in ("v_cpu.txt", "v_cuda2.txt"):
        assert_same_table(got, norm_rows((tmp / other).read_text()),
                          f"variant run: v_cuda.txt and {other} differ")
    n_var_rows = sum(1 for r in got[1:] if r[got[0].index("variant_vcf")])
    log(f"[variants] {CONTIG} bases + {n_snv} SNVs: tables identical on the card and "
        f"--device cpu ({len(got) - 1} rows, {n_var_rows} with variants); "
        f"{n_windows} variant windows; card run {e2e:.3f} s end to end, reference "
        f"pass {ref_s:.3f} s, variant pass after it {var_s:.3f} s; again, warm, "
        f"{e2e_warm:.3f} s, {ref_warm:.3f} s and {var_warm:.3f} s; kernel launches "
        f"{launches}; --device cpu run {cpu_s:.3f} s; finish pool {workers} workers, "
        "never broken")
    if launches["screen_multi"] < 1:
        raise AssertionError("the variant pass never launched the multi-guide kernel")


def rows_vs_plain(torch, np, dp_cuda, dp_screen, scorer, device):
    """Phase 9: returns (max_abs_err over all cases, {mode: (kernel ms,
    plain ms)}, {mode: row lengths of the timed call})."""
    rng = np.random.default_rng(9)
    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    acgt = np.array([1, 2, 4, 8], np.uint8)
    rc_mask = np.array([0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15], np.uint8)

    def targets(B, T, query_of):
        """[B, T] ACGT masks with a copy of row b's query ``query_of(b)``
        planted in every 50th row, mutated 0-4 times."""
        tm = acgt[rng.integers(0, 4, (B, T))]
        for b in range(0, B, 50):
            q = query_of(b).copy()
            if len(q) > T:
                continue
            q[rng.integers(0, len(q), int(rng.integers(0, 5)))] = acgt[rng.integers(0, 4)]
            p = int(rng.integers(0, T - len(q) + 1))
            tm[b, p : p + len(q)] = q
        return torch.from_numpy(tm).to(device)

    def compare(what, qmasks, tm, ln, ms):
        got = dp_cuda.screen_rows(qmasks, tm, ln, ms, **sk)
        want = dp_screen.screen_rows_reference(qmasks, tm, ln, ms, **sk)
        torch.cuda.synchronize()
        pairs = [(got[0], want[0])] + ([(got[1], want[1])] if ms is not None else [])
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in pairs)
        same = all(torch.equal(g, w) for g, w in pairs) and (ms is not None or got[1] is None)
        top = int(got[0].max())
        log(f"[rows] {what} bit-identical={same} max_abs_err={err} best max {top}")
        if not same:
            raise AssertionError(f"row kernel != plain: {what}")
        return err

    max_err = 0
    main_shared = main_rows = None
    for B, T, ragged in ((8192, 64, False), (8192, 128, True), (8192, 512, False),
                         (41_238, 1000, True)):
        for Q in (1, 20, 24, 48):
            q = acgt[rng.integers(0, 4, Q)]
            tm = targets(B, T, lambda b: q)
            lens = rng.integers(0, T + 1, B) if ragged else np.full(B, T)
            ln = torch.from_numpy(lens.astype(np.int32)).to(device)
            ms = None
            if Q in (20, 48):
                ms = torch.full((B,), scorer.match_score * Q - 4 * 122,
                                dtype=torch.int32, device=device)
            max_err = max(max_err, compare(
                f"shared B={B} T={T} Q={Q} ragged={ragged} ranges={ms is not None}",
                q[None], tm, ln, ms))
            if (B, T, Q) == (41_238, 1000, 20):
                main_shared = (q[None], tm, ln)
    for T in (64, 128, 256):
        for k, Q in enumerate((1, 20, 24, 48)):
            B = 20_000
            qa = acgt[rng.integers(0, 4, (B, Q))]
            qmasks = np.stack([qa, rc_mask[qa[:, ::-1]]])  # chain B: the revcomp
            tm = targets(B, T, lambda b: qa[b])
            ln = torch.from_numpy(rng.integers(0, T + 1, B).astype(np.int32)).to(device)
            ms = None
            if (T + k) % 2 == 0:
                ms = torch.from_numpy(
                    (scorer.match_score * Q - rng.integers(0, 6, B) * 122).astype(np.int32)
                ).to(device)
            qd = torch.from_numpy(np.ascontiguousarray(qmasks)).to(device)
            max_err = max(max_err, compare(
                f"per-row B={B} slot={T} Q={Q} ranges={ms is not None}", qd, tm, ln, ms))
            if (T, Q) == (256, 20):
                ms = torch.full((B,), scorer.match_score * Q - 4 * 122,
                                dtype=torch.int32, device=device)
                main_rows = (qd, tm, ln, ms)
    q, tm, ln = main_shared
    times = {"shared": (
        cuda_time_ms(torch, lambda: dp_cuda.screen_rows(q, tm, ln, **sk), 20),
        cuda_time_ms(torch, lambda: dp_screen.screen_rows_reference(q, tm, ln, **sk), 3),
    )}
    qd, tm, ln, ms = main_rows
    times["per-row"] = (
        cuda_time_ms(torch, lambda: dp_cuda.screen_rows(qd, tm, ln, ms, **sk), 20),
        cuda_time_ms(torch, lambda: dp_screen.screen_rows_reference(qd, tm, ln, ms, **sk), 3),
    )
    log(f"[rows] shared query, B 41238 x T 1000, Q 20, ragged: kernel "
        f"{times['shared'][0]:.4f} ms, plain {times['shared'][1]:.4f} ms; per-row "
        f"query, both chains, B 20000 x slot 256, Q 20, ranges on: kernel "
        f"{times['per-row'][0]:.4f} ms, plain {times['per-row'][1]:.4f} ms")
    return max_err, times, {"shared": main_shared[2].cpu().numpy(),
                            "per-row": main_rows[2].cpu().numpy()}


def pair_screen_run(torch, cli, dp_cuda, dp_screen, argv: list):
    """One list-tool run through the CLI with the counts set to 0 just
    before it; returns (wall seconds, row-kernel launches, plain calls on
    the card)."""
    dp_cuda.reset_launches()
    dp_screen.reference_calls["cuda"] = 0
    wall = run_cli(torch, cli, argv)
    return wall, dp_cuda.launches["screen_rows"], dp_screen.reference_calls["cuda"]


def check_kernel_route(what: str, launches: int, plain: int) -> None:
    """Every pair-screen chunk makes exactly one screen call, the kernel
    or its plain version: with no plain call on the card, every chunk
    launched the kernel."""
    log(f"[{what}] row-kernel launches {launches}, plain calls on the card {plain}")
    if launches < 1 or plain != 0:
        raise AssertionError(f"{what}: {launches} row-kernel launches, {plain} plain "
                             "calls on the card")


def goldens_1_2(torch, dp_cuda, dp_screen, tmp: Path) -> int:
    """Phase 10: golden configs 1 and 2 through the port's CLI with
    ``--engine gpu`` and ``--engine host``; returns the row kernel's
    launches in the gpu runs."""
    from calitas_tpu_torch import cli, goldens

    launches = 0
    for config in ("1", "2"):
        name = f"config{config}"
        argv = goldens.CONFIGS[config](tmp)
        wall, n, plain = pair_screen_run(
            torch, cli, dp_cuda, dp_screen,
            [*argv, "-o", tmp / f"{name}_gpu.txt", "--engine", "gpu"])
        host_wall = run_cli(torch, cli, [*argv, "-o", tmp / f"{name}_host.txt",
                                         "--engine", "host"])
        for engine in ("gpu", "host"):
            got = norm_rows((tmp / f"{name}_{engine}.txt").read_text())
            assert_same_table(got, golden_rows(config),
                              f"{name} --engine {engine} table differs from golden")
        log(f"[{name}] table == golden on --engine gpu and --engine host "
            f"({len(got) - 1} rows); end to end gpu {wall:.3f} s, host {host_wall:.3f} s")
        check_kernel_route(name, n, plain)
        launches += n
    return launches


G5 = "tttv" + "GATCCGTAGCTAGGCATTACGGTA"  # a 24-base protospacer after a 5' PAM


def planted_sites(np, n: int, seed: int, plant: int = 40) -> list:
    """Positions of the sites goldens.synth_genome plants, found by
    replaying its random draws without building the genome."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 4, n)  # the genome's bases
    proto = GUIDE[:-3]
    out = []
    for _ in range(plant):
        out.append(int(rng.integers(100, n - 100)))
        site = list(proto)
        for _ in range(int(rng.integers(0, 5))):
            i = int(rng.integers(0, len(site)))
            site[i] = rng.choice([c for c in "ACGT" if c != site[i]])
        rng.choice(["TGG", "AAG", "CGG"])
        rng.random()
    return out


def list_tool_inputs(np, tmp: Path) -> dict:
    """Phase 11's inputs: ``{name: CLI argv without -o and --engine}`` for
    20,000 pairs and 20,000 A2R loci on config 3's contig."""
    from calitas_tpu_torch import goldens
    from calitas_tpu_torch.core.sequence import revcomp
    from calitas_tpu_torch.io.fasta import IndexedFasta

    rng = np.random.default_rng(11)
    protos = {GUIDE: GUIDE[:-3], G5: G5[4:]}

    def site(guide):
        s = list(protos[guide])
        for _ in range(int(rng.integers(0, 5))):
            s[int(rng.integers(0, len(s)))] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        s = s + "TGG" if guide == GUIDE else "TTTA" + s
        return revcomp(s) if rng.random() < 0.5 else s

    pairs = tmp / "pairs20k.txt"
    with open(pairs, "w") as fh:
        for k in range(20_000):
            guide = (GUIDE, G5)[k % 2]
            t = "".join("ACGT"[i] for i in rng.integers(0, 4, int(rng.integers(100, 201))))
            if k % 4 < 2:  # half the pairs carry a site
                s = site(guide)
                p = int(rng.integers(0, len(t) - len(s)))
                t = t[:p] + s + t[p + len(s):]
            fh.write(f"{guide}\t{t}\n")
    ref = goldens.build_ref(tmp, CONTIG, 3, "c3chr21")
    sites = planted_sites(np, CONTIG, 3)
    bases = IndexedFasta(ref).get_bases("chr21")
    hits = sum(
        sum(a == b for a, b in zip(bytes(bases[p : p + 20]).decode(), GUIDE[:20])) >= 15
        or sum(a == b for a, b in zip(bytes(bases[p + 3 : p + 23]).decode(),
                                      revcomp(GUIDE[:20]))) >= 15
        for p in sites
    )
    if hits < 30:
        raise AssertionError(f"only {hits} of 40 replayed site positions hold a site")
    loci = tmp / "loci20k.tsv"
    with open(loci, "w") as fh:
        fh.write("id\tquery\tchrom\tposition\n")
        for k in range(20_000):
            if k % 10 == 0:
                pos = sites[(k // 10) % len(sites)] + int(rng.integers(-50, 51))
            else:
                pos = int(rng.integers(1_000, CONTIG - 1_000))
            fh.write(f"l{k}\t{(GUIDE, G5)[k % 2]}\tchr21\t{pos}\n")
    log(f"[list tools] 20,000 pairs and 20,000 loci written; {hits} of 40 planted "
        "site positions replayed and checked")
    return {
        "pairs": ["PairwiseAlignSequences", "-i", pairs],
        "a2r": ["AlignToReference", "-i", loci, "-r", ref, "-w", "200", "-d", "4",
                "-p", "1", "-O", "5"],
    }


def list_tools_at_scale(torch, np, dp_cuda, dp_screen, tmp: Path) -> int:
    """Phase 11: 20,000 pairs and 20,000 A2R loci, gpu engine against
    host engine; returns the row kernel's launches in the gpu runs."""
    from calitas_tpu_torch import cli

    runs = list_tool_inputs(np, tmp)
    launches = 0
    for name, argv in runs.items():
        with PoolWatch() as pool:
            wall, n, plain = pair_screen_run(
                torch, cli, dp_cuda, dp_screen,
                [*argv, "-o", tmp / f"{name}_gpu.txt", "--engine", "gpu"])
            # Then host, host, gpu: each engine once before and once after
            # the other.
            walls = {"gpu": [wall], "host": []}
            for k, engine in enumerate(("host", "host", "gpu")):
                walls[engine].append(run_cli(
                    torch, cli, [*argv, "-o", tmp / f"{name}_{engine}{k}.txt",
                                 "--engine", engine]))
        workers = pool.check(name)
        got = norm_rows((tmp / f"{name}_gpu.txt").read_text())
        for k, engine in enumerate(("host", "host", "gpu")):
            assert_same_table(got, norm_rows((tmp / f"{name}_{engine}{k}.txt").read_text()),
                              f"{name}: gpu and {engine} tables differ")
        log(f"[{name}] 20,000 rows: tables identical on --engine gpu and --engine host "
            f"({len(got) - 1} rows); end to end, in run order gpu, host, host, gpu: gpu "
            + ", ".join(f"{w:.3f}" for w in walls["gpu"]) + " s, host "
            + ", ".join(f"{w:.3f}" for w in walls["host"])
            + f" s; finish pool {workers} workers, never broken")
        check_kernel_route(name, n, plain)
        launches += n
    return launches


def long_guide(torch, dp_cuda, dp_screen, tmp: Path) -> None:
    """Phase 12: a 50-base DP query through SearchReference on config 2's
    2 Mb contig, on the card and with --device cpu."""
    from calitas_tpu_torch import cli, goldens
    from calitas_tpu_torch.io.fasta import IndexedFasta

    ref = goldens.build_ref(tmp, 2_000_000, 2, "c2ref")
    bases = bytes(IndexedFasta(ref).get_bases("chr21"))
    p = next(p for p in range(500_000, len(bases))
             if bases[p + 51] in b"AG" and bases[p + 52] == ord("G"))
    guide = bases[p : p + 50].decode() + "nrg"
    argv = ["SearchReference", "-i", guide, "-I", "g50", "-r", ref, "--engine", "gpu"]
    routes = []

    class Routes(logging.Handler):
        def emit(self, record):
            routes.append(record.getMessage())

    handler = Routes(logging.INFO)
    logging.getLogger("calitas_tpu_torch.screen").addHandler(handler)
    try:
        dp_cuda.reset_launches()
        dp_screen.reference_calls["cuda"] = 0
        wall = run_cli(torch, cli, [*argv, "-o", tmp / "g50_cuda.txt"])
        launches = dict(dp_cuda.launches)
        plain = dp_screen.reference_calls["cuda"]
    finally:
        logging.getLogger("calitas_tpu_torch.screen").removeHandler(handler)
    cpu_wall = run_cli(torch, cli, [*argv, "-o", tmp / "g50_cpu.txt", "--device", "cpu"])
    got = norm_rows((tmp / "g50_cuda.txt").read_text())
    assert_same_table(got, norm_rows((tmp / "g50_cpu.txt").read_text()),
                      "50-base guide: card and --device cpu tables differ")
    log(f"[long guide] {guide} ({len(guide) - 3}-base DP query): tables identical on the "
        f"card and --device cpu ({len(got) - 1} rows); route: {routes}; plain calls on "
        f"the card {plain}; kernel launches {launches}; card {wall:.3f} s, cpu "
        f"{cpu_wall:.3f} s")
    if len(got) < 2:
        raise AssertionError("the 50-base guide found no hit, not even its own site")
    if not any("50-base query" in r and "plain" in r for r in routes):
        raise AssertionError("the plain route of the 50-base guide was not logged")
    if plain == 0 or any(launches.values()):
        raise AssertionError("the 50-base guide did not run on the plain route alone")


def probes_vs_plain(torch, np, dp_cuda, probes, device):
    """Phase 13, first half: each probe against its plain version, bit
    for bit, at a small shape and at screen_ab.py's (T 1024, N 32,768,
    Q 20), with screen_ab.py's column values (masks 1-15 with both PAM
    bits set); returns (max_abs_err, {name: (kernel ms, plain ms)}) at
    screen_ab.py's shape."""
    rng = np.random.default_rng(13)
    max_err = 0
    times = {}
    for T, N, Q, bias in ((16, 2048, 5, -3), (1024, 32_768, 20, 0)):
        tcols = torch.from_numpy(
            rng.integers(1, 16, (T, N)).astype(np.int32) | (3 << 4)).to(device)
        for name in ("ceiling_probe", "peak_probe"):
            kernel = getattr(probes, name)
            plain = getattr(probes, name + "_reference")
            got = kernel(tcols, Q, bias)
            want = plain(tcols, Q, bias)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            same = torch.equal(got, want)
            log(f"[probes] {name} T={T} N={N} Q={Q} bias={bias} bit-identical={same} "
                f"max_abs_err={err}")
            if not same:
                raise AssertionError(f"{name} != plain at T={T} N={N} Q={Q}")
            max_err = max(max_err, err)
            if N == 32_768:
                times[name] = (
                    cuda_time_ms(torch, lambda: kernel(tcols, Q, bias), 20),
                    cuda_time_ms(torch, lambda: plain(tcols, Q, bias), 1),
                )
    log("[probes] T 1024, N 32768, Q 20: " + "; ".join(
        f"{n} kernel {k:.4f} ms, plain {p:.4f} ms" for n, (k, p) in times.items()))
    return max_err, times


def probe_sass(dp_cuda, Q: int = 20) -> dict:
    """Phase 13: max instructions (VIMNMX, VIADDMNMX) and IMADs in the
    SASS of the Q 20 probes (cuobjdump).  Raises when a probe holds fewer
    maxes than its pairs per column (ceiling Q, peak 8 Q): the compiler
    would have folded the work the probe is meant to time."""
    import re
    import shutil
    from collections import Counter

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(dp_cuda.build_all(["probes"])["probes"])],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0]
        for kind, pairs in (("ceiling_kernel", Q), ("peak_kernel", 8 * Q)):
            if f"{kind}ILi{Q}E" in name:
                c = Counter(re.findall(r"\b(VIMNMX|VIADDMNMX|IMAD)\b", body))
                counts[kind] = dict(c)
                if c["VIMNMX"] + c["VIADDMNMX"] < pairs:
                    raise AssertionError(f"{kind}<{Q}> SASS holds {dict(c)}: fewer maxes "
                                         f"than its {pairs} add+max pairs per column")
    if len(counts) != 2:
        raise AssertionError(f"probe SASS not found: {sorted(counts)}")
    log(f"[probes] SASS at Q {Q} (whole kernel; the column loop may be unrolled): {counts}")
    return counts


def roofline_run(dp_cuda, probes, device):
    """Phase 13, second half: the probes' own path, ``roofline``, with the
    launch counts set to 0 just before it; returns (its result, the
    probes' launches in it)."""
    dp_cuda.reset_launches()
    roof = probes.roofline(device)
    launches = {n: dp_cuda.launches[n] for n in ("ceiling_probe", "peak_probe")}
    log(f"[roofline] int32 peak {roof['peak_int32_ops_per_s']:.6g} op/s "
        f"({roof['sms']} SMs x {probes.INT32_LANES_PER_SM} lanes x "
        f"{roof['max_sm_clock_mhz']:g} MHz); peak probe measured "
        f"{roof['peak_probe_ops_per_s']:.6g} op/s; bounds at "
        f"{roof['bound_ops_per_s']:.6g} op/s; probe launches {launches}")
    for what, rows in (("probe", roof["probes"]), ("kernel", roof["kernels"])):
        for name, r in rows.items():
            log(f"[roofline] {what} {name}: {r['ms']:.4f} ms, {r['ops_per_s']:.6g} op/s, "
                f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, share of bound "
                f"{100 * r['share_of_bound']:.2f} %")
    if not all(launches.values()):
        raise AssertionError(f"roofline did not launch every probe: {launches}")
    return roof, launches


def own_processes() -> list:
    """(pid, state, command line) of every process descended from this
    one, read from /proc."""
    parent, info = {}, {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            fields = (d / "stat").read_text().rsplit(")", 1)[1].split()
            cmd = (d / "cmdline").read_bytes().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, IndexError):
            continue  # ended while being read
        parent[int(d.name)] = int(fields[1])
        info[int(d.name)] = (fields[0], cmd.strip())
    mine, level = [], {os.getpid()}
    while level:
        level = {pid for pid, ppid in parent.items() if ppid in level}
        mine += sorted(level)
    return [(pid, *info[pid]) for pid in mine]


def stop_processes(host_pool) -> None:
    """Stops every process the run started and waits for each to end: the
    finish pool's workers, then the resource tracker that the pool's
    spawn context started (it would otherwise outlive this process while
    it cleans up).  Any other descendant is logged, sent SIGTERM, then
    SIGKILL; raises if one is still there."""
    import gc
    import multiprocessing
    import signal
    from multiprocessing import resource_tracker

    if host_pool._SHARED_POOL is not None:
        host_pool._SHARED_POOL.shutdown(wait=True)
        host_pool._SHARED_POOL = None
    for proc in multiprocessing.active_children():
        proc.join(30)
    gc.collect()  # the pool's semaphores unregister while the tracker runs
    log(f"[processes] after the finish pool's shutdown: {own_processes()}")
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        left = own_processes()
        if not left:
            break
        for pid, _state, _cmd in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + 10
        while left and time.monotonic() < deadline:
            for pid, _state, _cmd in left:
                try:
                    os.waitpid(pid, os.WNOHANG)  # reaps a child of this process
                except ChildProcessError:
                    pass  # not a child of this one: its own parent reaps it
            time.sleep(0.05)
            left = own_processes()
    still = own_processes()
    log(f"[processes] after stopping the resource tracker and any other "
        f"descendant: {still}")
    if still:
        raise RuntimeError(f"processes of this run outlived it: {still}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA device "
              "is required", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from calitas_tpu_torch import native
    from calitas_tpu_torch.core.scoring import derive_scorer
    from calitas_tpu_torch.device import resolve_device
    from calitas_tpu_torch.ops import dp_cuda, dp_screen, probes
    from calitas_tpu_torch.ops import genome_screen as gs
    from calitas_tpu_torch.parallel import host_pool

    # 1. Device
    device = resolve_device("cuda")
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(device)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"native finish library loaded: {native.available()}")

    # 2. Build: one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    for name in dp_cuda.SOURCES:
        dp_cuda.library(name)
    log(f"[build] {', '.join(str(p.relative_to(ROOT)) for p in dp_cuda.SOURCES.values())} "
        f"built and loaded in {time.perf_counter() - t0:.3f} s")
    for name, lib in dp_cuda.build_all(tuple(dp_cuda.SOURCES)).items():
        log(f"[build] ptxas, {name}: {ptxas_summary(lib.with_name(lib.name + '.log'))}")

    phase_s = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)

            # 3. Kernel vs plain, on the card
            t0 = time.perf_counter()
            scorer = derive_scorer()
            max_err, kernel_ms, plain_ms, genome, dual_n = kernel_vs_plain(
                torch, np, dp_cuda, dp_screen, gs, scorer, device
            )
            phase_s["3 dual vs plain"] = time.perf_counter() - t0

            # 4. Main path at chr21 scale
            t0 = time.perf_counter()
            dual_launches = main_path(torch, dp_cuda, dp_screen, gs, scorer, device, tmp)
            phase_s["4 config3"] = time.perf_counter() - t0

            # 5. Multi-guide kernel vs plain, on the card
            t0 = time.perf_counter()
            screen = gs.GenomeScreen(scorer, device, window=1000)
            multi_err, multi_ms, multi_plain_ms = multi_vs_plain(
                torch, np, dp_cuda, dp_screen, gs, scorer, genome, screen
            )
            del genome
            phase_s["5 multi vs plain"] = time.perf_counter() - t0

            # 6-8. The multi-guide kernel's paths
            t0 = time.perf_counter()
            multi_launches = config5s(torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp)
            phase_s["6 config5s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            multi_launches += config4(torch, dp_cuda, dp_screen, tmp)
            phase_s["7 config4"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            variants_at_scale(torch, np, dp_cuda, tmp)
            phase_s["8 variants at scale"] = time.perf_counter() - t0

            # 9-12. The row kernel and its paths, and the long-guide route
            t0 = time.perf_counter()
            rows_err, rows_ms, rows_lens = rows_vs_plain(
                torch, np, dp_cuda, dp_screen, scorer, device)
            phase_s["9 rows vs plain"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rows_launches = goldens_1_2(torch, dp_cuda, dp_screen, tmp)
            phase_s["10 configs 1-2"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rows_launches += list_tools_at_scale(torch, np, dp_cuda, dp_screen, tmp)
            phase_s["11 list tools at scale"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            long_guide(torch, dp_cuda, dp_screen, tmp)
            phase_s["12 long guide"] = time.perf_counter() - t0

            # 13. The roofline probes and every kernel's bound
            t0 = time.perf_counter()
            probe_sass(dp_cuda)
            probe_err, probe_ms = probes_vs_plain(torch, np, dp_cuda, probes, device)
            roof, probe_launches = roofline_run(dp_cuda, probes, device)
            phase_s["13 probes and roofline"] = time.perf_counter() - t0
    finally:
        stop_processes(host_pool)

    # Each timed call's bound, from its own inputs.
    peak = roof["bound_ops_per_s"]
    T, N, Q = 1024, 32_768, 20
    work = {
        "screen_dual": probes.grid_work(CONTIG, 0, DEFAULT_STEP, dual_n, 1000, 20),
        "screen_multi": probes.grid_work(CONTIG, 0, DEFAULT_STEP, dual_n, 1000, 20,
                                         guides=4),
        # the list tools' mode: a query per row, both chains, ranges on
        "screen_rows": probes.rows_work(rows_lens["per-row"], 20, 2, True, True),
        "ceiling_probe": probes.probe_work("ceiling_probe", T, N, Q),
        "peak_probe": probes.probe_work("peak_probe", T, N, Q),
    }
    timed = {
        "screen_dual": (kernel_ms, plain_ms),
        "screen_multi": (multi_ms[4], multi_plain_ms),
        "screen_rows": rows_ms["per-row"],
        **probe_ms,
    }
    bounds = {name: probes.bound_ms(ops, nbytes, peak) for name, (ops, nbytes) in work.items()}
    for name, (b_ms, b_by) in bounds.items():
        log(f"[bounds] {name}: {timed[name][0]:.4f} ms against a bound of {b_ms:.4f} ms "
            f"({b_by}): {100 * b_ms / timed[name][0]:.2f} % of the bound")

    log("[phases] " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))
    log(smi)
    rows = [
        ("screen_dual", "screen_dual.cu", "calitas_tpu/ops/dp_pallas2.py:221",
         dual_launches, max_err),
        ("screen_multi", "screen_multi.cu", "calitas_tpu/ops/dp_pallas2.py:431",
         multi_launches, multi_err),
        ("screen_rows", "screen_rows.cu", "calitas_tpu/ops/dp_pallas2.py:42",
         rows_launches, rows_err),
        ("ceiling_probe", "probes.cu", "benchmarks/screen_ab.py:73",
         probe_launches["ceiling_probe"], probe_err),
        ("peak_probe", "probes.cu", "benchmarks/screen_ab.py:97",
         probe_launches["peak_probe"], probe_err),
    ]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"calitas_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": timed[name][0],
        "plain_ms": timed[name][1],
        "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1],
        "library_ms": None,  # no single PyTorch call computes a DP screen or probe
    } for name, source, replaces, launches, err in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
