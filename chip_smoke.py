#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (calitas_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX and nothing of the JAX package ``calitas_tpu``:
the golden configurations' inputs come from ``calitas_tpu_torch.goldens``.
Phases, each raising on failure:

1. Device: a CUDA device is required; prints the card's name and power
   limit and whether the port's native host finish library loaded.
2. Build: compiles the CUDA kernels from ``calitas_tpu_torch/csrc`` (the
   three screens, the roofline probes and the PAM annotation), one nvcc
   per source, started together, and prints the build time; every ``screen_dual`` instantiation
   (Q 1-48 x lanes 1/2, L <= Q), every ``screen_multi`` one (Q 1-48 x
   lanes 1/2/4, L <= Q) and every ``screen_rows`` one (Q 1-48 x the
   lanes ``dp_cuda.rows_lanes`` lists in each mode) must be there and
   none may spill.
3. Kernel vs plain: on a seeded 40 Mb annotated genome with planted guide
   sites, the kernel's best scores and end-column ranges must equal its
   plain PyTorch version bit for bit (query lengths 20/24/48, PAM gate on
   and off, windows 40/64/1000/1003/2500); times both at the main path's
   shape (window 1000, 20-base guide, one segment of the 40 Mb contig).
   Then each lane count L of the dual kernel (``_screen_dual_lanes``)
   against the plain version at Q 1/2/21/23/24/47/48 on grids of 4,099
   windows whose last ones run past the genome's end, each L timed at
   config3's shape and at one 1 Gb segment's (64,512 windows over a 64 Mb
   genome) with its registers and spills, and at both shapes at every Q
   from 2 to 48 (the launcher's L must be the fastest over the two, within
   3 %); the SASS instruction counts of ``screen_dual_kernel<20, L>``.
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
   segment of the main path's shape.  Then each lane count L of the
   kernel (``_screen_multi_lanes``) against the plain version, ranges on
   and off, at Q 1/2/21/23/24/47/48 (G 1/4/17, 4,099 windows whose last ones
   run past the genome's end, min scores at INT32_MIN and INT32_MAX) and
   on slot batches (B 8192 x T 64/128: G 1 at Q 20 and 24, G 4 at Q 23);
   at Q 20, each L's time and the launcher's choice at (a) config5s
   (10,310 windows, G 4), (b)
   config3's grid (G 4), (c) the variant pass's slot batches (B 8192 x T
   64/128, G 1/4) and (d) the launches between and beyond them (config5s's
   grid at G 2/8, a 2 Mb contig's 2,000 windows at G 4, slots of T 64 at
   G 2 and of T 256/512 at G 1/4), each the least of ten means of a
   CUDA graph of about 2 ms (two sets of graphs, five trials each, the
   L's of a shape replayed in turn within each trial), with each L's
   registers and spills; the same at
   every Q from 2 to 48 (the launcher's L must be within 3 % of the
   fastest at every shape); the SASS instruction counts of
   ``screen_multi_kernel<20, L>``.  After phase 13, each shape's bound
   and share.
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
   ranges on and off); then each lane count L (``_screen_rows_lanes``)
   in both modes, ranges on and off, at Q 1/2/20/21/23/24/47/48 on 4,099
   rows whose lengths mix 0, 1, L - 1, T and past T inside a warp, min
   scores at INT32_MIN, INT32_MAX and NEG_INF; at Q 20, each L's time,
   the launcher's choice and the plain version's time at (a) per-row
   20,000 x slot 256, lengths 0..256, ranges on, (b) pairs20k's chunks
   (2,870 x 128, lengths 100-128; 7,130 x 256, lengths 129-200; ranges
   off; also at Q 24), (c) a2r20k's chunks (5,000 rows of 201 bases in
   slot 256, ranges on; also at Q 24), (d) shared query, 41,238 x 1000,
   lengths 0..1000, and (e) per-row chunks at the lane table's row-count
   bounds and other slots (4,000 / 5,500 x 128, 6,000 x 512, 12,000 x
   256 / 1024, 32,768 x 128), timed as phase 5 times its shapes
   (``launcher_times``), with each L's registers and spills; there every
   L's outputs and the wrapper's must equal the plain version's bit for
   bit; the same times at every Q from 2 to 48 (every L's outputs equal;
   the launcher's L must be within 3 % of the fastest at every shape);
   the SASS instruction counts of ``screen_rows_kernel<20, L, true>``.
   After phase 13, each shape's bound and share.
10. Golden configs 1 (PairwiseAlignSequences) and 2 (AlignToReference)
   through the port's CLI with ``--engine gpu`` and ``--engine host``: the
   tables must equal the goldens, the row kernel must have launched and
   no plain version may run on the card (each pair-screen chunk makes one
   screen call, so then every chunk launched the kernel).
11. The list tools at scale: 20,000 hit-dense pairs, and AlignToReference
   all-hits (``-w 200 -d 4 -p 1 -O 5``) at 20,000 loci on config 3's 40 Mb
   contig, each with config 3's guide and a 24-base 5'-PAM guide, on
   ``--engine gpu`` and ``--engine host``: the tables must be identical
   and the finish pool must not break.  Prints both wall times and the
   shape (rows, slot, Q, ranges) of each pair-screen launch of the gpu
   runs, from the pair screen's DEBUG line per chunk.
12. A guide whose DP query is 50 bases (over the kernels' 48) through
   SearchReference on config 2's 2 Mb contig on the card and with
   ``--device cpu``: the tables must be identical, the route must be
   logged, the plain screen must have run on the card and no screen
   kernel for it; the PAM annotation, stamped before the screen's route
   is chosen, must have launched once per contig.
13. Roofline probes: the Q 20 probes' SASS must hold at least one max
   instruction per add+max pair of a column (nothing folded); each probe
   (``csrc/probes.cu``) must equal its plain
   PyTorch version bit for bit at a small shape, at
   benchmarks/screen_ab.py's (T 1024, N 32,768, Q 20), at N 1 and at the
   ceiling wavefront's edges (T < Q, T = Q, T = Q + 1, T = 1, Q = 1, Q =
   48, bias below 0) at N 32,768 and 32,771; times both at screen_ab.py's
   shape; then ``ops/probes.py::roofline`` times both probes there and on a
   card-filling shape (N = SMs x 2048) and the three screen kernels at
   their main-path shapes (the multi-guide kernel also at a variant slot
   batch, B 8192 x T 64, G 1), and prints each one's bound and share, and
   each screen's DP cells per second (all chains and per chain) as a
   share of the ceiling probe's at both of its shapes.
14. Resident serving at 1 Gb: six seeded contigs at GRCh38's lengths of
   chr1-chr5 and chrM (1,061,214,893 bases, a cut of
   benchmarks/serve_bench.py's 3.1 Gb / 8-contig genome) with planted
   sites of every request guide and about 1,027,000 SNVs (one per 1,033
   bases, benchmarks/hg38_scale.py's density).  One
   ``ResidentSearcher(engine="gpu", threads=8)`` stages the contigs and
   indexes the VCF, warms up, and answers through ``serve_stdio`` in this
   process: r1 config 3's guide, r2 serve_bench's second guide at
   ``max_guide_diffs`` 4, r3 its third, r4 all three and
   hg38_scale.py's fourth as one fused group, r5 the 24-base 5'-PAM
   guide of phase 11, r6 r1 on chr5 alone, and r1 again.  Each reply must
   be ok and each table must equal a fresh ``run()`` on the card
   (time_stamp and aligner_version blanked); staging must run once per
   contig at construction and never in a request; each single-guide
   request must launch the dual kernel once per grid segment and r4 the
   multi-guide kernel more than that, every request the multi-guide
   kernel's slot batches, and no plain version may run on the card.
   r5's widest launches of each kernel (Q 24: the dual kernel on a 1 Gb
   segment's 64,512 windows, the multi-guide kernel on its slot batches),
   and 8,192-row slot batches of T 64 and 128 with its guide, must equal
   the plain versions bit for bit, and r5 on chrM, served, must equal
   ``--engine host``'s table.  r1
   as two ``--process-index`` shards merged by MergeHitTables, and as a
   ``--checkpoint`` run and its resumption (every contig skipped, no
   kernel launched) must equal r1's table.  Then ``python -m
   calitas_tpu_torch Serve`` on config 2's 2 Mb contig, as a subprocess:
   ready line, ping, one request equal to a fresh run, shutdown, exit 0
   within 60 s, the CUDA route in its log.  Prints staging, VCF index
   and warmup seconds, each request's seconds, rows and launches, and
   the first request's time against the best warm one's.
15. Faults on the card: config 3 through the CLI with an injected
   ``torch.cuda.OutOfMemoryError`` at staging (no kernel launch) and with
   an injected readback fault in segment 3 of 6 (config 3 run as one
   segment per 8,192-window batch; every segment launched): each table must equal the golden and ``utils.DEGRADED`` must
   read exactly the one injected fault; config 3 with ``-m 300000000``
   (a score set whose end shift leaves int32, which the dual kernel's
   launch refuses) must fail with ``KernelError``, write no table and
   degrade nothing; so must config 3 in a process of its own whose dual
   kernel reads 1 TiB past its genome (a real illegal address, reported
   only at a later call); a ``ResidentSearcher`` on a 6 + 4 Mb genome whose
   4 Mb contig fails to stage must serve a request with a fresh run's
   table, launching the dual kernel for the resident contig's segments
   only.
16. Mesh and ``--distributed``: on phase 3's 40 Mb genome,
   ``ShardedGenomeScreen`` with 2 and 4 spans on this card (and over
   every visible device when there is more than one; the count is
   printed) must equal ``GenomeScreen`` bit for bit, flags and ranges,
   dual and G 4 multi-guide segmented screens, with one launch per span
   per segment; golden configs 3, 5s and 4 through ``run(mesh=)`` of two
   spans on this card (and config 3 over every visible device when there
   are several) must equal their goldens, the grid kernel launched once
   per span per segment, config 4's slot batches split, no plain version
   on the card; two ``--distributed`` processes (gloo, ``RANK`` 0/1,
   ``--engine gpu``) on a 6.5 Mb genome of 3 contigs must merge to the
   single run's table.  Prints config 3's screen time (stage + annotate
   + kernel + readback) at 1, 2 and 4 spans of this card (and over every
   visible device) with each span's lane count, and the dual kernel alone
   at config 3's grid and one 1 Gb segment's split over 1, 2 and 4
   streams.
17. Entry points (``calitas_tpu_torch/graft_entry.py``): ``entry()``'s
   step (B 64 x T 256 x Q 20) on this card must equal the plain version
   bit for bit with one row-kernel launch; ``screen_on_mesh`` at phase
   9's shape (d) (41,238 seeded rows x 1000, lengths 0..1000, config 3's
   protospacer planted in every 1,000th row, its guide and min score, one
   shared query) over 1, 2 and 4 spans of this card (and over every
   visible card when there are several) must equal the plain version,
   best and total, with one launch per span; prints each run's wall and
   each span's kernel time (graph-timed) beside phase 9's (d);
   ``dryrun_multichip(2)`` and ``(4)`` as spans of this card (and
   ``dryrun_multichip`` over every visible card) must pass, launch all
   three screens and give one table.
18. The port's bench at 1 Gb (``calitas_tpu_torch/bench.py``, the
   counterpart of the root ``bench.py``): its 1024 Mb hash genome written
   as FASTA; the device generator must equal ``genome_codes`` over all
   1,024,000,000 positions with a zero pad (one D2H copy); one
   ``search_bench`` on this card (warm run, best of 3, screen alone, both
   stagings, host baseline), on a finish pool of the bench's own 4
   workers (the earlier phases' pool is shut down first), must find 75,328 raw and 74,649 kept hits,
   launch ``screen_dual`` once per segment per run and no plain version,
   and degrade nothing; its widest launch must equal the plain version
   bit for bit (kernel and plain times, bound).  Prints the bench's JSON
   line, its breakdown and the card.  The screen alone at 2 and 4 spans
   of this card (``ShardedGenomeScreen``) must equal one span's flags and
   ranges (best of 3 each, in turns); with several cards visible, the
   bench through ``ShardedGenomeScreen(make_mesh())`` must give the
   one-card table byte for byte, with its e2e and screen-alone times,
   and launch ``pam_annotate`` once per card for each screen.

19. PAM annotation (``csrc/pam_annotate.cu``): at 2^28 positions, each
   benchmark cell's PAM spec through the kernel and the plain version,
   equal byte for byte, both timed against the bytes bound; a resident
   searcher at GRCh38's 25 contig lengths answers one SpCas9 request with
   the route forced to the plain version and one through the kernel, in
   turns, twice: the same table, one kernel launch per contig, and each
   request's peak device memory; every staged contig annotated both ways,
   equal byte for byte, with the summed times and bound.

After every phase but 15, ``utils.DEGRADED`` must read zero: no screen
fell back to the host.  After the phases, passed or not, it stops every process it started and
waits for each to end: the finish pool's workers, then the resource
tracker of the pool's spawn context, then any other descendant.

The line before the last is a JSON object describing the kernels (the
launch counts are those of the main paths: phases 4 and 14's requests
and phase 16's mesh goldens for the dual kernel, phases 6, 7 and 14's
requests and phase 16's mesh goldens for the multi-guide kernel, the gpu
runs of phases 10 and 11 for the row kernel, and for all three phase
17's driven runs (``entry()``, ``screen_on_mesh``, the dry runs), and
phase 18's bench runs for the dual kernel; phase 13's roofline run for
the probes; phase 19's SpCas9 requests for the PAM annotation; the row
kernel's times are those of the launcher's L at phase 9's shape (a), the
list tools' per-row mode; each bound is that of the timed call's
inputs); the last line is ``{"ok":
true, "device": {...}}``.  Exits non-zero, without that line, when there
is no CUDA device or the repository is missing.  ``--only 13 15 16 17
18 19`` runs the build and those phases alone (see :func:`phases_alone`).
"""

from __future__ import annotations

import collections
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


def lane_ptxas(path: Path, kernel: str = "screen_dual_kernel") -> dict:
    """``{(Q, lanes): (registers, spill bytes)}`` of every ``kernel<Q, L>``
    instantiation (``screen_dual_kernel`` or ``screen_multi_kernel``), or
    ``{(Q, lanes, per_row): ...}`` of every ``screen_rows_kernel<Q, L,
    per_row>``, from ptxas's ``-v`` report."""
    import re

    out = {}
    for entry in path.read_text().split("Compiling entry function")[1:]:
        m = re.search(rf"{kernel}ILi(\d+)ELi(\d+)E(?:Lb([01])E)?E", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        if not m or not regs:
            continue
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", entry))
        key = (int(m[1]), int(m[2])) + (() if m[3] is None else (m[3] == "1",))
        out[key] = (int(regs[1]), spill)
    return out


def lane_sass(dp_cuda, source: str = "screen_dual", Q: int = 20, extra: str = "") -> dict:
    """Instruction counts of ``<source>_kernel<Q, L>`` (with ``extra``,
    the mangled further template arguments: ``"Lb1E"`` for
    ``screen_rows_kernel<Q, L, true>``) for each L, from its SASS
    (cuobjdump): the whole kernel, and its steady loop (the backward
    branch whose body holds the most DPX add+max, VIADDMNMX) with that
    loop's instructions per DP cell and chain (each cell of a chain runs
    two VIADDMNMX)."""
    import re
    import shutil
    from collections import Counter

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = dp_cuda.build_all([source])[source]
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.match(rf".*{source}_kernelILi{Q}ELi(\d+)E{extra}E", body.split("\n", 1)[0])
        if not m:
            continue
        ins = [(int(a, 16), op.split(".")[0], rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
        ins = [x for x in ins if x[1] != "NOP"]
        loop = []
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if target and int(target[1], 16) < addr:
                body_ops = [o for a, o, _r in ins if int(target[1], 16) <= a <= addr]
                if body_ops.count("VIADDMNMX") > loop.count("VIADDMNMX"):
                    loop = body_ops
        ops = Counter(loop)
        out[int(m[1])] = {"total": len(ins), "loop": len(loop),
                          "loop_VIADDMNMX": ops["VIADDMNMX"],
                          "per_cell_chain": 2 * len(loop) / max(ops["VIADDMNMX"], 1),
                          "loop_top": dict(ops.most_common(8))}
    if not out:
        raise AssertionError(f"{source}_kernel<{Q}, L> not found in the SASS")
    return out


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


def phase3_genome(np) -> tuple:
    """Phase 3's 40 Mb contig (raw bytes) and its planted protospacers
    ``{Q: protospacer}``."""
    rng = np.random.default_rng(11)
    protos = {
        20: GUIDE[:20],
        24: "".join("ACGT"[i] for i in rng.integers(0, 4, 24)),
        48: "".join("ACGT"[i] for i in rng.integers(0, 4, 48)),
    }
    return synthetic_genome(np, CONTIG, 7, list(protos.values())), protos


def kernel_vs_plain(torch, np, dp_cuda, dp_screen, gs, scorer, device):
    """Phase 3, first half: returns (max_abs_err over all cases, kernel
    ms, plain ms, the annotated genome, the timed call's (qvals, kwargs))."""
    from calitas_tpu_torch.core.sequence import encode_query, revcomp

    t0 = time.perf_counter()
    raw, protos = phase3_genome(np)
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
        f"{kw['n_windows']} windows of the 40 Mb contig): kernel {kernel_ms:.4f} ms "
        f"(L={dp_cuda.screen_dual_default_lanes(20)}), plain {plain_ms:.4f} ms")
    return max_err, kernel_ms, plain_ms, genome, (qvals, kw)


LANE_CASES = (  # (Q, window, gate): every L <= Q of each against the plain version
    (1, 2500, True), (2, 40, False), (21, 1000, True), (23, 1003, False),
    (47, 64, True), (48, 2500, False), (24, 1000, True),  # Q 24: phase 14's r5
)
LANE_WINDOWS = 4099  # not a multiple of any block's window count
LANE_NOISE = 1.03  # the launcher's L may be this much slower than the fastest


def dual_lanes(torch, np, dp_cuda, dp_screen, gs, scorer, genome, main_kw, regs):
    """Phase 3, second half: each lane count of the dual kernel against
    the plain version on the edge cases, each L timed at config3's shape
    and at one 1 Gb segment's (Q 20), and at both at every Q from 2 to 48;
    fails when the launcher's L is not the fastest (least sum over the two
    shapes, within ``LANE_NOISE``) at some Q."""
    rng = np.random.default_rng(31)
    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    n = LANE_WINDOWS
    for Q, window, gate in LANE_CASES:
        step = window - (Q + 3 + 5 + 3 - 1)
        # The last three windows start at or past the end of the staged
        # genome, the ones before run past it.
        kw = dict(base0=genome.numel() - (n - 3) * step, step=step, n_windows=n,
                  window=window, min_score=0, pam_gate=gate, **sk)
        qvals = rng.integers(1, 16, (2, Q)).astype(np.int32)
        best0, _ = dp_screen.screen_dual_reference(genome, qvals, **kw)
        kw["min_score"] = int(best0.float().median())
        want = dp_screen.screen_dual_reference(genome, qvals, **kw)
        for L in (lanes for lanes in dp_cuda.DUAL_LANES if lanes <= Q):
            got = dp_cuda._screen_dual_lanes(genome, qvals, lanes=L, **kw)
            torch.cuda.synchronize()
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            log(f"[lanes] Q={Q} L={L} window={window} step={step} gate={gate} "
                f"windows={n} (last 3 past the end) bit-identical={same}")
            if not same:
                raise AssertionError(f"dual kernel L={L} != plain at Q={Q} window={window}")

    # One 1 Gb segment: 64,512 windows over a 64 Mb genome made here.
    big = gs.annotate_genome_pam(
        gs.GenomeScreen(scorer, genome.device, window=1000).stage(
            synthetic_genome(np, 64_000_000, 8, [GUIDE[:20]])),
        gs.encode_pam_spec((("nrg",), 1, 3)),
    )
    qvals, kw = main_kw
    for shape, g, skw in (("config3", genome, kw),
                          ("1 Gb segment", big, dict(kw, n_windows=64_512))):
        for L in dp_cuda.DUAL_LANES:
            ms = cuda_time_ms(torch, lambda: dp_cuda._screen_dual_lanes(
                g, qvals, lanes=L, **skw), 20)
            r, sp = regs[20, L]
            log(f"[lanes] {shape} ({skw['n_windows']} windows of 1000, Q 20, gate on) "
                f"L={L}: {ms:.4f} ms, {r} registers, {sp} spill bytes")
    # At every Q: each L's time at both shapes; the fastest L has the
    # least sum.
    wrong = {}
    for Q in range(2, dp_cuda.Q_MAX + 1):
        qv = rng.choice(np.array([1, 2, 4, 8], np.int32), (2, Q))
        step = 1000 - (Q + 3 + 5 + 3 - 1)
        bkw = dict(kw, step=step, min_score=scorer.match_score * Q - 5 * 122)
        ms = {}
        for _trial in range(3):  # the least of three: one clock dip decides nothing
            for shape, g, n in (("config3", genome, (CONTIG - 2) // step + 1),
                                ("1 Gb segment", big, 64_512)):
                for L in dp_cuda.DUAL_LANES:
                    t = cuda_time_ms(torch, lambda: dp_cuda._screen_dual_lanes(
                        g, qv, lanes=L, **dict(bkw, n_windows=n)), 10)
                    ms[shape, L] = min(ms.get((shape, L), t), t)
        sums = {L: ms["config3", L] + ms["1 Gb segment", L] for L in dp_cuda.DUAL_LANES}
        fastest = min(sums, key=sums.get)
        launcher = dp_cuda.screen_dual_default_lanes(Q)
        log(f"[lanes] Q={Q}: " + "; ".join(
            f"L={L} config3 {ms['config3', L]:.4f} + 1 Gb segment "
            f"{ms['1 Gb segment', L]:.4f} = {sums[L]:.4f}" for L in sums)
            + f" ms; fastest L={fastest}, launcher L={launcher}")
        if sums[launcher] > sums[fastest] * LANE_NOISE:
            wrong[Q] = sums
    del big
    if wrong:
        raise AssertionError(f"the launcher's L is not the fastest at {wrong}")


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


CONFIG5S_WINDOWS = 10_310  # config 5s's 10 Mb contig at step 970
SLOT_B = 8192  # the variant pass's slot batch (search/variants.py::dispatch)


def multi_shapes(torch, np, genome, scorer, Q: int, rng) -> list:
    """The multi-guide kernel's timed shapes at query length ``Q``:
    ``[(label, genome, qvals, min_scores, grid kwargs)]`` for (a)
    config5s (10,310 windows of 1000, G 4, gate and ranges on), (b)
    config3's grid (G 4, gate and ranges on) and (c) the variant pass's
    slot batches (B 8192 x T 64 / 128, flattened with step = window = T,
    gate and ranges off, G 1 and 4); then (d), the launches between and
    beyond those that real runs also make: config5s's grid at G 2 and 8,
    a 2 Mb contig's 2,000 windows at G 4, slot batches of G 2 at T 64 and
    of wider slots (T 256 / 512, which longer variant windows take) at G 1
    and 4.  ``genome`` is phase 3's annotated 40 Mb genome; the slots are
    its masks at seeded starts."""
    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    step = 1000 - (Q + 3 + 5 + 3 - 1)  # the CLI's step for a Q+3 guide
    ms = scorer.match_score * Q - 5 * 122

    def guides(G):
        qv = rng.choice(np.array([1, 2, 4, 8], np.int32), (G, 2, Q))
        return qv, np.full(G, ms, np.int32)

    grid = dict(base0=0, step=step, window=1000, pam_gate=True, emit_ranges=True, **sk)
    out = [("a config5s G=4", genome, *guides(4), dict(grid, n_windows=CONFIG5S_WINDOWS)),
           ("b config3 G=4", genome, *guides(4),
            dict(grid, n_windows=(CONTIG - 2) // step + 1))]
    masks = genome & 15
    slots = {}
    for T in (64, 128, 256, 512):
        starts = torch.as_tensor(rng.integers(0, CONTIG - T, SLOT_B), device=genome.device)
        rows = masks[starts[:, None] + torch.arange(T, device=genome.device)]
        slots[T] = (rows.reshape(-1).contiguous(),
                    dict(base0=0, step=T, n_windows=SLOT_B, window=T, pam_gate=False,
                         emit_ranges=False, **sk))
    for T in (64, 128):
        for G in (1, 4):
            out.append((f"c slots T={T} G={G}", slots[T][0], *guides(G), slots[T][1]))
    for G in (2, 8):
        out.append((f"d config5s G={G}", genome, *guides(G),
                    dict(grid, n_windows=CONFIG5S_WINDOWS)))
    out.append(("d 2 Mb contig G=4", genome, *guides(4), dict(grid, n_windows=2_000)))
    for T, G in ((64, 2), (256, 1), (256, 4), (512, 1), (512, 4)):
        out.append((f"d slots T={T} G={G}", slots[T][0], *guides(G), slots[T][1]))
    return out


def launcher_times(probes, launchers: dict, outputs: dict | None = None) -> dict:
    """``{key: ms}``: each of ``launchers`` (``{key: () -> (launch,
    outputs)}``, a new prepared launch per call) timed together by
    ``probes.graph_times_ms`` (CUDA graphs of about 2 ms each, the keys
    replayed in turn within each of five trials), twice, each time with
    new outputs and graphs; each key's least time.  ``outputs``, when
    given, receives each key's outputs as the second round's graphs left
    them."""
    best = {}
    for _ in range(2):
        made = {key: make() for key, make in launchers.items()}
        for key, t in probes.graph_times_ms({k: m[0] for k, m in made.items()}).items():
            best[key] = min(best.get(key, t), t)
        if outputs is not None:
            outputs.update({key: m[1] for key, m in made.items()})
    return best


def multi_shape_times(dp_cuda, probes, shape, lanes) -> dict:
    """``{L: ms}``: one multi-guide launch at ``shape`` (from
    :func:`multi_shapes`) with each L of ``lanes``, timed together by
    :func:`launcher_times`."""
    _label, g, qv, mss, kw = shape
    return launcher_times(probes, {
        L: (lambda L=L: dp_cuda._screen_multi_launcher(g, qv, mss, lanes=L, **kw))
        for L in lanes})


INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def multi_lanes_vs_plain(torch, np, dp_cuda, dp_screen, scorer, genome) -> int:
    """Phase 5: every lane count of the multi-guide kernel
    (``_screen_multi_lanes``) against the plain version, bit for bit: on
    the lane split's edge cases (Q 1/2/21/23/24/47/48, G 1/4/17, gate on and
    off, 4,099 windows whose last ones run past the genome's end, ranges
    on and off, min scores at INT32_MIN and INT32_MAX beside ordinary
    ones) and on slot batches (B 8192 x T 64/128: G 1 at Q 20 and 24, G 4
    at Q 23); returns the max_abs_err."""
    rng = np.random.default_rng(32)
    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)

    def check(what, g, qv, mss, kw):
        want = dp_screen.screen_multi_reference(g, qv, mss, **dict(kw, emit_ranges=True))
        err = 0
        for L in (L for L in dp_cuda.MULTI_LANES if L <= qv.shape[-1]):
            for emit in (True, False):
                got = dp_cuda._screen_multi_lanes(g, qv, mss, lanes=L,
                                                  **dict(kw, emit_ranges=emit))
                torch.cuda.synchronize()
                pairs = [(got[0], want[0])] + ([(got[1], want[1])] if emit else [])
                err = max(err, *(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                                 for a, b in pairs))
                same = all(torch.equal(a, b) for a, b in pairs) and (emit or got[1] is None)
                log(f"[multi lanes] {what} L={L} ranges={emit} bit-identical={same}")
                if not same:
                    raise AssertionError(f"multi kernel L={L} != plain: {what} ranges={emit}")
        return err

    def thresholds(g, qv, kw):
        """Per guide: the median best, minus the guide's index; the
        first two at INT32_MIN and INT32_MAX where there are two."""
        G = qv.shape[0]
        best0, _ = dp_screen.screen_multi_reference(
            g, qv, np.zeros(G, np.int32), **dict(kw, emit_ranges=False))
        mss = best0.float().median(dim=-1).values.amax(dim=-1).to(torch.int32).cpu().numpy()
        mss = mss - np.arange(G, dtype=np.int32)
        if G >= 2:
            mss[:2] = (INT32_MIN, INT32_MAX)
        return mss

    max_err = 0
    n = LANE_WINDOWS
    for i, (Q, window, gate) in enumerate(LANE_CASES):
        G = (1, 4, 17)[i % 3]
        step = window - (Q + 3 + 5 + 3 - 1)
        # The last three windows start at or past the end of the staged
        # genome, the ones before run past it.
        kw = dict(base0=genome.numel() - (n - 3) * step, step=step, n_windows=n,
                  window=window, pam_gate=gate, **sk)
        qv = rng.integers(1, 16, (G, 2, Q)).astype(np.int32)
        max_err = max(max_err, check(
            f"Q={Q} G={G} window={window} step={step} gate={gate} windows={n} "
            "(last 3 past the end)", genome, qv, thresholds(genome, qv, kw), kw))
    masks = genome & 15
    for T in (64, 128):
        starts = torch.as_tensor(rng.integers(0, CONTIG - T, SLOT_B), device=genome.device)
        slots = masks[starts[:, None] + torch.arange(T, device=genome.device)]
        slots = slots.reshape(-1).contiguous()
        kw = dict(base0=0, step=T, n_windows=SLOT_B, window=T, pam_gate=False, **sk)
        for G, Q in ((1, 20), (4, 23), (1, 24)):
            qv = rng.integers(1, 16, (G, 2, Q)).astype(np.int32)
            max_err = max(max_err, check(f"slots B={SLOT_B} T={T} G={G} Q={Q}", slots, qv,
                                         thresholds(slots, qv, kw), kw))
    return max_err


def multi_lane_times(torch, np, dp_cuda, probes, scorer, genome, regs) -> dict:
    """Phase 5: at Q 20, each shape of :func:`multi_shapes` timed with
    each L and the launcher's choice; then at every Q from 2 to 48, each L
    at each shape, and the launcher's L, which must be within
    ``LANE_NOISE`` of the fastest at every shape.  Returns ``{label: {L:
    ms, ..., "launcher": L, "work": (ops, bytes)}}`` at Q 20 (the bounds
    need phase 13's int32 rate)."""
    rng = np.random.default_rng(33)
    out = {}
    for shape in multi_shapes(torch, np, genome, scorer, 20, rng):
        label, g, qv, _mss, kw = shape
        G = qv.shape[0]
        row = multi_shape_times(dp_cuda, probes, shape, dp_cuda.MULTI_LANES)
        row["launcher"] = dp_cuda.screen_multi_default_lanes(20, kw["n_windows"], G,
                                                             kw["emit_ranges"])
        row["work"] = probes.grid_work(g.numel(), kw["base0"], kw["step"], kw["n_windows"],
                                       kw["window"], 20, guides=G,
                                       emit_ranges=kw["emit_ranges"])
        out[label] = row
        log(f"[multi lanes] {label} ({kw['n_windows']} windows of {kw['window']}, Q 20, "
            f"gate {kw['pam_gate']}, ranges {kw['emit_ranges']}): " + ", ".join(
                f"L={x} {row[x]:.5f} ms ({regs[20, x][0]} registers, {regs[20, x][1]} spill "
                f"bytes)" for x in dp_cuda.MULTI_LANES)
            + f"; launcher L={row['launcher']}")
    wrong = {}
    for Q in range(2, dp_cuda.Q_MAX + 1):
        line = []
        for shape in multi_shapes(torch, np, genome, scorer, Q, rng):
            label, _g, qv, _mss, kw = shape
            ms = multi_shape_times(dp_cuda, probes, shape,
                                   [L for L in dp_cuda.MULTI_LANES if L <= Q])
            fastest = min(ms, key=ms.get)
            launcher = dp_cuda.screen_multi_default_lanes(Q, kw["n_windows"], qv.shape[0],
                                                          kw["emit_ranges"])
            line.append(f"{label}: " + " ".join(f"L{L} {t:.5f}" for L, t in ms.items())
                        + f" fastest L{fastest} launcher L{launcher}")
            if ms[launcher] > ms[fastest] * LANE_NOISE:
                wrong[Q, label] = ms
        log(f"[multi lanes] Q={Q} (ms): " + "; ".join(line))
    if wrong:
        raise AssertionError(f"the launcher's L is not within {LANE_NOISE} of the fastest "
                             f"at {wrong}")
    return out


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


def rows_vs_plain(torch, np, dp_cuda, dp_screen, scorer, device) -> int:
    """Phase 9, first part: the row screen through its wrapper (the
    launcher's L) against the plain version, bit for bit, in shared-query
    mode (B 8192 x T 64/128/512, B 41,238 x T 1000 ragged) and per-row
    mode (B 20,000 x slots 64/128/256, lengths 0..slot, ranges on and
    off); returns the max_abs_err."""
    rng = np.random.default_rng(9)
    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    acgt = np.array([1, 2, 4, 8], np.uint8)

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

    max_err = 0
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
            max_err = max(max_err, compare_rows(
                torch, dp_cuda, dp_screen, sk,
                f"shared B={B} T={T} Q={Q} ragged={ragged} ranges={ms is not None}",
                q[None], tm, ln, ms))
    for T in (64, 128, 256):
        for k, Q in enumerate((1, 20, 24, 48)):
            B = 20_000
            qa = acgt[rng.integers(0, 4, (B, Q))]
            qmasks = np.stack([qa, np.asarray(RC_MASK, np.uint8)[qa[:, ::-1]]])  # revcomp
            tm = targets(B, T, lambda b: qa[b])
            ln = torch.from_numpy(rng.integers(0, T + 1, B).astype(np.int32)).to(device)
            ms = None
            if (T + k) % 2 == 0:
                ms = torch.from_numpy(
                    (scorer.match_score * Q - rng.integers(0, 6, B) * 122).astype(np.int32)
                ).to(device)
            qd = torch.from_numpy(np.ascontiguousarray(qmasks)).to(device)
            max_err = max(max_err, compare_rows(
                torch, dp_cuda, dp_screen, sk,
                f"per-row B={B} slot={T} Q={Q} ranges={ms is not None}", qd, tm, ln, ms))
    return max_err


RC_MASK = [0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15]  # IUPAC complement


def compare_rows(torch, dp_cuda, dp_screen, sk, what, qmasks, tm, ln, ms, lanes=None) -> int:
    """One row-screen call (the launcher's L, or ``lanes``) against the
    plain version; raises unless bit-identical; returns the max_abs_err."""
    if lanes is None:
        got = dp_cuda.screen_rows(qmasks, tm, ln, ms, **sk)
    else:
        got = dp_cuda._screen_rows_lanes(qmasks, tm, ln, ms, lanes=lanes, **sk)
    want = dp_screen.screen_rows_reference(qmasks, tm, ln, ms, **sk)
    err = same_rows(torch, got, want, f"{what}{'' if lanes is None else f' L={lanes}'}")
    log(f"[rows] {what}{'' if lanes is None else f' L={lanes}'} bit-identical=True "
        f"max_abs_err={err} best max {int(got[0].max())}")
    return err


def same_rows(torch, got, want, what: str) -> int:
    """Row-screen outputs ``(best, ranges)`` against the plain version's;
    raises unless bit-identical (ranges None in both or equal); returns
    the max_abs_err."""
    torch.cuda.synchronize()
    if (got[1] is None) != (want[1] is None):
        raise AssertionError(f"row kernel != plain: {what}: ranges {got[1] is None} "
                             f"vs {want[1] is None}")
    pairs = [(got[0], want[0])] + ([(got[1], want[1])] if want[1] is not None else [])
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in pairs)
    if not all(torch.equal(g, w) for g, w in pairs):
        raise AssertionError(f"row kernel != plain: {what}, max_abs_err {err}")
    return err


ROW_LANE_CASES = (  # (Q, T): every L <= Q of each, both modes, against the plain version
    (1, 64), (2, 100), (20, 128), (21, 256), (23, 201), (24, 256), (47, 128), (48, 1000),
)
ROW_LANE_B = 4099  # not a multiple of any block's row count


def rows_lanes_vs_plain(torch, np, dp_cuda, dp_screen, scorer, device) -> int:
    """Phase 9, second part: every lane count of the row kernel
    (``_screen_rows_lanes``) in both modes against the plain version, bit
    for bit, ranges on and off, at Q 1/2/20/21/23/24/47/48 on 4,099 rows whose
    lengths mix 0, 1, L - 1, T, past T and random ones inside each warp,
    with min scores at INT32_MIN and INT32_MAX beside ordinary ones;
    returns the max_abs_err."""
    rng = np.random.default_rng(39)
    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    B = ROW_LANE_B
    max_err = 0
    for Q, T in ROW_LANE_CASES:
        tm = torch.from_numpy(rng.integers(0, 16, (B, T), dtype=np.uint8)).to(device)
        for per_row in (False, True):
            q = rng.integers(1, 16, (2, B, Q) if per_row else (1, Q)).astype(np.uint8)
            qd = torch.from_numpy(q).to(device) if per_row else q
            for L in dp_cuda.rows_lanes(Q, per_row):
                lens = rng.integers(0, T + 1, B)
                # 32 rows in every 128 (a warp's at L 1) cycle through the edges
                edge = np.array([0, 1, L - 1, T, T + 3])
                for w0 in range(0, B, 128):
                    n = min(32, B - w0)
                    lens[w0 : w0 + n] = edge[np.arange(n) % len(edge)]
                ln = torch.from_numpy(lens.astype(np.int32)).to(device)
                best0, _ = dp_screen.screen_rows_reference(qd, tm, ln, **sk)
                ms = (best0.amax(0).cpu().numpy() - rng.integers(0, 300, B)).astype(np.int32)
                ms[:6] = (INT32_MIN, INT32_MAX, dp_screen.NEG_INF, dp_screen.NEG_INF + 1,
                          INT32_MIN, 0)
                for ranges in (True, False):
                    max_err = max(max_err, compare_rows(
                        torch, dp_cuda, dp_screen, sk,
                        f"{'per-row' if per_row else 'shared'} Q={Q} B={B} T={T} "
                        f"ranges={ranges}", qd, tm, ln,
                        torch.from_numpy(ms).to(device) if ranges else None, lanes=L))
    return max_err


ROWS_Q = 20  # the timed shapes' query length (config 3's guide)
ROW_MAIN = "a per-row 20000x256"  # the kernels line's shape for the row kernel
ROW_ENTRY = "d shared 41238x1000"  # phase 17's shape: the mesh batch screen's


def row_targets(torch, np, device, seed: int = 90) -> dict:
    """The row kernel's timed target batches: ``{label: (tmasks, lengths,
    per_row, ranges)}``, random ACGT masks made on the card: (a) 20,000
    rows x slot 256, lengths uniform 0..256, ranges on (the per-row shape
    timed since the first design); (b) pairs20k's chunks as
    PairwiseAlignSequences sends them (targets of 100-200 bases, bucketed
    by slot): 2,870 x 128 with lengths 100-128 and 7,130 x 256 with
    lengths 129-200, ranges off; (c) a2r20k's chunks as AlignToReference
    builds them at ``-w 200``: 5,000 rows of 201 bases in slot 256,
    ranges on (all-hits); (d) shared query, 41,238 rows x 1000, lengths
    0..1000, no ranges (``_kernel``'s contract at config 3's window
    count); (e) per-row chunks at the lane table's row-count bounds and
    at other slots, lengths in (slot/2, slot] as the pair screen buckets
    them: 4,000 x 128, 5,500 x 128, 6,000 x 512 (ranges on), 12,000 x
    256, 12,000 x 1024 (ranges on) and 32,768 x 128 (a full chunk)."""
    rng = np.random.default_rng(seed)
    acgt = torch.tensor([1, 2, 4, 8], dtype=torch.uint8, device=device)

    def batch(B, T, lo, hi):
        tm = acgt[torch.from_numpy(rng.integers(0, 4, (B, T))).to(device)].contiguous()
        ln = torch.from_numpy(rng.integers(lo, hi + 1, B).astype(np.int32)).to(device)
        return tm, ln

    out = {
        "a per-row 20000x256": (*batch(20_000, 256, 0, 256), True, True),
        "b pairs20k 2870x128": (*batch(2_870, 128, 100, 128), True, False),
        "b pairs20k 7130x256": (*batch(7_130, 256, 129, 200), True, False),
        "c a2r20k 5000x256": (*batch(5_000, 256, 201, 201), True, True),
        "d shared 41238x1000": (*batch(41_238, 1000, 0, 1000), False, False),
    }
    for B, slot, ranges in ((4_000, 128, False), (5_500, 128, False), (6_000, 512, True),
                            (12_000, 256, False), (12_000, 1024, True),
                            (32_768, 128, False)):
        out[f"e chunk {B}x{slot}"] = (*batch(B, slot, slot // 2 + 1, slot), True, ranges)
    return out


def row_shapes(torch, np, scorer, targets: dict, Q: int, rng) -> list:
    """The timed row-screen calls at query length ``Q``: ``[(label,
    qmasks, tmasks, lengths, min_scores)]`` over :func:`row_targets`'
    batches; per-row queries are random ACGT with chain B their reverse
    complement, thresholds a perfect hit less 0-5 gaps."""
    out = []
    for label, (tm, ln, per_row, ranges) in targets.items():
        B = tm.shape[0]
        dev = tm.device
        if per_row:
            qa = rng.choice(np.array([1, 2, 4, 8], np.uint8), (B, Q))
            q = torch.from_numpy(np.stack([qa, np.asarray(RC_MASK, np.uint8)[qa[:, ::-1]]])
                                 ).to(dev)
        else:
            q = rng.choice(np.array([1, 2, 4, 8], np.uint8), (1, Q))
        ms = None
        if ranges:
            ms = torch.from_numpy(
                (scorer.match_score * Q - rng.integers(0, 6, B) * 122).astype(np.int32)
            ).to(dev)
        out.append((label, q, tm, ln, ms))
    return out


def row_lane_launchers(dp_cuda, shape, lanes, sk) -> dict:
    """``{L: () -> (launch, outputs)}``: prepared row-kernel launches of
    ``shape`` (from :func:`row_shapes`) with each L of ``lanes``."""
    _label, q, tm, ln, ms = shape
    return {L: (lambda L=L: dp_cuda._screen_rows_launcher(q, tm, ln, ms, lanes=L, **sk))
            for L in lanes}


ROWS_Q24 = ("b", "c")  # the shapes also timed at Q 24: the list tools' second guide


def row_lane_times(torch, np, dp_cuda, probes, dp_screen, scorer, device, regs) -> dict:
    """Phase 9, third part: at Q 20 (and Q 24 for (b) and (c)), each shape
    of :func:`row_targets` timed with each L, the launcher's choice and
    the plain version; every L's outputs, as the timing's graphs left
    them, and the wrapper's (the launcher's L) must equal the plain
    version's bit for bit.  Then at every Q from 2 to 48, each L at each
    shape, whose outputs must all be equal, and the launcher's L, which
    must be within ``LANE_NOISE`` of the fastest at every shape.  Returns
    ``{label: {L: ms, ..., "launcher": L, "plain": ms, "work": (ops,
    bytes)}}`` at Q 20, (b)'s and (c)'s also at Q 24 (labels ending
    " Q=24"); the bounds need phase 13's int32 rate."""
    rng = np.random.default_rng(91)
    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    targets = row_targets(torch, np, device)
    out = {}
    for Q in (ROWS_Q, 24):
        for shape in row_shapes(torch, np, scorer, targets, Q, rng):
            label, q, tm, ln, ms = shape
            if Q != ROWS_Q and not label.startswith(ROWS_Q24):
                continue
            per_row = q.ndim == 3
            lanes = dp_cuda.rows_lanes(Q, per_row)
            want = dp_screen.screen_rows_reference(q, tm, ln, ms, **sk)
            outs = {}
            row = launcher_times(probes, row_lane_launchers(dp_cuda, shape, lanes, sk), outs)
            row["launcher"] = dp_cuda.screen_rows_default_lanes(Q, tm.shape[0], per_row)
            err = max(same_rows(torch, got, want, f"{label} Q={Q} L={L} (graph)")
                      for L, got in outs.items())
            err = max(err, same_rows(torch, dp_cuda.screen_rows(q, tm, ln, ms, **sk), want,
                                     f"{label} Q={Q} wrapper"))
            row["plain"] = cuda_time_ms(torch, lambda: dp_screen.screen_rows_reference(
                q, tm, ln, ms, **sk), 3)
            mode = "per-row" if per_row else "shared"
            log(f"[row lanes] {label} (Q {Q}, {mode}, ranges {ms is not None}): " + ", ".join(
                f"L={x} {row[x]:.5f} ms ({regs[Q, x, per_row][0]} registers, "
                f"{regs[Q, x, per_row][1]} spill bytes)" for x in lanes)
                + f"; launcher L={row['launcher']}; plain {row['plain']:.4f} ms; every L "
                f"and the wrapper bit-identical to the plain version (max_abs_err {err})")
            row["work"] = probes.rows_work(ln.cpu().numpy(), Q, 2 if per_row else 1,
                                           per_row, ms is not None)
            out[label if Q == ROWS_Q else f"{label} Q={Q}"] = row
    wrong = {}
    for Q in range(2, dp_cuda.Q_MAX + 1):
        line = []
        for shape in row_shapes(torch, np, scorer, targets, Q, rng):
            label, q, tm, _ln, _ms = shape
            outs = {}
            ms = launcher_times(probes, row_lane_launchers(
                dp_cuda, shape, dp_cuda.rows_lanes(Q, q.ndim == 3), sk), outs)
            first = min(outs)
            for L, got in outs.items():
                same_rows(torch, got, outs[first], f"{label} Q={Q} L={L} against L={first}")
            fastest = min(ms, key=ms.get)
            launcher = dp_cuda.screen_rows_default_lanes(Q, tm.shape[0], q.ndim == 3)
            line.append(f"{label}: " + " ".join(f"L{L} {t:.5f}" for L, t in ms.items())
                        + f" fastest L{fastest} launcher L{launcher}")
            if ms[launcher] > ms[fastest] * LANE_NOISE:
                wrong[Q, label] = ms
        log(f"[row lanes] Q={Q} (ms; every L's outputs equal): " + "; ".join(line))
    if wrong:
        raise AssertionError(f"the row launcher's L is not within {LANE_NOISE} of the "
                             f"fastest at {wrong}")
    return out


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
        with PoolWatch() as pool, ChunkLog() as chunks:
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
        log(f"[{name}] pair-screen chunks of the gpu runs (count x message): " + "; ".join(
            f"{k} x {m}" for m, k in sorted(collections.Counter(chunks.messages).items())))
        check_kernel_route(name, n, plain)
        launches += n
    return launches


class ChunkLog(logging.Handler):
    """Collects the pair screen's DEBUG line per chunk (rows, slot, Q,
    ranges, route) from the ``calitas_tpu_torch.screen`` logger while
    the block runs."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []
        self._logger = logging.getLogger("calitas_tpu_torch.screen")

    def emit(self, record):
        if record.getMessage().startswith("Pair screen chunk"):
            self.messages.append(record.getMessage())

    def __enter__(self):
        self._level = self._logger.level
        self._logger.setLevel(logging.DEBUG)
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)
        self._logger.setLevel(self._level)


def long_guide(torch, dp_cuda, dp_screen, tmp: Path) -> None:
    """Phase 12: a 50-base DP query through SearchReference on config 2's
    2 Mb contig, on the card and with --device cpu."""
    from calitas_tpu_torch import cli, goldens
    from calitas_tpu_torch.io.fasta import IndexedFasta

    ref = goldens.build_ref(tmp, 2_000_000, 2, "c2ref")
    fasta = IndexedFasta(ref)
    bases = bytes(fasta.get_bases("chr21"))
    n_contigs = len(fasta.names)
    fasta.close()
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
    screens = {k: n for k, n in launches.items() if k.startswith("screen_")}
    if plain == 0 or any(screens.values()):
        raise AssertionError("the 50-base guide did not run on the plain route alone")
    # the PAM gate is stamped before the screen's route is chosen: once per contig
    if launches["pam_annotate"] != n_contigs:
        raise AssertionError(f"pam_annotate launched {launches['pam_annotate']} times, "
                             f"want one per contig ({n_contigs})")


#: the ceiling's wavefront edges (T, Q, bias): T < Q, T = Q, T = Q + 1,
#: T = 1, Q = 1, Q = 48, bias below 0; phase 13 runs each at N 32,768 and
#: at a ragged N (not a multiple of the 64-thread block)
PROBE_EDGES = ((5, 20, -7), (20, 20, 3), (21, 20, -1), (1, 20, 0), (1, 1, -5), (7, 1, 11),
               (100, 48, 11), (37, 48, -9))


def probes_vs_plain(torch, np, dp_cuda, probes, device):
    """Phase 13, first half: each probe against its plain version, bit
    for bit, at a small shape, at screen_ab.py's (T 1024, N 32,768,
    Q 20), at N 1 and at the ceiling's edge shapes (``PROBE_EDGES``) at N
    32,768 and 32,771, with screen_ab.py's column values (masks 1-15 with
    both PAM bits set); returns (max_abs_err, {name: (kernel ms, plain
    ms)}) at screen_ab.py's shape."""
    rng = np.random.default_rng(13)
    max_err = 0
    times = {}
    shapes = [(16, 2048, 5, -3), (1024, 32_768, 20, 0), (1024, 1, 20, -2)]
    shapes += [(T, N, Q, bias) for T, Q, bias in PROBE_EDGES for N in (32_768, 32_771)]
    for T, N, Q, bias in shapes:
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
            if (T, N, Q) == (1024, 32_768, 20):
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
    log("[roofline] ceiling probe: " + ", ".join(
        f"{c:.6g} DP cells/s at N {N}" for N, c in roof["ceiling_cells_per_s"].items()))
    for name, r in roof["kernels"].items():
        log(f"[roofline] kernel {name} against the ceiling: {r['cells_per_s']:.6g} cells/s, "
            f"{r['chains']} chains, {r['cells_per_s_per_chain']:.6g} per chain; share of the "
            "ceiling's cell rate (all chains / per chain): " + ", ".join(
                f"N {N} {100 * r['share_of_ceiling'][N]:.2f} / "
                f"{100 * r['share_of_ceiling_per_chain'][N]:.2f} %"
                for N in roof["ceiling_cells_per_s"]))
    if not all(launches.values()):
        raise AssertionError(f"roofline did not launch every probe: {launches}")
    return roof, launches


def probes_and_roofline(torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp: Path):
    """Phase 13: the probes' SASS, each probe against its plain version,
    then ``roofline``; returns (max_abs_err, {name: (kernel ms, plain
    ms)}, the roofline, the probes' launches in it)."""
    from calitas_tpu_torch.ops import probes

    probe_sass(dp_cuda)
    err, times = probes_vs_plain(torch, np, dp_cuda, probes, device)
    roof, launches = roofline_run(dp_cuda, probes, device)
    return err, times, roof, launches


#: phase 14's genome: GRCh38's lengths of chr1-chr5 and chrM, a cut of
#: benchmarks/serve_bench.py's 3.1 Gb / 8-contig genome to 1.06 Gb
SERVE_CONTIGS = (("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559),
                 ("chr4", 190_214_555), ("chr5", 181_538_259), ("chrM", 16_569))
#: benchmarks/serve_bench.py's three guides and benchmarks/hg38_scale.py's fourth
SERVE_GUIDES = (GUIDE, "ACGTACATGCTCGATACGACnrg", "TTGACCAAGCAAAACAGACCnrg",
                "GCATTTCAGGAGCTACGTTAnrg")
SNV_SPACING = 3_100_000_000 // 3_000_000  # benchmarks/hg38_scale.py: 3 M SNVs over 3.1 Gb


def fasta_record(np, fa, name: str, bases) -> None:
    """Writes contig ``name``'s ``bases`` (uint8) to the open FASTA ``fa``
    in 60-base lines."""
    n = len(bases)
    fa.write(f">{name}\n".encode())
    full = n // 60
    lines = np.full((full, 61), 10, np.uint8)  # newline in the last column
    lines[:, :60] = bases[: full * 60].reshape(full, 60)
    fa.write(memoryview(lines))
    if n % 60:
        fa.write(bases[full * 60 :].tobytes() + b"\n")


def serve_inputs(np, tmp: Path, contigs) -> tuple:
    """Phase 14's reference (FASTA in 60-base lines, .fai, .dict) and VCF:
    seeded contigs with mutated sites of every request guide planted (the
    3'-PAM guides by ``synthetic_genome``, 60 sites of ``G5`` after a
    ``TTTV`` PAM per contig), and one seeded SNV per ``SNV_SPACING``
    bases.  Returns (reference, VCF, SNV count)."""
    import hashlib

    from calitas_tpu_torch.core.sequence import revcomp
    from calitas_tpu_torch.io.fasta import DictEntry, SequenceDictionary, build_fai, dict_path_for

    ref, vcf = tmp / "serve1g.fa", tmp / "serve1g.vcf"
    code = np.zeros(256, np.int64)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    entries, n_snv = [], 0
    with open(ref, "wb") as fa, open(vcf, "w") as vf:
        vf.write("##fileformat=VCFv4.2\n"
                 '##INFO=<ID=AF,Number=A,Type=Float,Description="AF">\n'
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for k, (name, n) in enumerate(contigs):
            bases = synthetic_genome(np, n, 1400 + k, [g[:20] for g in SERVE_GUIDES])
            rng = np.random.default_rng(1450 + k)
            for _ in range(60):
                site = list(G5[4:])
                for _ in range(int(rng.integers(0, 5))):
                    site[int(rng.integers(0, len(site)))] = "ACGT"[int(rng.integers(0, 4))]
                seq = "TTT" + "ACG"[int(rng.integers(0, 3))] + "".join(site)
                if rng.random() < 0.5:
                    seq = revcomp(seq)
                pos = int(rng.integers(0, n - len(seq)))
                bases[pos : pos + len(seq)] = np.frombuffer(seq.encode(), np.uint8)
            fasta_record(np, fa, name, bases)
            entries.append(DictEntry(name=name, length=n, assembly="serve1g",
                                     md5=hashlib.md5(bases.tobytes()).hexdigest()))
            m = n // SNV_SPACING
            pos = np.arange(m, dtype=np.int64) * SNV_SPACING + rng.integers(1, SNV_SPACING + 1, m)
            ref_b = bases[pos - 1]
            alt = np.frombuffer(b"ACGT", np.uint8)[(code[ref_b] + rng.integers(1, 4, m)) % 4]
            afs = rng.uniform(0.01, 0.5, m)
            vf.write("".join(
                f"{name}\t{p}\t.\t{chr(r)}\t{chr(a)}\t50\tPASS\tAF={af:.3f}\n"
                for p, r, a, af in zip(pos.tolist(), ref_b.tolist(), alt.tolist(), afs.tolist())))
            n_snv += m
    build_fai(ref)
    SequenceDictionary(entries).write(dict_path_for(ref))
    return ref, vcf, n_snv


def table_digest(path) -> tuple:
    """(rows, sha256) of a table with time_stamp and aligner_version
    blanked: tables of 10^5 rows compare without holding them."""
    import hashlib

    digest = hashlib.sha256()
    with open(path) as fh:
        header = fh.readline()
        cols = header.rstrip("\n").split("\t")
        varying = [cols.index("time_stamp"), cols.index("aligner_version")]
        digest.update(header.encode())
        rows = 0
        for line in fh:
            f = line.rstrip("\n").split("\t")
            for i in varying:
                f[i] = ""
            digest.update(("\t".join(f) + "\n").encode())
            rows += 1
    return rows, digest.hexdigest()


def stdio(serve_stdio, searcher, requests: list) -> list:
    """Replies of ``serve_stdio`` in this process to ``requests`` (the
    ready line first)."""
    import io

    out = io.StringIO()
    serve_stdio(searcher, stdin=io.StringIO("".join(json.dumps(r) + "\n" for r in requests)),
                stdout=out)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def grid_segments(gs, scorer, device, contigs, guide: str, max_guide_diffs: int = 5) -> int:
    """Screen launches of one guide's reference pass over ``contigs``:
    one per segment of each contig's window grid."""
    screen = gs.GenomeScreen(scorer, device, window=1000)
    step = 1000 - (len(guide) + max_guide_diffs + 3 - 1)
    return sum(len(screen.segment_spans(len(screen.window_starts(n, step))))
               for _name, n in contigs)


def recording(taken: dict, name: str, wrapper):
    """``wrapper`` (``dp_cuda.screen_dual`` or ``screen_multi``), keeping
    in ``taken[name, window, emit_ranges]`` the inputs of its widest call
    (most windows) at that window: ``(genome, qvals, other positional
    arguments, keyword arguments)``.  The call itself is unchanged."""

    def call(genome, qvals, *args, **kw):
        key = (name, kw["window"], kw.get("emit_ranges"))
        if key not in taken or kw["n_windows"] > taken[key][3]["n_windows"]:
            taken[key] = (genome, qvals.copy(), [a.copy() for a in args], dict(kw))
        return wrapper(genome, qvals, *args, **kw)

    return call


def served_vs_plain(torch, np, dp_cuda, dp_screen, taken: dict, masks, what: str) -> dict:
    """Each kernel's wrapper against its plain version, bit for bit, on
    the inputs of the widest launches a served request made (``taken``,
    from :func:`recording`), and the multi-guide kernel on 8,192-row slot
    batches of T 64 and 128 cut from ``masks`` (a resident contig) with
    that request's guide.  Returns ``{kernel: max_abs_err}``."""
    rng = np.random.default_rng(34)
    cases = [(f"{what}'s", key, args) for key, args in taken.items()]
    slot = next(((g, q, a, kw) for (n, _w, e), (g, q, a, kw) in taken.items()
                 if n == "screen_multi" and e is False), None)
    if slot is None:
        raise AssertionError(f"{what} made no slot-batch launch")
    _g, qv, (mss,), kw = slot
    for T in (64, 128):
        starts = torch.as_tensor(rng.integers(0, masks.numel() - T, SLOT_B), device=masks.device)
        rows = (masks[starts[:, None] + torch.arange(T, device=masks.device)] & 15)
        cases.append((f"{what}'s guide on seeded slots:", ("screen_multi", T, False),
                      (rows.reshape(-1).contiguous(), qv, [mss],
                       dict(kw, base0=0, step=T, n_windows=SLOT_B, window=T))))
    errs = {"screen_dual": 0, "screen_multi": 0}
    for label, (name, window, _emit), (genome, qvals, args, kw) in cases:
        Q = qvals.shape[-1]
        if name == "screen_dual":
            got = dp_cuda.screen_dual(genome, qvals, **kw)
            want = dp_screen.screen_dual_reference(genome, qvals, **kw)
            lanes = dp_cuda.screen_dual_default_lanes(Q)
        else:
            got = dp_cuda.screen_multi(genome, qvals, *args, **kw)
            want = dp_screen.screen_multi_reference(genome, qvals, *args, **kw)
            lanes = dp_cuda.screen_multi_default_lanes(Q, kw["n_windows"], qvals.shape[0],
                                                       kw["emit_ranges"])
        torch.cuda.synchronize()
        pairs = [(a, b) for a, b in zip(got, want) if a is not None]
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in pairs)
        same = all(torch.equal(a, b) for a, b in pairs)
        log(f"[serve] {label} {name} at Q={Q} window={window} windows={kw['n_windows']} "
            f"gate={kw['pam_gate']} (launcher L={lanes}): bit-identical={same} "
            f"max_abs_err={err}")
        if not same:
            raise AssertionError(f"{name} != plain: {label} inputs at window {window}")
        errs[name] = max(errs[name], err)
    if not {n for (n, _w, _e) in taken} >= {"screen_dual", "screen_multi"}:
        raise AssertionError(f"{what} did not launch both kernels: {sorted(taken)}")
    return errs


def resident_serving(torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp: Path,
                     contigs=SERVE_CONTIGS) -> dict:
    """Phase 14: a resident server on 1.06 Gb (GRCh38's chr1-5 and chrM)
    with about 1,027,000 SNVs answers six requests through
    ``serve_stdio``; each table must equal a fresh ``run()`` on the card,
    staging must run once per contig and never in a request, every
    request must launch its kernels and no plain version may run on the
    card; r5's kernels must equal their plain versions on its own inputs
    (:func:`served_vs_plain`) and r5 on chrM the host engine's table; r1
    as two shards merged by MergeHitTables and as a checkpointed run (and
    its resumption, which launches nothing) must equal r1; the ``Serve``
    sub-command must answer on config 2's contig.  Returns the requests'
    kernel launches and ``{kernel: max_abs_err}`` of those comparisons."""
    from calitas_tpu_torch import cli, goldens
    from calitas_tpu_torch.io import vcf as vcf_mod
    from calitas_tpu_torch.serve import ResidentSearcher, serve_stdio
    from calitas_tpu_torch.tools import search_reference as sr

    t_phase = time.perf_counter()
    logging.getLogger("calitas_tpu_torch").setLevel(logging.INFO)  # PassClock reads INFO lines
    ref, vcf, n_snv = serve_inputs(np, tmp, contigs)
    log(f"[serve] {len(contigs)} contigs, {sum(n for _c, n in contigs)} bases, and "
        f"{n_snv} SNVs written in {time.perf_counter() - t_phase:.3f} s")

    stage_s, index_s = [], []
    orig_stage, orig_index = gs.GenomeScreen.stage, vcf_mod.VcfIndex.__init__

    def timed_stage(self, bases):
        t0 = time.perf_counter()
        out = orig_stage(self, bases)
        torch.cuda.synchronize()
        stage_s.append(time.perf_counter() - t0)
        return out

    def timed_index(self, path):
        t0 = time.perf_counter()
        orig_index(self, path)
        index_s.append(time.perf_counter() - t0)

    reqs = {
        "r1": dict(guide=GUIDE, guide_id="r1"),
        "r2": dict(guide=SERVE_GUIDES[1], guide_id="r2", max_guide_diffs=4),
        "r3": dict(guide=SERVE_GUIDES[2], guide_id="r3"),
        "r4": dict(guide_specs=[[f"g{i}", g, []] for i, g in enumerate(SERVE_GUIDES)]),
        "r5": dict(guide=G5, guide_id="r5"),
        "r6": dict(guide=GUIDE, guide_id="r1", chrom="chr5"),
        "r1 again": dict(guide=GUIDE, guide_id="r1"),
    }
    gs.GenomeScreen.stage, vcf_mod.VcfIndex.__init__ = timed_stage, timed_index
    try:
        t0 = time.perf_counter()
        searcher = ResidentSearcher(ref, vcf, engine="gpu", device=device, threads=8)
        build_s = time.perf_counter() - t0
        resident = sum(a.numel() * a.element_size() for a in searcher._staged.values())
        log(f"[serve] staging: {len(stage_s)} GenomeScreen.stage calls, {sum(stage_s):.3f} s "
            f"({', '.join(f'{s:.3f}' for s in stage_s)}), {resident} bytes resident on "
            f"{device}; VCF index {index_s[0]:.3f} s; constructor {build_s:.3f} s")
        if len(stage_s) != len(contigs):
            raise AssertionError(f"staging ran {len(stage_s)} times for {len(contigs)} contigs")
        t0 = time.perf_counter()
        searcher.warmup()
        log(f"[serve] warmup {time.perf_counter() - t0:.3f} s")

        seconds, rows, launches, passes = {}, {}, {}, {}
        taken = {}  # r5's (Q 24) widest launches, held against the plain versions below
        wrappers = dp_cuda.screen_dual, dp_cuda.screen_multi
        dp_screen.reference_calls["cuda"] = 0
        torch.cuda.reset_peak_memory_stats()
        clock = PassClock()
        for key, req in reqs.items():
            n_stage = len(stage_s)
            dp_cuda.reset_launches()
            logging.getLogger("calitas_tpu_torch.SearchReference").addHandler(clock)
            if key == "r5":
                dp_cuda.screen_dual = recording(taken, "screen_dual", wrappers[0])
                dp_cuda.screen_multi = recording(taken, "screen_multi", wrappers[1])
            try:
                replies = stdio(serve_stdio, searcher,
                                [dict(req, output=str(tmp / f"{key}.tsv"))])
            finally:
                dp_cuda.screen_dual, dp_cuda.screen_multi = wrappers
                logging.getLogger("calitas_tpu_torch.SearchReference").removeHandler(clock)
            launches[key] = dict(dp_cuda.launches)
            ready, reply = replies
            if not (ready["ready"] and ready["engine"] == "gpu"
                    and ready["staged_contigs"] == len(contigs)):
                raise AssertionError(f"serve ready line {ready}")
            if not reply["ok"]:
                raise AssertionError(f"serve {key}: {reply}")
            passes[key] = clock.passes()
            if len(stage_s) != n_stage:
                raise AssertionError(f"serve {key} staged a contig again")
            seconds[key], rows[key] = reply["seconds"], reply["rows"]
        plain_on_card = dp_screen.reference_calls["cuda"]
        log(f"[serve] requests' peak device memory {torch.cuda.max_memory_allocated()} bytes")
        errs = served_vs_plain(torch, np, dp_cuda, dp_screen, taken,
                               searcher._staged[contigs[0][0]], "r5")
        del taken
        # r5 on chrM through the server against the host engine
        r5m = dict(reqs["r5"], chrom=contigs[-1][0])
        ok = stdio(serve_stdio, searcher, [dict(r5m, output=str(tmp / "r5m.tsv"))])[1]["ok"]
        sr.run(output=tmp / "r5m_host.tsv", ref=ref, variants=vcf, threads=8, engine="host",
               **r5m)
        got, want = table_digest(tmp / "r5m.tsv"), table_digest(tmp / "r5m_host.tsv")
        log(f"[serve] r5 on {r5m['chrom']}: served {got[0]} rows, --engine host {want[0]} "
            f"rows, {'equal' if got == want else 'DIFFERENT'} tables")
        if not ok or got != want or got[0] == 0:
            raise AssertionError(f"r5 on {r5m['chrom']}: served {got}, host engine {want}")
        ping, bye = stdio(serve_stdio, searcher, [{"cmd": "ping"}, {"cmd": "shutdown"}])[1:]
        if not (ping["ready"] and bye.get("bye")):
            raise AssertionError(f"serve ping/shutdown replies {ping}, {bye}")

        # Every table against a fresh run with the same arguments.
        common = dict(ref=ref, variants=vcf, threads=8, engine="gpu", device=device)
        digests = {}
        for key, req in reqs.items():
            fresh_s = None  # "r1 again" is held against r1's fresh run
            if key == "r1 again":
                want = digests["r1"]
            else:
                t0 = time.perf_counter()
                sr.run(output=tmp / "fresh.tsv", **common, **req)
                fresh_s = time.perf_counter() - t0
                want = digests[key] = table_digest(tmp / "fresh.tsv")
            got = table_digest(tmp / f"{key}.tsv")
            searched = [c for c in contigs if c[0] == req.get("chrom", c[0])]
            guide = req.get("guide", SERVE_GUIDES[0])
            segs = grid_segments(gs, scorer, device, searched, guide,
                                 req.get("max_guide_diffs", 5))
            got_l = launches[key]
            log(f"[serve] {key}: {seconds[key]:.3f} s (reference pass {passes[key][0]:.3f} s, "
                f"variant pass after it {passes[key][1]:.3f} s), {rows[key]} rows, launches "
                f"screen_dual {got_l['screen_dual']} screen_multi {got_l['screen_multi']} "
                f"(grid segments {segs}); fresh run {fresh_s} s, "
                f"{'equal' if got == want else 'DIFFERENT'} table")
            if got != want or got[0] != rows[key]:
                raise AssertionError(f"serve {key}: table {got} differs from a fresh run's {want}")
            if "guide_specs" in req:
                ok = got_l["screen_dual"] == 0 and got_l["screen_multi"] > segs
            else:
                ok = got_l["screen_dual"] == segs and got_l["screen_multi"] >= 1
            if not ok:
                raise AssertionError(f"serve {key}: kernel launches {got_l}, grid segments {segs}")
            (tmp / f"{key}.tsv").unlink()
        if plain_on_card != 0:
            raise AssertionError("a serve request ran the plain screen on the card")
        warm = min(("r1 again", "r2", "r3"), key=seconds.get)
        log(f"[serve] first request r1 {seconds['r1']:.3f} s against the best warm one "
            f"({warm}) {seconds[warm]:.3f} s: ratio {seconds['r1'] / seconds[warm]:.3f}")
        del searcher
        torch.cuda.empty_cache()

        # r1 as two whole-contig shards, merged
        t0 = time.perf_counter()
        shards = []
        for i in range(2):
            shards.append(tmp / f"shard{i}.tsv")
            sr.run(output=shards[-1], process_index=i, process_count=2, **common,
                   **reqs["r1"])
        if cli.main(["MergeHitTables", "-i", *map(str, shards), "-o", str(tmp / "merged.tsv"),
                     "-r", str(ref)]) != 0:
            raise AssertionError("MergeHitTables failed")
        merged = table_digest(tmp / "merged.tsv")
        log(f"[serve] r1 as 2 shards ({', '.join(str(table_digest(s)[0]) for s in shards)} "
            f"rows) merged: {merged[0]} rows, {time.perf_counter() - t0:.3f} s")
        if merged != digests["r1"]:
            raise AssertionError("the merged shards differ from r1's table")

        # r1 checkpointed, then resumed from the complete checkpoint
        skipped = []

        class Skips(logging.Handler):
            def emit(self, record):
                if "skipping completed contig" in record.getMessage():
                    skipped.append(record.getMessage())

        ck = tmp / "serve_ck.jsonl"
        t0 = time.perf_counter()
        sr.run(output=tmp / "ck1.tsv", checkpoint=ck, **common, **reqs["r1"])
        ck_s = time.perf_counter() - t0
        handler = Skips(logging.INFO)
        logging.getLogger("calitas_tpu_torch.SearchReference").addHandler(handler)
        try:
            dp_cuda.reset_launches()
            t0 = time.perf_counter()
            sr.run(output=tmp / "ck2.tsv", checkpoint=ck, **common, **reqs["r1"])
            resume_s = time.perf_counter() - t0
            resumed_launches = dict(dp_cuda.launches)
        finally:
            logging.getLogger("calitas_tpu_torch.SearchReference").removeHandler(handler)
        log(f"[serve] r1 checkpointed {ck_s:.3f} s ({ck.stat().st_size} bytes of state), "
            f"resumed {resume_s:.3f} s: {len(skipped)} contigs skipped, launches "
            f"{resumed_launches}")
        for name in ("ck1.tsv", "ck2.tsv"):
            if table_digest(tmp / name) != digests["r1"]:
                raise AssertionError(f"the checkpointed run's {name} differs from r1's table")
        if len(skipped) != len(contigs) or any(resumed_launches.values()):
            raise AssertionError(f"resumed run: {skipped}, launches {resumed_launches}")
    finally:
        gs.GenomeScreen.stage, vcf_mod.VcfIndex.__init__ = orig_stage, orig_index

    # The Serve sub-command over pipes, on config 2's 2 Mb contig
    c2 = goldens.build_ref(tmp, 2_000_000, 2, "c2ref")
    sr.run(ref=c2, guide=GUIDE, guide_id="r1", output=tmp / "c2.tsv", threads=1,
           engine="gpu", device=device)
    requests = [{"cmd": "ping"}, {"guide": GUIDE, "guide_id": "r1"}, {"cmd": "shutdown"}]
    t0 = time.perf_counter()
    with open(tmp / "serve.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "calitas_tpu_torch", "Serve", "-r", str(c2), "-t", "1",
             "--engine", "gpu", "--device", str(device)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, text=True, cwd=ROOT,
        )
        try:
            out, _ = proc.communicate("".join(json.dumps(r) + "\n" for r in requests), timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    sub_s = time.perf_counter() - t0
    stderr = (tmp / "serve.err").read_text()
    replies = [json.loads(line) for line in out.splitlines()]
    route = f"on {device} -> " + ("CUDA kernel" if device.type == "cuda" else "plain")
    (tmp / "c2_serve.tsv").write_text(replies[2]["table"] if len(replies) > 2 else "")
    ok = (proc.returncode == 0 and len(replies) == 4 and replies[0]["engine"] == "gpu"
          and replies[1]["ready"] and replies[2]["ok"] and replies[3].get("bye")
          and table_digest(tmp / "c2_serve.tsv") == table_digest(tmp / "c2.tsv"))
    log(f"[serve] Serve sub-command: exit {proc.returncode} after {sub_s:.3f} s, "
        f"{len(replies)} replies, request {replies[2].get('seconds') if len(replies) > 2 else None} s, "
        f"{replies[2].get('rows') if len(replies) > 2 else None} rows; route logged: "
        f"{route in stderr}")
    if not ok or route not in stderr:
        raise AssertionError(f"Serve sub-command: {replies[:2]}, stderr tail {stderr[-2000:]}")
    import resource

    log(f"[serve] phase {time.perf_counter() - t_phase:.3f} s; this process's peak "
        f"resident memory so far: {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} kB")
    total = collections.Counter()
    for per in launches.values():
        total.update(per)
    return dict(total), errs


def no_degradation(utils, phase: str) -> None:
    """Raises when a phase degraded anywhere (``utils.DEGRADED``): on the
    card every screen must run, so a fault the table cannot show still
    fails the run."""
    left = {k: v for k, v in utils.DEGRADED.items() if v}
    if left:
        raise AssertionError(f"phase {phase} degraded to the host: {left}")


def fail_segment(screen_cls, k: int, exc):
    """``screen_contig_async`` of ``screen_cls`` with segment ``k``'s
    readback raising ``exc``."""
    orig = screen_cls.screen_contig_async

    def screen_contig_async(self, *a, **kw):
        segs = orig(self, *a, **kw)

        def fail():
            segs[k][2]()  # the readback itself completes; its result is lost
            raise exc

        return [(i0, n, fail if i == k else res) for i, (i0, n, res) in enumerate(segs)]

    return screen_contig_async


#: phase 15's child process: the port's CLI with every dual-kernel launch
#: handed the genome's address plus 1 TiB, so the kernel faults while it
#: runs (an illegal address breaks the process's CUDA context, hence a
#: process of its own).  Prints what left ``cli.main`` and the counts.
FAULT_CHILD = r"""
import json, os, sys, traceback
from calitas_tpu_torch import cli, utils
from calitas_tpu_torch.ops import dp_cuda

class FarGenome:
    def __init__(self, t):
        self._t = t
    def __getattr__(self, name):
        return getattr(self._t, name)
    def data_ptr(self):
        return self._t.data_ptr() + (1 << 40)

launch = dp_cuda._screen_dual
dp_cuda._screen_dual = lambda genome, *a: launch(FarGenome(genome), *a)
try:
    out = {"rc": cli.main(sys.argv[1:])}
except BaseException as ex:
    tb = traceback.extract_tb(ex.__traceback__)
    where = ([f for f in tb if "calitas_tpu_torch" in f.filename] or tb)[-1]
    out = {"raised": type(ex).__name__, "message": str(ex)[:120],
           "kernel_fault": isinstance(ex, dp_cuda.KernelError)
                           or utils.kernel_execution_fault(ex),
           "at": f"{os.path.relpath(where.filename)}:{where.lineno} {where.name}"}
print(json.dumps({**out, "degraded": utils.DEGRADED}), flush=True)
sys.exit(1 if "raised" in out else 0)
"""


def kernel_fault_child(argv: list) -> None:
    """Config 3 with a dual kernel that faults while it runs, in a child
    process: it must fail with the fault (``KernelError`` from a readback,
    or torch's own report, a ``RuntimeError`` or ``AcceleratorError``,
    from the next call that meets the card), write no table and degrade
    nothing."""
    out = Path(argv[argv.index("-o") + 1])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FAULT_CHILD, *map(str, argv)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    got = json.loads(lines[-1]) if lines else {}
    log(f"[faults] dual kernel 1 TiB past its genome, in a child: exit {proc.returncode}, "
        f"{got} in {time.perf_counter() - t0:.3f} s")
    if (proc.returncode == 0 or not got.get("kernel_fault")
            or "illegal memory access" not in got.get("message", "")
            or any(got.get("degraded", {"?": 1}).values()) or out.exists()):
        raise AssertionError(f"a kernel fault did not fail the run: table written "
                             f"{out.exists()}; stderr {proc.stderr[-3000:]}")


def faults_on_the_card(torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp: Path) -> None:
    """Phase 15: injected device faults degrade to the host with the
    golden table and are counted; a real kernel fault propagates."""
    from calitas_tpu_torch import cli, goldens, utils
    from calitas_tpu_torch.io.fasta import IndexedFasta, ReferenceSetBuilder
    from calitas_tpu_torch.serve import ResidentSearcher
    from calitas_tpu_torch.tools import search_reference

    argv = [*goldens.config3(tmp), "--engine", "gpu"]
    want = golden_rows("3")
    screen = gs.GenomeScreen(scorer, device, window=1000)
    contig = IndexedFasta(argv[argv.index("-r") + 1]).sequence_length("chr21")
    n = len(screen.window_starts(contig, DEFAULT_STEP))
    # Config 3 is one segment; for a fault mid-contig it runs one segment
    # per 8,192-window batch (MIN_BATCHES_PER_SEGMENT 1).
    screen.MIN_BATCHES_PER_SEGMENT = 1
    n_seg = len(screen.segment_spans(n))
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory (injected by chip_smoke)")
    readback = RuntimeError("CUDA error: injected readback fault (chip_smoke)")

    def raise_oom(self, bases):
        raise oom

    for point, patches, launches in (
        ("staging", {"stage": raise_oom}, 0),
        ("readback", {"screen_contig_async": fail_segment(gs.GenomeScreen, n_seg // 2, readback),
                      "MIN_BATCHES_PER_SEGMENT": 1}, n_seg),
    ):
        out = tmp / f"config3_{point}.txt"
        orig = {k: getattr(gs.GenomeScreen, k) for k in patches}
        for k, v in patches.items():
            setattr(gs.GenomeScreen, k, v)
        utils.reset_degraded()
        dp_cuda.reset_launches()
        try:
            e2e = run_cli(torch, cli, [*argv, "-o", str(out)])
        finally:
            for k, v in orig.items():
                setattr(gs.GenomeScreen, k, v)
        got = norm_rows(out.read_text())
        assert_same_table(got, want, f"config3 with a {point} fault differs from golden")
        counts = {k: v for k, v in utils.DEGRADED.items() if v}
        log(f"[faults] config3, injected {point} fault: table == golden ({len(got) - 1} "
            f"rows); degraded {counts}; dual kernel launches {dp_cuda.launches['screen_dual']} "
            f"(want {launches}); end to end {e2e:.3f} s")
        if counts != {point: 1} or dp_cuda.launches["screen_dual"] != launches:
            raise AssertionError(f"{point} fault: degraded {counts}, launches "
                                 f"{dp_cuda.launches['screen_dual']} (want {launches})")

    # A real kernel fault: a score set whose end shift Q * mismatch leaves
    # int32 is refused by the dual kernel's launch (KernelError).
    out = tmp / "config3_refused.txt"
    utils.reset_degraded()
    try:
        run_cli(torch, cli, [*argv, "-o", str(out), "-m", "300000000"])
    except dp_cuda.KernelError as ex:
        log(f"[faults] refused launch propagates: {ex}")
    else:
        raise AssertionError("a refused launch did not fail the command")
    if out.exists() or any(utils.DEGRADED.values()):
        raise AssertionError(f"refused launch: table written {out.exists()}, "
                             f"degraded {utils.DEGRADED}")
    kernel_fault_child([*argv, "-o", tmp / "config3_faulted.txt"])

    # A resident server whose staging of one contig fails.
    b = ReferenceSetBuilder(assembly="faults")
    for name, n, seed in (("chrA", 6_000_000, 151), ("chrB", 4_000_000, 152)):
        b.add(name).add(goldens.synth_genome(n, seed))
    ref = b.to_file(tmp / "faults.fa")
    fresh = tmp / "faults_fresh.txt"
    search_reference.run(guide=GUIDE, guide_id="r", ref=ref, output=fresh, engine="gpu",
                         device=device)
    orig = gs.GenomeScreen.stage

    def chr_b_fails(self, bases):
        if len(bases) == 4_000_000:
            raise oom
        return orig(self, bases)

    gs.GenomeScreen.stage = chr_b_fails
    utils.reset_degraded()
    try:
        searcher = ResidentSearcher(ref, engine="gpu", device=device, threads=8)
    finally:
        gs.GenomeScreen.stage = orig
    served = tmp / "faults_served.txt"
    dp_cuda.reset_launches()
    searcher.search(GUIDE, "r", output=str(served))
    torch.cuda.synchronize()
    seg_a = len(gs.GenomeScreen(scorer, device, window=1000).segment_spans(
        len(screen.window_starts(6_000_000, DEFAULT_STEP))))
    counts = {k: v for k, v in utils.DEGRADED.items() if v}
    assert_same_table(norm_rows(served.read_text()), norm_rows(fresh.read_text()),
                      "served table with chrB on the host differs from a fresh run")
    log(f"[faults] resident server, chrB's staging failed: resident {list(searcher._staged)}; "
        f"table == fresh run ({len(norm_rows(fresh.read_text())) - 1} rows); degraded "
        f"{counts}; dual kernel launches {dp_cuda.launches['screen_dual']} (chrA's "
        f"segments {seg_a})")
    if (counts != {"resident_staging": 1} or list(searcher._staged) != ["chrA"]
            or dp_cuda.launches["screen_dual"] != seg_a):
        raise AssertionError("resident staging fault not served from the host as expected")
    del searcher
    utils.reset_degraded()


def resolve_all(np, segs) -> tuple:
    """A segmented screen's flags and ranges, joined in window order."""
    parts = [resolve() for _i0, _n, resolve in segs]
    return (np.concatenate([f for f, _r in parts], axis=-1),
            np.concatenate([r for _f, r in parts], axis=-2))


def spans_together_ms(torch, prepared: list) -> float:
    """ms of prepared launches ``[(device, launch)]``, each on a stream of
    its own on its device, all after the current stream and before it
    goes on: CUDA events on the current stream, mean of 20."""
    streams = [torch.cuda.Stream(device=dev) for dev, _launch in prepared]

    def launch_all():
        cur = torch.cuda.current_stream()
        for st, (_dev, launch) in zip(streams, prepared):
            st.wait_stream(cur)
            with torch.cuda.stream(st):
                launch()
        for st in streams:
            cur.wait_stream(st)

    return cuda_time_ms(torch, launch_all, 20)


def span_kernel_ms(torch, dp_cuda, gs, genome, qvals, kw: dict, k: int) -> float:
    """ms of one dual-kernel grid split into ``k`` spans, each launched on
    its own stream of the genome's card (:func:`spans_together_ms`)."""
    return spans_together_ms(torch, [
        (genome.device, lambda s0=s0, n=n: dp_cuda.screen_dual(genome, qvals, **dict(
            kw, base0=kw["base0"] + s0 * kw["step"], n_windows=n)))
        for _e, s0, n in gs.mesh_spans(k, 0, kw["n_windows"])])


def mesh_and_distributed(torch, np, dp_cuda, dp_screen, gs, scorer, device,
                         tmp: Path) -> dict:
    """Phase 16: the window split against the one-device screen, golden
    configs 3, 5s and 4 through ``run(mesh=)``, two ``--distributed``
    processes, and config 3's screen at 1, 2 and 4 spans.  Returns the
    mesh goldens' launches by kernel."""
    import functools

    from calitas_tpu_torch import cli, goldens
    from calitas_tpu_torch.core.sequence import revcomp
    from calitas_tpu_torch.io.fasta import IndexedFasta, ReferenceSetBuilder
    from calitas_tpu_torch.parallel.mesh import make_mesh
    from calitas_tpu_torch.parallel.multihost import merge_host_outputs
    from calitas_tpu_torch.tools import search_reference

    n_cards = torch.cuda.device_count()
    log(f"[mesh] visible CUDA devices: {n_cards}")
    raw, protos = phase3_genome(np)
    q = GUIDE[:20]
    rng = np.random.default_rng(16)
    dqs = [(p, revcomp(p)) for p in
           [q, protos[24][:20], *("".join("ACGT"[i] for i in rng.integers(0, 4, 20))
                                  for _ in range(2))]]
    ms = 60 * 20 - 5 * 122
    pam = (("nrg",), 1, 3)
    one = gs.GenomeScreen(scorer, device, window=1000)
    g1 = one.stage(raw)
    want = {
        "dual": resolve_all(np, one.screen_contig_async(
            g1, CONTIG, DEFAULT_STEP, q, revcomp(q), ms, pam_spec=pam)),
        "multi": resolve_all(np, one.screen_contig_multi_async(
            g1, CONTIG, DEFAULT_STEP, dqs, [ms] * 4, pam_spec=pam)),
    }
    del g1
    n = len(one.window_starts(CONTIG, DEFAULT_STEP))
    segments = one.segment_spans(n)
    meshes = [(device,) * 2, (device,) * 4] + ([make_mesh()] if n_cards > 1 else [])
    for mesh in meshes:
        sh = gs.ShardedGenomeScreen(scorer, mesh, window=1000)
        gm = sh.stage(raw)
        spans = sum(len(gs.mesh_spans(len(mesh), i0, n_seg)) for i0, n_seg in segments)
        dp_cuda.reset_launches()
        got = {
            "dual": resolve_all(np, sh.screen_contig_async(
                gm, CONTIG, DEFAULT_STEP, q, revcomp(q), ms, pam_spec=pam)),
            "multi": resolve_all(np, sh.screen_contig_multi_async(
                gm, CONTIG, DEFAULT_STEP, dqs, [ms] * 4, pam_spec=pam)),
        }
        same = {k: all(np.array_equal(a, b) for a, b in zip(got[k], want[k])) for k in got}
        launches = {k: dp_cuda.launches[f"screen_{k}"] for k in got}
        log(f"[mesh] {len(mesh)} spans on {sorted({str(d) for d in mesh})}, "
            f"{CONTIG:,} bases, Q 20, "
            f"gate on: flags and ranges == one device: {same}; launches {launches} "
            f"({spans} spans over {len(segments)} segments); "
            f"{int(got['dual'][0].any(axis=0).sum())} dual candidates")
        if not all(same.values()) or launches != {"dual": spans, "multi": spans}:
            raise AssertionError(f"mesh of {len(mesh)}: identical {same}, launches {launches}")
        del gm

    # Golden configs through run(mesh=): two spans on one card (and config
    # 3 over every visible device when there are several).
    run_orig = search_reference.run
    mesh_launches = {"screen_dual": 0, "screen_multi": 0}
    runs = [(make_mesh(devices=[device] * 2), c) for c in ("3", "5s", "4")]
    if n_cards > 1:
        runs.append((make_mesh(), "3"))
    for mesh, config in runs:
        argv_of = {"3": goldens.config3, "5s": goldens.config5s, "4": goldens.config4}[config]
        out = tmp / f"mesh_config{config}.txt"
        argv = [*argv_of(tmp), "-o", str(out), "--engine", "gpu"]
        dp_cuda.reset_launches()
        dp_screen.reference_calls["cuda"] = 0
        search_reference.run = functools.partial(run_orig, mesh=mesh)
        try:
            e2e = run_cli(torch, cli, argv)
        finally:
            search_reference.run = run_orig
        launches = dict(dp_cuda.launches)
        plain = dp_screen.reference_calls["cuda"]
        got = norm_rows(out.read_text())
        assert_same_table(got, golden_rows(config), f"config{config} on a mesh differs")
        ref = IndexedFasta(argv[argv.index("-r") + 1])
        n_c = len(one.window_starts(ref.sequence_length("chr21"), DEFAULT_STEP))
        want_spans = sum(len(gs.mesh_spans(len(mesh), i0, n_seg))
                         for i0, n_seg in one.segment_spans(n_c))
        log(f"[mesh] config{config} through run(mesh={[str(d) for d in mesh]}): table == golden "
            f"({len(got) - 1} rows); launches dual {launches['screen_dual']} multi "
            f"{launches['screen_multi']} (grid spans {want_spans}); plain versions on the "
            f"card {plain}; end to end {e2e:.3f} s")
        grid = "screen_multi" if config == "5s" else "screen_dual"
        if launches[grid] != want_spans or plain != 0:
            raise AssertionError(f"config{config} on a mesh: launches {launches}, plain {plain}")
        if config == "4" and (launches["screen_multi"] < 2
                              or launches["screen_multi"] % len(mesh)):
            raise AssertionError(f"config4's slot batches did not split: {launches}")
        for k in mesh_launches:
            mesh_launches[k] += launches[k]

    # Two --distributed processes on a 3-contig genome.
    b = ReferenceSetBuilder(assembly="dist")
    for i, n_c in enumerate((3_000_000, 2_000_000, 1_500_000)):
        b.add(f"chr{i + 1}").add(goldens.synth_genome(n_c, 160 + i))
    ref = b.to_file(tmp / "dist.fa")
    single = tmp / "dist_single.txt"
    search_reference.run(guide=GUIDE, guide_id="g", ref=ref, output=single, engine="gpu",
                         device=device)
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "calitas_tpu_torch", "SearchReference", "-i", GUIDE, "-I",
           "g", "-r", str(ref), "--engine", "gpu", "--device", str(device), "--distributed"]
    procs, shards = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            shards.append(tmp / f"dist_shard{rank}.txt")
            env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=str(rank))
            procs.append(subprocess.Popen(cmd + ["-o", str(shards[-1])], cwd=ROOT, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for p in procs:
            _out, err = p.communicate(timeout=240)
            if p.returncode != 0:
                raise AssertionError(f"--distributed process exited {p.returncode}: "
                                     f"{err.decode()[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    merged = tmp / "dist_merged.txt"
    merge_host_outputs(shards, IndexedFasta(ref).dictionary, merged)
    assert_same_table(norm_rows(merged.read_text()), norm_rows(single.read_text()),
                      "--distributed shards' merge differs from the single run")
    shard_rows = [len(norm_rows(s.read_text())) - 1 for s in shards]
    log(f"[mesh] two --distributed processes (gloo, RANK 0/1, --engine gpu) on 6.5 Mb in 3 "
        f"contigs: merge == single run ({len(norm_rows(single.read_text())) - 1} rows; "
        f"shards {shard_rows} rows) in {time.perf_counter() - t0:.3f} s")
    span_timing(torch, np, dp_cuda, gs, scorer, device, raw, dqs)
    return mesh_launches


def span_timing(torch, np, dp_cuda, gs, scorer, device, raw, dqs) -> None:
    """Phase 16's times on this card: config 3's screen at 1, 2 and 4
    spans, and the dual kernel alone at config 3's grid and one 1 Gb
    segment's, split over 1, 2 and 4 streams."""
    from calitas_tpu_torch.core.sequence import encode_query, revcomp

    q = GUIDE[:20]
    ms = 60 * 20 - 5 * 122
    pam = (("nrg",), 1, 3)
    one = gs.GenomeScreen(scorer, device, window=1000)
    n = len(one.window_starts(CONTIG, DEFAULT_STEP))
    segments = one.segment_spans(n)

    # Config 3's screen (stage + annotate + kernel + readback) at 1, 2 and
    # 4 spans on this card, and the dual kernel alone at config 3's grid
    # and one 1 Gb segment's, split into 1, 2 and 4 streams.
    seg_n = segments[0][1]
    meshes = [(device,) * k for k in (1, 2, 4, 4, 2, 1)]
    if torch.cuda.device_count() > 1:
        from calitas_tpu_torch.parallel.mesh import make_mesh

        meshes += [make_mesh(), (device,), make_mesh()]
    for mesh in meshes:
        k = len(mesh)
        screen = one if k == 1 else gs.ShardedGenomeScreen(scorer, mesh, window=1000)
        best = {}
        for what in ("dual", "multi"):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g = screen.stage(raw)
                if what == "dual":
                    segs = screen.screen_contig_async(g, CONTIG, DEFAULT_STEP, q, revcomp(q),
                                                      ms, pam_spec=pam)
                else:
                    segs = screen.screen_contig_multi_async(g, CONTIG, DEFAULT_STEP, dqs,
                                                            [ms] * 4, pam_spec=pam)
                resolve_all(np, segs)
                times.append(time.perf_counter() - t0)
                del g
            best[what] = min(times)
        span_n = gs.mesh_spans(k, 0, seg_n)[0][2]
        log(f"[mesh] config3 screen only at {k} span(s) on "
            f"{sorted({str(d) for d in mesh})}: dual {best['dual']:.4f} s "
            f"(L={dp_cuda.screen_dual_default_lanes(20)}), multi G 4 {best['multi']:.4f} s "
            f"(L={dp_cuda.screen_multi_default_lanes(20, span_n, 4, True)} at {span_n} "
            f"windows per span of a {seg_n}-window segment); best of 3")
    qvals = np.stack([encode_query(q), encode_query(revcomp(q))]).astype(np.int32)
    annotated = gs.annotate_genome_pam(one.stage(raw), gs.encode_pam_spec(pam))
    big = gs.annotate_genome_pam(
        one.stage(synthetic_genome(np, 64_000_000, 8, [q])), gs.encode_pam_spec(pam))
    kw = dict(base0=0, step=DEFAULT_STEP, window=1000, min_score=ms, pam_gate=True,
              match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    for shape, g, n_w in (("config3", annotated, n), ("1 Gb segment", big, 64_512)):
        times = {}
        for k in (1, 2, 4, 4, 2, 1):
            t = span_kernel_ms(torch, dp_cuda, gs, g, qvals, dict(kw, n_windows=n_w), k)
            times[k] = min(times.get(k, t), t)
        log(f"[mesh] dual kernel at {shape}'s grid ({n_w} windows) on 1/2/4 streams of "
            f"{device}: " + ", ".join(f"{k} span(s) {t:.4f} ms" for k, t in sorted(times.items()))
            + " (each the lesser of two means of 20)")


ENTRY_SHAPE = (41_238, 1000)  # phase 9's shape (d): config 3's window count x window


def entry_rows(np, seed: int = 17) -> tuple:
    """Phase 17's batch at phase 9's shape (d), as host arrays: 41,238
    random ACGT rows of 1000 bases, lengths uniform 0..1000, with config
    3's protospacer planted at a random place in every 1,000th row (0-4
    random bases redrawn, length 1000).  Returns ``(qmask, tmasks,
    lengths)``."""
    from calitas_tpu_torch.core.sequence import encode_query

    rng = np.random.default_rng(seed)
    B, T = ENTRY_SHAPE
    acgt = np.array([1, 2, 4, 8], np.uint8)
    tmasks = acgt[rng.integers(0, 4, (B, T), dtype=np.uint8)]
    lengths = rng.integers(0, T + 1, B).astype(np.int32)
    qmask = encode_query(GUIDE[:20])
    for r in range(0, B, 1000):
        site = qmask.copy()
        site[rng.integers(0, 20, r // 1000 % 5)] = acgt[rng.integers(0, 4)]
        pos = int(rng.integers(0, T - 20))
        tmasks[r, pos : pos + 20] = site
        lengths[r] = T
    return qmask, tmasks, lengths


def entry_points(torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp: Path,
                 rows_d_ms: float | None = None) -> dict:
    """Phase 17: the port's entry points (``calitas_tpu_torch/graft_entry.py``)
    and mesh batch screen on the card: ``entry()``'s step against the
    plain version; ``screen_on_mesh`` at phase 9's shape (d) on 1, 2 and 4
    spans of this card (and over every visible card when there are
    several) against the plain version, with its wall and each span's
    kernel time (graph-timed), printed beside ``rows_d_ms`` (phase 9's
    (d)) when given; ``dryrun_multichip(2)`` and ``(4)`` as spans of this
    card (and over every visible card).  Each driven run starts with the
    counts at 0; returns their launches by kernel, summed."""
    from calitas_tpu_torch import graft_entry
    from calitas_tpu_torch.ops import probes
    from calitas_tpu_torch.parallel.mesh import make_mesh, screen_on_mesh

    sk = dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
              qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)
    total_launches = collections.Counter()

    def driven(what: str, fn):
        """``fn()`` with the counts at 0 just before it, read just after;
        no plain version may run on the card."""
        dp_cuda.reset_launches()
        dp_screen.reference_calls["cuda"] = 0
        out = fn()
        launches = dict(dp_cuda.launches)
        if dp_screen.reference_calls["cuda"]:
            raise AssertionError(f"{what}: a plain version ran on the card")
        total_launches.update(launches)
        return out, launches

    # entry(): the single-device step on the card against the plain version
    fn, args = graft_entry.entry()
    got, launches = driven("entry()", lambda: fn(*args))
    want = dp_screen._screen_scores(*args, **sk)
    if args[1].device != device or not torch.equal(got, want) or launches["screen_rows"] != 1:
        raise AssertionError(f"entry(): on {args[1].device}, equal "
                             f"{torch.equal(got, want)}, launches {launches}")
    log(f"[entry] entry() on {device}: {tuple(got.shape)} {got.dtype} best scores == plain "
        f"version (max_abs_err 0); screen_rows launches {launches['screen_rows']}")

    # screen_on_mesh at phase 9's shape (d), config 3's guide and min score
    qmask, tmasks, lengths = entry_rows(np)
    B, T = tmasks.shape
    ms = 60 * 20 - 5 * 122
    on_card = [torch.from_numpy(a).to(device) for a in (qmask, tmasks, lengths)]
    want = dp_screen._screen_scores(*on_card, **sk).cpu().numpy()
    want_total = int((want >= ms).sum())
    del on_card
    n_cards = torch.cuda.device_count()
    meshes = [(device,) * k for k in (1, 2, 4)] + ([make_mesh()] if n_cards > 1 else [])
    for mesh in meshes:
        k = len(mesh)
        spans = gs.mesh_spans(k, 0, B + (-B) % k)
        walls = []
        for _ in range(2):  # the first run also allocates the pinned upload buffers
            t0 = time.perf_counter()
            (best, total), launches = driven(f"screen_on_mesh over {k}", lambda: screen_on_mesh(
                mesh, scorer, qmask, tmasks, lengths, ms))
            walls.append(time.perf_counter() - t0)
            if not np.array_equal(best, want) or total != want_total \
                    or launches["screen_rows"] != len(spans):
                raise AssertionError(f"screen_on_mesh over {mesh}: equal "
                                     f"{np.array_equal(best, want)}, total {total} of "
                                     f"{want_total}, launches {launches}")
        span_ms, prepared = {}, []
        for e, r0, n in spans:
            with torch.cuda.device(mesh[e]):
                tm = torch.from_numpy(tmasks[r0 : r0 + n]).to(mesh[e])
                ln = torch.from_numpy(lengths[r0 : r0 + n]).to(mesh[e])

                def make(tm=tm, ln=ln):
                    return dp_cuda._screen_rows_launcher(qmask[None], tm, ln, **sk)

                span_ms[e] = launcher_times(probes, {e: make})[e]
                prepared.append((mesh[e], make()[0]))
        log(f"[entry] screen_on_mesh, {B:,} x {T} rows, Q 20, min score {ms}, over {k} "
            f"span(s) on {sorted({str(d) for d in mesh})}: best == plain version "
            f"(max_abs_err 0), total {total} == plain's {want_total}; screen_rows launches "
            f"{launches['screen_rows']} per run; wall {walls[0]:.4f} s, then {walls[1]:.4f} s "
            f"(upload, launches, readback); "
            f"each span's kernel alone " + ", ".join(
                f"{n:,} rows L={dp_cuda.screen_rows_default_lanes(20, n, False)} "
                f"{span_ms[e]:.5f} ms" for e, _r0, n in spans)
            + f"; all spans on their streams {spans_together_ms(torch, prepared):.5f} ms"
            + (f"; phase 9's (d) {rows_d_ms:.5f} ms" if rows_d_ms is not None else ""))

    # dryrun_multichip: spans of this card, and every visible card
    runs = [(n, [device] * n) for n in (2, 4)] + ([(n_cards, None)] if n_cards > 1 else [])
    hashes = set()
    for n, devices in runs:
        t0 = time.perf_counter()
        summary, launches = driven(f"dryrun_multichip({n})", lambda: graft_entry.dryrun_multichip(
            n, devices=devices))
        hashes.add(summary["hash"])
        log(f"[entry] dryrun_multichip({n}) on "
            f"{'every visible card' if devices is None else f'{n} spans of {device}'}: "
            f"passed in {time.perf_counter() - t0:.3f} s; flags {summary['flags']}, global hits "
            f"{summary['global_hits']}, table rows {summary['rows']} hash {summary['hash']}; "
            f"launches {launches}")
        if not all(launches[k] for k in ("screen_dual", "screen_multi", "screen_rows")):
            raise AssertionError(f"dryrun_multichip({n}) skipped a kernel: {launches}")
    if len(hashes) != 1:
        raise AssertionError(f"dryrun_multichip's tables differ across meshes: {hashes}")
    return {k: total_launches[k] for k in ("screen_dual", "screen_multi", "screen_rows")}


BENCH_G = 1_024_000_000  # the bench's default genome: 1024 Mb
BENCH_RAW, BENCH_KEPT = 75_328, 74_649  # its raw and kept hits (the JAX bench's counts)


def bench_at_1gb(torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp: Path,
                 peak: float | None = None) -> tuple:
    """Phase 18: the port's bench (``calitas_tpu_torch/bench.py``) at 1024
    Mb on this card.  The device generator must equal ``genome_codes``
    over the whole genome with a zero pad (one D2H copy); the run must
    find 75,328 raw and 74,649 kept hits, launch ``screen_dual`` once per
    segment per run and no plain version, and degrade nothing; its widest
    launch must equal the plain version.  The screen alone at 2 and 4
    spans of this card must equal one span's flags and ranges; with
    several cards visible, the run over all of them must give the
    one-card table byte for byte and launch ``pam_annotate`` once per card
    for each screen of the contig.  Prints the bench's JSON line and
    breakdown, the widest launch's kernel and plain times (and bound, given
    the int32 rate ``peak``), and the span and card times.  Returns the
    driven runs' ``screen_dual`` launches and the comparison's
    max_abs_err."""
    from calitas_tpu_torch import bench
    from calitas_tpu_torch.align.engine import SequentialAligner
    from calitas_tpu_torch.core.guide import Guide
    from calitas_tpu_torch.ops import probes
    from calitas_tpu_torch.parallel import host_pool
    from calitas_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    fasta, bases = bench.make_genome(str(tmp), BENCH_G)
    log(f"[bench] {BENCH_G:,}-base genome, FASTA and .fai written in "
        f"{time.perf_counter() - t0:.3f} s")

    # The device generator against the host stream, over every position.
    t0 = time.perf_counter()
    padded = gs.staged_length(BENCH_G, bench.WINDOW)
    host = bench.device_genome_masks(padded, BENCH_G, device).cpu().numpy()
    lut = np.zeros(256, dtype=np.uint8)
    lut[np.frombuffer(b"ACGT", dtype=np.uint8)] = (1, 2, 4, 8)
    chunk = 1 << 26
    same = all(np.array_equal(host[o : min(o + chunk, BENCH_G)], lut[bases[o : o + chunk]])
               for o in range(0, BENCH_G, chunk))
    pad_zero = not host[BENCH_G:].any()
    log(f"[bench] device generator over {padded:,} positions == genome_codes: {same}; "
        f"pad of {padded - BENCH_G:,} zero: {pad_zero} "
        f"({time.perf_counter() - t0:.3f} s)")
    if not (same and pad_zero):
        raise AssertionError("the device genome differs from the host stream")
    del host, bases

    # The bench's own process starts with no finish pool: the larger pool
    # of the earlier phases (it only grows) would run its finish on 8
    # workers, not the bench's 4.
    if host_pool._SHARED_POOL is not None:
        host_pool._SHARED_POOL.shutdown(wait=True)
        host_pool._SHARED_POOL = None

    # The bench, driven with the counts at 0; the widest launch's inputs kept.
    widest = {}
    wrapper = dp_cuda.screen_dual

    def recording(genome, qvals, **kw):
        if not widest or kw["n_windows"] > widest["kw"]["n_windows"]:
            widest.update(numel=genome.numel(), qvals=qvals.copy(), kw=dict(kw))
        return wrapper(genome, qvals, **kw)

    dp_cuda.screen_dual = recording
    try:
        dp_cuda.reset_launches()
        dp_screen.reference_calls["cuda"] = 0
        res = bench.search_bench(fasta, BENCH_G, device=device)
        launches = dp_cuda.launches["screen_dual"]
        plain = dp_screen.reference_calls["cuda"]
    finally:
        dp_cuda.screen_dual = wrapper
    log(json.dumps(bench.metric_line(res)))
    log(bench.breakdown(res))
    log(f"# card: {bench.card_names()}")
    runs = len(res["e2e_runs"]) + 1  # the warm run too
    log(f"[bench] raw {res['raw_hits']} kept {res['kept']}; screen_dual launches "
        f"{res['launches']} per run, {launches} in all ({runs} runs and the screen alone "
        f"over {res['segments']} segments); plain version on the card {plain}")
    if (res["raw_hits"], res["kept"]) != (BENCH_RAW, BENCH_KEPT):
        raise AssertionError(f"bench hits {res['raw_hits']}/{res['kept']}, want "
                             f"{BENCH_RAW}/{BENCH_KEPT}")
    if res["launches"] != res["segments"] or launches != (runs + 1) * res["segments"] or plain:
        raise AssertionError(f"bench launches {res['launches']} per run, {launches} in all, "
                             f"segments {res['segments']}, plain {plain}")

    # The widest launch against the plain version, on the same inputs.
    guide = Guide.parse(bench.GUIDE)
    masks = bench.device_genome_masks(padded, BENCH_G, device)
    genome = gs.annotate_genome_pam(masks, gs.encode_pam_spec(bench.pam_spec(guide)))
    qvals, kw = widest["qvals"], widest["kw"]
    if genome.numel() != widest["numel"]:
        raise AssertionError(f"widest launch on {widest['numel']} bytes, not {genome.numel()}")
    got = dp_cuda.screen_dual(genome, qvals, **kw)
    want = dp_screen.screen_dual_reference(genome, qvals, **kw)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, want))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("screen_dual != plain at the bench's widest launch")
    kernel_ms = cuda_time_ms(torch, lambda: dp_cuda.screen_dual(genome, qvals, **kw), 20)
    plain_ms = cuda_time_ms(torch, lambda: dp_screen.screen_dual_reference(
        genome, qvals, **kw), 1)
    bound = ""
    if peak is not None:
        b_ms, b_by = probes.bound_ms(*probes.grid_work(
            genome.numel(), kw["base0"], kw["step"], kw["n_windows"], kw["window"],
            qvals.shape[-1]), peak)
        bound = f"; bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / kernel_ms:.2f} % of the bound"
    log(f"[bench] widest launch (base0 {kw['base0']}, {kw['n_windows']} windows, genome "
        f"{genome.numel():,} bytes, L={dp_cuda.screen_dual_default_lanes(qvals.shape[-1])}): "
        f"== plain, max_abs_err {err}; kernel {kernel_ms:.4f} ms, plain {plain_ms:.2f} ms{bound}")
    del genome, got, want

    # The screen alone at 1, 2 and 4 spans of this card, in turns.
    ms = SequentialAligner().min_guide_score(guide, bench.ALIGN_KWARGS["max_guide_diffs"])
    screens = {n: gs.GenomeScreen(scorer, device, window=bench.WINDOW) if n == 1 else
               gs.ShardedGenomeScreen(scorer, (device,) * n, window=bench.WINDOW)
               for n in (1, 2, 4)}
    segments = screens[1].segment_spans(len(screens[1].window_starts(BENCH_G, bench.STEP)))

    def span_launches(n: int) -> int:
        """One launch per span of every segment, split over n mesh entries."""
        return sum(len(gs.mesh_spans(n, i0, k)) for i0, k in segments)

    best = {n: float("inf") for n in screens}
    one = None
    for _ in range(3):
        for n, screen in screens.items():
            dp_cuda.reset_launches()
            secs, flags, ranges = bench.screen_only(screen, masks, BENCH_G, guide, ms)
            best[n] = min(best[n], secs)
            if dp_cuda.launches["screen_dual"] != span_launches(n):
                raise AssertionError(f"{n} spans: {dp_cuda.launches['screen_dual']} launches")
            if one is None:
                one = (flags, ranges)
            elif not (np.array_equal(flags, one[0]) and np.array_equal(ranges, one[1])):
                raise AssertionError(f"the screen at {n} spans differs from one span's")
    log("[bench] screen alone (annotate + launches + readbacks), best of 3, flags and ranges "
        "equal to one span's: " + ", ".join(
            f"{n} span{'s' * (n > 1)} {best[n]:.6f} s" for n in best))
    del masks, screens

    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        dp_cuda.reset_launches()
        dp_screen.reference_calls["cuda"] = 0
        res_k = bench.search_bench(fasta, BENCH_G, mesh=make_mesh())
        mesh_launches = dp_cuda.launches["screen_dual"]
        launches += mesh_launches
        log(f"[bench] over {n_cards} cards: " + bench.breakdown(res_k))
        if res_k["body"] != res["body"] or dp_screen.reference_calls["cuda"]:
            raise AssertionError(f"the table over {n_cards} cards differs from one card's")
        if res_k["launches"] != span_launches(n_cards):
            raise AssertionError(f"{n_cards} cards: {res_k['launches']} launches per run")
        # the warm run, the timed runs and the screen alone each annotate
        # the one contig once on every card's replica
        want = (len(res_k["e2e_runs"]) + 2) * n_cards
        if dp_cuda.launches["pam_annotate"] != want:
            raise AssertionError(f"{n_cards} cards: pam_annotate launched "
                                 f"{dp_cuda.launches['pam_annotate']} times, want {want}")
        log(f"[bench] {n_cards} cards: table == one card's ({res_k['kept']} rows); e2e best "
            f"{res_k['e2e_best']:.6f} s against {res['e2e_best']:.6f} s, screen alone "
            f"{res_k['screen']:.6f} s against {res['screen']:.6f} s; pam_annotate launches "
            f"{want}, one per card per screen")
    os.remove(fasta)
    return launches, err


#: phase 19's genome: the contigs of the benchmark's GRCh38 configuration
GRCH38_CONFIG = ROOT / "perfbench" / "configs" / "grch38.json"
#: the benchmark cells' PAM specs (dp-orientation PAMs, max_mm, max_gap):
#: SpCas9's NRG and AsCas12a's TTTV at -p 1 -g 3
CELL_PAMS = {"nrg": (("nrg",), 1, 3), "tttv": (("tttv",), 1, 3)}
HBM_BYTES_PER_S = 3.35e12  # the H100's device memory (NVIDIA's data sheet)
PAM_SHAPE = 1 << 28  # every contig over 134 Mb of GRCh38 and GRCm39 stages to this


def grch38_reference(np, tmp: Path) -> Path:
    """A FASTA (60-base lines, .fai, .dict) at GRCh38's contig lengths:
    seeded ACGT with mutated sites of ``GUIDE``'s protospacer planted."""
    import hashlib

    from calitas_tpu_torch.io.fasta import DictEntry, SequenceDictionary, build_fai, dict_path_for

    contigs = json.loads(GRCH38_CONFIG.read_text())["contigs"]
    ref = tmp / "grch38.fa"
    entries = []
    with open(ref, "wb") as fa:
        for k, (name, n) in enumerate(contigs):
            bases = synthetic_genome(np, n, 1900 + k, [GUIDE[:20]])
            fasta_record(np, fa, name, bases)
            entries.append(DictEntry(name=name, length=n, assembly="grch38",
                                     md5=hashlib.md5(bases.tobytes()).hexdigest()))
    build_fai(ref)
    SequenceDictionary(entries).write(dict_path_for(ref))
    return ref


def annotation_times(torch, dp_cuda, gs, genome, spec, reps: int) -> tuple:
    """(kernel ms, plain ms) of one annotation of ``genome``; raises
    unless the two outputs are equal byte for byte."""
    got = dp_cuda.pam_annotate(genome, spec)
    want = gs.annotate_genome_pam_reference(genome, spec)
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"pam_annotate differs from the plain version at {bad} "
                             f"(length {genome.numel()}, spec {spec})")
    del got, want
    return (cuda_time_ms(torch, lambda: dp_cuda.pam_annotate(genome, spec), reps),
            cuda_time_ms(torch, lambda: gs.annotate_genome_pam_reference(genome, spec), 2))


def pam_annotation(torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp: Path) -> dict:
    """Phase 19: the PAM annotation kernel (``csrc/pam_annotate.cu``)
    against its plain version.  At 2^28 positions, each benchmark cell's
    spec: equal byte for byte, both timed, against the bytes bound (the
    array read once and written once at 3.35 TB/s).  Then a resident
    searcher on a genome at GRCh38's 25 contig lengths: one SpCas9 request
    (-d 3 -p 1 -g 3) with the route forced to the plain version and one
    through the kernel, each after ``reset_peak_memory_stats``: the same
    table, the kernel launched once per contig and the plain route never,
    and each request's peak device memory; then every staged contig
    annotated both ways, equal byte for byte, with the summed times and
    bound.  Returns the kernel's launches, the 2^28 NRG times and bound."""
    from calitas_tpu_torch.serve import ResidentSearcher

    shape_ms = {}
    gen = torch.Generator(device=device).manual_seed(19)
    codes = torch.randint(0, 5, (PAM_SHAPE,), device=device, dtype=torch.uint8, generator=gen)
    genome = torch.ones_like(codes) << codes.clamp_(max=3)  # A C G T, a fifth T
    genome[:: 997] = 0  # some N
    del codes
    bound_ms = 2 * PAM_SHAPE / HBM_BYTES_PER_S * 1e3
    for name, spec in CELL_PAMS.items():
        ms, plain = annotation_times(torch, dp_cuda, gs, genome, gs.encode_pam_spec(spec), 20)
        shape_ms[name] = (ms, plain)
        log(f"[pam] 2^28 positions, {name} {spec}: kernel {ms:.4f} ms, plain {plain:.3f} ms; "
            f"bound {bound_ms:.4f} ms (bytes): {100 * bound_ms / ms:.2f} % of the bound")
    del genome

    t0 = time.perf_counter()
    ref = grch38_reference(np, tmp)
    log(f"[pam] GRCh38-length reference written in {time.perf_counter() - t0:.1f} s")
    searcher = ResidentSearcher(ref, engine="gpu", device=str(device), window_size=1000)
    limits = dict(max_guide_diffs=3, max_pam_mismatches=1, max_gaps_between_guide_and_pam=3)
    searcher.search(guide=GUIDE, guide_id="warm", output=str(tmp / "warm.txt"), **limits)
    kernel_rule = dp_cuda.annotates_on_kernel
    peaks, launches, tables = {}, {}, {}
    for route in ("plain", "kernel", "plain", "kernel"):
        if route == "plain":
            dp_cuda.annotates_on_kernel = lambda _spec, _device: False
        try:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            dp_cuda.reset_launches()
            out = tmp / f"grch38_{route}.txt"
            searcher.search(guide=GUIDE, guide_id="g", output=str(out), **limits)
            torch.cuda.synchronize(device)
        finally:
            dp_cuda.annotates_on_kernel = kernel_rule
        peaks.setdefault(route, []).append(torch.cuda.max_memory_allocated(device))
        launches.setdefault(route, []).append(dp_cuda.launches["pam_annotate"])
        tables.setdefault(route, []).append(table_digest(out))
    n_contigs = len(searcher._staged)
    rows = tables["kernel"][0][0]
    log(f"[pam] one GRCh38 request (-d 3 -p 1 -g 3), peak device memory: plain route "
        f"{peaks['plain']} bytes, kernel {peaks['kernel']} bytes; pam_annotate launches "
        f"{launches['plain']} / {launches['kernel']} ({n_contigs} contigs); table rows {rows}")
    if len(set(tables["plain"] + tables["kernel"])) != 1:  # time stamps blanked
        raise AssertionError("the plain and kernel routes gave different tables")
    if launches["plain"] != [0, 0] or launches["kernel"] != [n_contigs] * 2:
        raise AssertionError(f"pam_annotate launches {launches}, want 0 and {n_contigs}")

    spec = gs.encode_pam_spec(CELL_PAMS["nrg"])
    total_ms = total_plain = 0.0
    staged_bytes = 0
    for name, g in searcher._staged.items():
        ms, plain = annotation_times(torch, dp_cuda, gs, g, spec, 5)
        total_ms += ms
        total_plain += plain
        staged_bytes += g.numel()
    set_bound = 2 * staged_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[pam] GRCh38's {n_contigs} staged contigs ({staged_bytes} bytes), nrg: equal byte for "
        f"byte; kernel {total_ms:.4f} ms, plain {total_plain:.2f} ms, bound {set_bound:.4f} ms "
        f"(bytes): {100 * set_bound / total_ms:.2f} % of the bound")
    del searcher
    return {"launches": sum(launches["kernel"]), "ms": shape_ms["nrg"][0],
            "plain_ms": shape_ms["nrg"][1], "bound_ms": bound_ms}


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

    from calitas_tpu_torch import native, utils
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
    lib = dp_cuda.build_all(["screen_dual"])["screen_dual"]
    dual_regs = lane_ptxas(lib.with_name(lib.name + ".log"))
    log("[build] screen_dual registers (Q/L): " + ", ".join(
        f"{q}/{L} {r}" for (q, L), (r, _sp) in sorted(dual_regs.items())
        if q in (1, 20, 21, 47, 48)))
    spilled = {key: sp for key, (_r, sp) in dual_regs.items() if sp}
    built = sum(L <= q for L in dp_cuda.DUAL_LANES for q in range(1, dp_cuda.Q_MAX + 1))
    if len(dual_regs) != built or spilled:
        raise AssertionError(f"screen_dual: {len(dual_regs)} instantiations, spills {spilled}")
    lib = dp_cuda.build_all(["screen_multi"])["screen_multi"]
    multi_regs = lane_ptxas(lib.with_name(lib.name + ".log"), "screen_multi_kernel")
    log("[build] screen_multi registers (Q/L): " + ", ".join(
        f"{q}/{L} {r}" for (q, L), (r, _sp) in sorted(multi_regs.items())
        if q in (1, 2, 4, 20, 21, 47, 48)))
    spilled = {key: sp for key, (_r, sp) in multi_regs.items() if sp}
    built = sum(L <= q for L in dp_cuda.MULTI_LANES for q in range(1, dp_cuda.Q_MAX + 1))
    if len(multi_regs) != built or spilled:
        raise AssertionError(f"screen_multi: {len(multi_regs)} instantiations, spills {spilled}")
    lib = dp_cuda.build_all(["screen_rows"])["screen_rows"]
    rows_regs = lane_ptxas(lib.with_name(lib.name + ".log"), "screen_rows_kernel")
    log("[build] screen_rows registers (Q/L/per-row): " + ", ".join(
        f"{q}/{L}/{int(pr)} {r}" for (q, L, pr), (r, _sp) in sorted(rows_regs.items())
        if q in (1, 2, 4, 20, 21, 47, 48)))
    spilled = {key: sp for key, (_r, sp) in rows_regs.items() if sp}
    built = sum(len(dp_cuda.rows_lanes(q, per_row)) for per_row in (False, True)
                for q in range(1, dp_cuda.Q_MAX + 1))
    if len(rows_regs) != built or spilled:
        raise AssertionError(f"screen_rows: {len(rows_regs)} instantiations, spills {spilled}")

    phase_s = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)

            # 3. Kernel vs plain, on the card
            t0 = time.perf_counter()
            scorer = derive_scorer()
            max_err, kernel_ms, plain_ms, genome, main_kw = kernel_vs_plain(
                torch, np, dp_cuda, dp_screen, gs, scorer, device
            )
            dual_n = main_kw[1]["n_windows"]
            dual_lanes(torch, np, dp_cuda, dp_screen, gs, scorer, genome, main_kw, dual_regs)
            for L, c in lane_sass(dp_cuda).items():
                log(f"[lanes] SASS of screen_dual_kernel<20, {L}>: {c['total']} instructions; "
                    f"steady loop {c['loop']} with {c['loop_VIADDMNMX']} VIADDMNMX, "
                    f"{c['per_cell_chain']:.2f} per cell and chain; {c['loop_top']}")
            phase_s["3 dual vs plain"] = time.perf_counter() - t0
            no_degradation(utils, "3 dual vs plain")

            # 4. Main path at chr21 scale
            t0 = time.perf_counter()
            dual_launches = main_path(torch, dp_cuda, dp_screen, gs, scorer, device, tmp)
            phase_s["4 config3"] = time.perf_counter() - t0
            no_degradation(utils, "4 config3")

            # 5. Multi-guide kernel vs plain, on the card
            t0 = time.perf_counter()
            screen = gs.GenomeScreen(scorer, device, window=1000)
            multi_err, multi_ms, multi_plain_ms = multi_vs_plain(
                torch, np, dp_cuda, dp_screen, gs, scorer, genome, screen
            )
            multi_err = max(multi_err, multi_lanes_vs_plain(
                torch, np, dp_cuda, dp_screen, scorer, genome))
            multi_shape_rows = multi_lane_times(
                torch, np, dp_cuda, probes, scorer, genome, multi_regs)
            for L, c in lane_sass(dp_cuda, "screen_multi").items():
                log(f"[multi lanes] SASS of screen_multi_kernel<20, {L}>: {c['total']} "
                    f"instructions; steady loop {c['loop']} with {c['loop_VIADDMNMX']} "
                    f"VIADDMNMX, {c['per_cell_chain']:.2f} per cell and chain; {c['loop_top']}")
            del genome
            phase_s["5 multi vs plain"] = time.perf_counter() - t0
            no_degradation(utils, "5 multi vs plain")

            # 6-8. The multi-guide kernel's paths
            t0 = time.perf_counter()
            multi_launches = config5s(torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp)
            phase_s["6 config5s"] = time.perf_counter() - t0
            no_degradation(utils, "6 config5s")
            t0 = time.perf_counter()
            multi_launches += config4(torch, dp_cuda, dp_screen, tmp)
            phase_s["7 config4"] = time.perf_counter() - t0
            no_degradation(utils, "7 config4")
            t0 = time.perf_counter()
            variants_at_scale(torch, np, dp_cuda, tmp)
            phase_s["8 variants at scale"] = time.perf_counter() - t0
            no_degradation(utils, "8 variants at scale")

            # 9-12. The row kernel and its paths, and the long-guide route
            t0 = time.perf_counter()
            rows_err = max(rows_vs_plain(torch, np, dp_cuda, dp_screen, scorer, device),
                           rows_lanes_vs_plain(torch, np, dp_cuda, dp_screen, scorer, device))
            row_shape_rows = row_lane_times(torch, np, dp_cuda, probes, dp_screen, scorer,
                                            device, rows_regs)
            for L, c in lane_sass(dp_cuda, "screen_rows", ROWS_Q, "Lb1E").items():
                log(f"[row lanes] SASS of screen_rows_kernel<{ROWS_Q}, {L}, true>: "
                    f"{c['total']} instructions; steady loop {c['loop']} with "
                    f"{c['loop_VIADDMNMX']} VIADDMNMX, {c['per_cell_chain']:.2f} per cell and "
                    f"chain; {c['loop_top']}")
            phase_s["9 rows vs plain"] = time.perf_counter() - t0
            no_degradation(utils, "9 rows vs plain")
            t0 = time.perf_counter()
            rows_launches = goldens_1_2(torch, dp_cuda, dp_screen, tmp)
            phase_s["10 configs 1-2"] = time.perf_counter() - t0
            no_degradation(utils, "10 configs 1-2")
            t0 = time.perf_counter()
            rows_launches += list_tools_at_scale(torch, np, dp_cuda, dp_screen, tmp)
            phase_s["11 list tools at scale"] = time.perf_counter() - t0
            no_degradation(utils, "11 list tools at scale")
            t0 = time.perf_counter()
            long_guide(torch, dp_cuda, dp_screen, tmp)
            phase_s["12 long guide"] = time.perf_counter() - t0
            no_degradation(utils, "12 long guide")

            # 13. The roofline probes and every kernel's bound
            t0 = time.perf_counter()
            probe_err, probe_ms, roof, probe_launches = probes_and_roofline(
                torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp)
            phase_s["13 probes and roofline"] = time.perf_counter() - t0
            no_degradation(utils, "13 probes and roofline")

            # 14. Resident serving at 1 Gb
            t0 = time.perf_counter()
            serve_launches, serve_errs = resident_serving(torch, np, dp_cuda, dp_screen, gs,
                                                          scorer, device, tmp)
            dual_launches += serve_launches["screen_dual"]
            multi_launches += serve_launches["screen_multi"]
            max_err = max(max_err, serve_errs["screen_dual"])
            multi_err = max(multi_err, serve_errs["screen_multi"])
            phase_s["14 resident serving"] = time.perf_counter() - t0
            no_degradation(utils, "14 resident serving")

            # 15. Device faults on the card: degraded and counted, or propagated
            t0 = time.perf_counter()
            faults_on_the_card(torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp)
            phase_s["15 faults"] = time.perf_counter() - t0

            # 16. The window split over a mesh, and --distributed
            t0 = time.perf_counter()
            mesh_launches = mesh_and_distributed(torch, np, dp_cuda, dp_screen, gs, scorer,
                                                 device, tmp)
            dual_launches += mesh_launches["screen_dual"]
            multi_launches += mesh_launches["screen_multi"]
            phase_s["16 mesh and distributed"] = time.perf_counter() - t0
            no_degradation(utils, "16 mesh and distributed")

            # 17. The entry points and the mesh batch screen
            t0 = time.perf_counter()
            d_row = row_shape_rows[ROW_ENTRY]
            entry_launches = entry_points(torch, np, dp_cuda, dp_screen, gs, scorer, device,
                                          tmp, rows_d_ms=d_row[d_row["launcher"]])
            dual_launches += entry_launches["screen_dual"]
            multi_launches += entry_launches["screen_multi"]
            rows_launches += entry_launches["screen_rows"]
            phase_s["17 entry points"] = time.perf_counter() - t0
            no_degradation(utils, "17 entry points")

            # 18. The port's bench at 1 Gb
            t0 = time.perf_counter()
            bench_launches, bench_err = bench_at_1gb(torch, np, dp_cuda, dp_screen, gs, scorer,
                                                     device, tmp, peak=roof["bound_ops_per_s"])
            dual_launches += bench_launches
            max_err = max(max_err, bench_err)
            phase_s["18 bench at 1 Gb"] = time.perf_counter() - t0
            no_degradation(utils, "18 bench at 1 Gb")

            # 19. The PAM annotation kernel
            t0 = time.perf_counter()
            pam = pam_annotation(torch, np, dp_cuda, dp_screen, gs, scorer, device, tmp)
            phase_s["19 PAM annotation"] = time.perf_counter() - t0
            no_degradation(utils, "19 PAM annotation")
    finally:
        stop_processes(host_pool)

    # Each timed call's bound, from its own inputs.
    peak = roof["bound_ops_per_s"]
    T, N, Q = 1024, 32_768, 20
    work = {
        "screen_dual": probes.grid_work(CONTIG, 0, DEFAULT_STEP, dual_n, 1000, 20),
        "screen_multi": probes.grid_work(CONTIG, 0, DEFAULT_STEP, dual_n, 1000, 20,
                                         guides=4),
        # the list tools' mode at (a): a query per row, both chains, ranges on
        "screen_rows": row_shape_rows[ROW_MAIN]["work"],
        "ceiling_probe": probes.probe_work("ceiling_probe", T, N, Q),
        "peak_probe": probes.probe_work("peak_probe", T, N, Q),
    }
    timed = {
        "screen_dual": (kernel_ms, plain_ms),
        "screen_multi": (multi_ms[4], multi_plain_ms),
        "screen_rows": (row_shape_rows[ROW_MAIN][row_shape_rows[ROW_MAIN]["launcher"]],
                        row_shape_rows[ROW_MAIN]["plain"]),
        **probe_ms,
    }
    bounds = {name: probes.bound_ms(ops, nbytes, peak) for name, (ops, nbytes) in work.items()}
    timed["pam_annotate"] = (pam["ms"], pam["plain_ms"])
    bounds["pam_annotate"] = (pam["bound_ms"], "bytes")
    for name, (b_ms, b_by) in bounds.items():
        log(f"[bounds] {name}: {timed[name][0]:.4f} ms against a bound of {b_ms:.4f} ms "
            f"({b_by}): {100 * b_ms / timed[name][0]:.2f} % of the bound")

    for kernel, shape_rows in (("screen_multi", multi_shape_rows),
                               ("screen_rows", row_shape_rows)):
        for label, row in shape_rows.items():
            b_ms, b_by = probes.bound_ms(*row["work"], peak)
            L = row["launcher"]
            log(f"[bounds] {kernel} {label}: launcher L={L} {row[L]:.5f} ms against a bound "
                f"of {b_ms:.5f} ms ({b_by}): {100 * b_ms / row[L]:.2f} % of the bound")

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
        # jnp ops in the JAX package, no Pallas kernel
        ("pam_annotate", "pam_annotate.cu", "calitas_tpu/ops/genome_screen.py::annotate_genome_pam",
         pam["launches"], 0),
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
        "library_ms": None,  # no single PyTorch call computes a DP screen, probe or PAM gate
    } for name, source, replaces, launches, err in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phases_alone(names: list) -> int:
    """``python3 chip_smoke.py --only 13 15 16 17 18 19``: the build, then
    the named phases of 13 (the probes and the roofline), 15 (faults), 16
    (mesh and ``--distributed``), 17 (entry points), 18 (the bench at 1
    Gb) and 19 (the PAM annotation) alone, with their checks; phases 16, 17 and 18 also split over
    every visible card when there are several (four cards).  Prints no
    kernels line."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: a CUDA device is required", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from calitas_tpu_torch import utils
    from calitas_tpu_torch.core.scoring import derive_scorer
    from calitas_tpu_torch.device import resolve_device
    from calitas_tpu_torch.ops import dp_cuda, dp_screen
    from calitas_tpu_torch.ops import genome_screen as gs
    from calitas_tpu_torch.parallel import host_pool

    device = resolve_device("cuda")
    log(f"[device] {torch.cuda.device_count()} x {torch.cuda.get_device_name(device)} | "
        f"nvidia-smi: {nvidia_smi()}")
    t0 = time.perf_counter()
    dp_cuda.build_all(tuple(dp_cuda.SOURCES))
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    phases = {"13": probes_and_roofline, "15": faults_on_the_card, "16": mesh_and_distributed,
              "17": entry_points, "18": bench_at_1gb, "19": pam_annotation}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name in names:
                t0 = time.perf_counter()
                utils.reset_degraded()
                phases[name](torch, np, dp_cuda, dp_screen, gs, derive_scorer(), device,
                             Path(tmp))
                if name != "15":
                    no_degradation(utils, name)
                log(f"[phase {name}] passed in {time.perf_counter() - t0:.1f} s")
    finally:
        stop_processes(host_pool)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--only"]:
        sys.exit(phases_alone(sys.argv[2:]))
    sys.exit(main())
