"""Entry points of the port: the counterpart of the root
``__graft_entry__.py``.

``entry()`` returns the single-device forward step on the flagship
computation (the batched glocal-DP row screen that powers
SearchReference) and its example arguments on the card.

``dryrun_multichip(n)`` builds an n-entry mesh (``parallel/mesh.py``)
and runs the reference's four checks on it: (a) the sharded genome
screen, segmented and one-shot, (a2) the same screen PAM-gated with
ranges, (b) the mesh batch screen with its global hit count, and (c) the
whole SearchReference tool, reference and variant passes, on the mesh
against one device.  Both run on the card unless the caller asks for the
CPU; a kernel that does not build or launch raises ``KernelError``.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from calitas_tpu_torch.core.scoring import derive_scorer
from calitas_tpu_torch.core.sequence import encode_query, encode_target, revcomp
from calitas_tpu_torch.device import resolve_device
from calitas_tpu_torch.io.fasta import ReferenceSetBuilder
from calitas_tpu_torch.ops import dp_cuda
from calitas_tpu_torch.ops.dp_screen import _screen_scores
from calitas_tpu_torch.ops.genome_screen import GenomeScreen, ShardedGenomeScreen
from calitas_tpu_torch.parallel.mesh import make_mesh, screen_on_mesh
from calitas_tpu_torch.tools import search_reference


def _scores(scorer) -> dict:
    return dict(match=scorer.match_score, mismatch=scorer.mismatch_score,
                qgap=scorer.query_gap_score, tgap=scorer.target_gap_score)


def _example_batch(B: int, T: int, Q: int):
    """A seeded random query and B random target rows of T bases, encoded:
    ``(qmask [Q], tmasks [B, T], lengths [B])``, the reference's arrays
    byte for byte."""
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    query = rng.choice(bases, size=Q).tobytes().decode()
    targets = rng.choice(bases, size=(B, T)).view(np.uint8)
    qmask = encode_query(query)
    tmasks = np.stack(
        [encode_target(targets[i].tobytes().decode()) for i in range(B)]
    )
    lengths = np.full(B, T, dtype=np.int32)
    return qmask, tmasks, lengths


def entry(device=None):
    """``(fn, example_args)``: the single-device forward step and its
    example batch (B 64 x T 256 x Q 20) as tensors on ``device`` (default
    ``cuda``; raises when torch sees no card).  ``fn(qmask, tmasks,
    lengths)`` returns the [B] int32 best scores: the row kernel
    (``dp_cuda.screen_rows``, shared query) on a CUDA device, the plain
    version (``ops/dp_screen.py::_screen_scores``) on the CPU and for a
    query longer than the kernel takes.  The reference's compile check is
    the kernel's build at its first launch."""
    dev = resolve_device(device)
    sk = _scores(derive_scorer())

    def forward(qmask, tmasks, lengths):
        if dp_cuda.uses_kernel(qmask.shape[-1], tmasks.device):
            return dp_cuda.screen_rows(qmask[None], tmasks, lengths, **sk)[0][0]
        return _screen_scores(qmask, tmasks, lengths, **sk)

    return forward, tuple(
        torch.from_numpy(a).to(dev) for a in _example_batch(B=64, T=256, Q=20)
    )


#: check (c)'s guide: config 3's protospacer and an NRG PAM
TABLE_PROTO = "CTTGCCCCACAGGGCAGTAA"
TABLE_GUIDE = TABLE_PROTO + "nrg"


def table_check_inputs(directory) -> tuple:
    """Check (c)'s inputs, written into ``directory``: a seeded 120 kb
    contig with 100 planted sites (both strands, four PAMs, 0-3
    mismatches) and a site broken at base 10, and a VCF of 50 noise SNVs
    and the one variant that repairs the broken site.  Returns ``(ref,
    vcf)`` paths; the reference's inputs byte for byte."""
    rng2 = np.random.default_rng(42)
    proto = TABLE_PROTO
    L = 120_000
    contig2 = list("".join(rng2.choice(list("ACGT"), L)))
    pams = ["TGG", "AGG", "CGG", "TAG"]
    n_sites = 100
    for i in range(n_sites):
        pos = 300 + i * 1150
        site = list(proto)
        for _ in range(i % 4):  # 0-3 mismatches
            j = int(rng2.integers(0, len(site)))
            site[j] = rng2.choice([c for c in "ACGT" if c != site[j]])
        seq = "".join(site) + pams[i % 4]
        if i % 2:
            seq = revcomp(seq)
        contig2[pos : pos + len(seq)] = list(seq)
    broken = list(proto)
    broken[10] = "A" if proto[10] != "A" else "C"
    bpos = 300 + n_sites * 1150
    contig2[bpos : bpos + 23] = list("".join(broken) + "TGG")
    contig2 = "".join(contig2)

    b = ReferenceSetBuilder(assembly="dryrun")
    b.add("chr1").add(contig2)
    ref = b.to_file(os.path.join(directory, "ref.fa"))
    vcf = os.path.join(directory, "v.vcf")
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=AF,Number=A,Type=Float,Description="AF">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        rows_v = [(bpos + 11, contig2[bpos + 10], proto[10])]
        for _ in range(50):
            p = int(rng2.integers(100, L - 100))
            rb = contig2[p - 1]
            rows_v.append((p, rb, "ACGT"[("ACGT".index(rb) + 1) % 4]))
        for p, rb, alt in sorted(rows_v):
            fh.write(f"chr1\t{p}\t.\t{rb}\t{alt}\t50\tPASS\tAF=0.1\n")
    return ref, vcf


def blanked_table(path) -> list:
    """A table's rows (header left out) with the run-varying
    ``time_stamp`` and ``aligner_version`` fields blanked."""
    lines = Path(path).read_text().splitlines()
    hdr = lines[0].split("\t")
    varying = {hdr.index("time_stamp"), hdr.index("aligner_version")}
    return ["\t".join("" if k in varying else x for k, x in enumerate(line.split("\t")))
            for line in lines[1:]]


def _chain_flags_and_ranges(screen, bases, guide, scorer, pam_spec=None):
    staged = screen.stage(bases)
    return screen.screen_contig(
        staged, len(bases), 230, guide, revcomp(guide),
        scorer.match_score * len(guide), pam_spec=pam_spec, return_ranges=True,
    )


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Checks (a), (a2), (b) and (c) on ``make_mesh(n_devices,
    devices=devices)``, printing the reference's summary line.  With no
    ``devices`` the mesh is the first ``n_devices`` visible cards, and
    fewer cards raise: spans on one card are ``devices=["cuda:0"] * n``,
    on the CPU ``["cpu"] * n``.  Returns the summary: ``flags`` (a),
    ``global_hits`` (b), ``rows``, ``hash`` and the blanked ``table`` of
    (c)."""
    if devices is None and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices, torch "
            f"sees {torch.cuda.device_count()}; pass devices= (for example "
            f"['cuda:0'] * {n_devices} or ['cpu'] * {n_devices})"
        )
    mesh = make_mesh(n_devices, devices=devices)
    if len(mesh) < n_devices:
        raise ValueError(f"a mesh of {n_devices} needs {n_devices} devices, got {len(mesh)}")
    scorer = derive_scorer()

    # (a) the sharded genome screen on a 4 kb contig with one planted
    # perfect hit, one-shot and segmented.
    rng = np.random.default_rng(0)
    guide = "ACGTACGTACGTACGT"
    contig = "".join(rng.choice(list("ACGT"), 4000))
    contig = contig[:777] + guide + contig[777 + len(guide) :]
    # a second planted site WITH an NGG PAM for the gated check (a2)
    site2 = guide + "TGG"
    contig = contig[:2000] + site2 + contig[2000 + len(site2) :]
    bases = np.frombuffer(contig.encode(), dtype=np.uint8)
    screen = ShardedGenomeScreen(scorer, mesh, window=256, batch_windows=n_devices * 128)
    chain_flags, ranges = _chain_flags_and_ranges(screen, bases, guide, scorer)
    flags = chain_flags.any(axis=0)
    assert flags.any(), "planted hit not found by the sharded genome screen"
    assert ranges.shape == (2, len(flags), 2)
    i = int(np.nonzero(chain_flags[0])[0][0])
    assert ranges[0, i, 1] >= ranges[0, i, 0]
    segs = screen.screen_contig_async(
        screen.stage(bases), len(bases), 230, guide, revcomp(guide),
        scorer.match_score * len(guide),
    )
    parts = [resolve() for _i0, _n, resolve in segs]
    assert (np.concatenate([f for f, _r in parts], axis=1) == chain_flags).all()
    assert (np.concatenate([r for _f, r in parts], axis=1) == ranges).all()

    # (a2) the same screen PAM-gated, with ranges: bit for bit the plain
    # version's with the same gate on one CPU device, and a subset of (a)'s
    # ungated flags.
    pam_spec = (("ngg",), 1, 3)
    batch = n_devices * 1024
    pf, prg = _chain_flags_and_ranges(
        ShardedGenomeScreen(scorer, mesh, window=256, batch_windows=batch),
        bases, guide, scorer, pam_spec)
    want_f, want_rg = _chain_flags_and_ranges(
        GenomeScreen(scorer, "cpu", window=256, batch_windows=batch),
        bases, guide, scorer, pam_spec)
    assert (pf == want_f).all() and (prg == want_rg).all(), \
        "gated sharded screen differs from the plain version"
    assert pf.any(), "planted hit lost by the gated sharded screen"
    assert (~chain_flags & pf).sum() == 0, "gated flags not a subset of ungated"
    i2 = int(np.nonzero(pf.any(axis=0))[0][0])
    assert prg[:, i2, 1].max() >= prg[:, i2, 0].min()

    # (b) the mesh batch screen with its global hit count.
    Q, B, T = 12, n_devices * 4, 64
    qmask, tmasks, lengths = _example_batch(B=B, T=T, Q=Q)
    planted = "ACGTACGTACGT"
    tmasks[3, 10 : 10 + Q] = encode_target(planted)
    qmask = encode_query(planted)
    min_score = scorer.match_score * Q  # perfect only
    best, total = screen_on_mesh(mesh, scorer, qmask, tmasks, lengths, min_score)
    assert best.shape == (B,)
    assert best[3] == scorer.match_score * Q, best[3]
    assert total >= 1, total
    want = _screen_scores(*(torch.from_numpy(a) for a in (qmask, tmasks, lengths)),
                          **_scores(scorer)).numpy()
    assert (best == want).all() and total == int((want >= min_score).sum()), \
        "mesh batch screen differs from the plain version"

    # (c) the whole tool on the mesh against one device, both passes.
    with tempfile.TemporaryDirectory() as td:
        ref, vcf = table_check_inputs(td)
        tables = []
        for name, kw in (("single", {}), ("mesh", {"mesh": mesh})):
            out = os.path.join(td, f"{name}.txt")
            search_reference.run(
                guide=TABLE_GUIDE, guide_id="g", ref=ref, variants=vcf, output=out,
                engine="gpu", device=str(mesh[0]), threads=1, **kw,
            )
            tables.append(blanked_table(out))
    t_single, t_mesh = tables
    assert t_single == t_mesh, f"mesh table diverges: {len(t_single)} vs {len(t_mesh)} rows"
    assert len(t_single) >= 50, f"only {len(t_single)} rows planted"
    assert any("0.100" in r for r in t_single), "variant pass empty"
    table_hash = hashlib.md5("\n".join(t_single).encode()).hexdigest()[:12]

    print(
        f"dryrun_multichip OK: mesh={n_devices} devices, "
        f"sharded-screen flags={int(flags.sum())}, global hits={total}, "
        f"full-tool table rows={len(t_single)} hash={table_hash} "
        f"(mesh == single-device, ref+variant passes)"
    )
    return {"flags": int(flags.sum()), "global_hits": total, "rows": len(t_single),
            "hash": table_hash, "table": t_single}
