"""The port's spans and counters (``calitas_tpu_torch/spans.py``): nesting,
parents and self time per thread, nothing recorded and no profiler range
entered while recording is off, counters under concurrent threads, the
``calitas:`` ranges in a CPU ``torch.profiler`` trace, and a resident
search's span tree, its counters and its table, the same byte for byte with
spans on and off.  The gpu engine runs here on ``device="cpu"``: the
screens' plain PyTorch versions."""

from __future__ import annotations

import math
import sys
import threading
import time

import numpy as np
import pytest
import torch

from calitas_tpu_torch import spans
from calitas_tpu_torch.core.scoring import Defaults
from calitas_tpu_torch.io.fasta import ReferenceSetBuilder
from calitas_tpu_torch.search import hits
from calitas_tpu_torch.serve import ResidentSearcher

GUIDE = "CTTGCCCCACAGGGCAGTAAnrg"


@pytest.fixture(autouse=True)
def fresh_spans():
    spans.disable()
    spans.drain()
    spans.reset()
    yield
    spans.disable()
    spans.drain()
    spans.reset()


def by_name(records) -> dict:
    out: dict = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_spans_nest_with_parents_and_self_time_per_thread():
    spans.enable()
    with spans.request() as rid:
        with spans.span("contig"):
            with spans.span("launch"):
                time.sleep(0.002)

            def feeder():
                with spans.span("segment_wait"):
                    time.sleep(0.004)

            t = threading.Thread(target=feeder)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            with spans.span("candidates"):
                time.sleep(0.001)
    got = by_name(spans.drain())
    [req], [contig], [launch], [wait], [cand] = (
        got[n] for n in ("request", "contig", "launch", "segment_wait", "candidates"))
    assert req.parent is None and contig.parent == req.id
    assert launch.parent == contig.id and cand.parent == contig.id
    # a span on another thread has no parent, but the request's id
    assert wait.parent is None and wait.thread != contig.thread
    assert {r.request for r in (req, contig, launch, wait, cand)} == {rid}
    assert contig.start_ns <= wait.start_ns and wait.end_ns <= contig.end_ns
    own = spans.self_ns([req, contig, launch, wait, cand])
    # the feeder's time inside the contig is not taken from it
    assert own[contig.id] == (contig.end_ns - contig.start_ns
                              - (launch.end_ns - launch.start_ns)
                              - (cand.end_ns - cand.start_ns))
    assert own[contig.id] >= 4_000_000 - 1_000_000
    assert own[wait.id] == wait.end_ns - wait.start_ns


def test_off_records_nothing_and_enters_no_profiler_range(monkeypatch):
    entered = []
    monkeypatch.setattr(spans, "_profiler_range", lambda: entered.append)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with spans.request():
            with spans.span("contig"), spans.span("launch"):
                spans.count("d2h_bytes", 5)
    finally:
        prof.stop()
    assert spans.drain() == [] and entered == []
    assert spans.span("contig") is spans.span("finish")  # one shared null context
    # counters and the request's deltas stay on
    [req] = spans.requests()
    assert req.counts == {"d2h_bytes": 5} and spans.counts() == {"d2h_bytes": 5}


def test_a_tally_span_counts_its_time_with_recording_off():
    with spans.span("stage_read", tally=True):
        time.sleep(0.002)
    with spans.span("stage_read", tally=True):
        pass
    assert spans.drain() == []
    assert spans.counts()["stage_read_ns"] >= 2_000_000


def test_a_request_keeps_the_counts_it_moved_and_an_inner_one_opens_nothing():
    spans.count("finish_chunks_inline", 7)  # before: not the request's
    spans.enable()
    with spans.request() as rid:
        with spans.request() as inner:
            assert inner == rid
            spans.count("finish_chunks_inline", 2)
        spans.count("d2h_bytes", 100)
    with spans.request() as rid2:
        pass
    assert rid2 == rid + 1
    first, second = spans.requests()
    assert (first.id, second.id) == (rid, rid2)
    assert first.counts == {"finish_chunks_inline": 2, "d2h_bytes": 100}
    assert second.counts == {}
    assert first.start_ns <= first.end_ns <= second.start_ns
    assert [r.name for r in spans.drain()] == ["request", "request"]


def test_counters_hold_under_concurrent_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                spans.count("finish_chunks_inline", 1)
                spans.count("d2h_bytes", 3)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert spans.counts() == {"finish_chunks_inline": 32_000, "d2h_bytes": 96_000}


def test_spans_sit_in_a_cpu_profiler_trace_inside_their_request():
    spans.enable()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with spans.request() as rid:
            with spans.span("contig"):
                with spans.span("launch"):
                    torch.ones(8).sum()
    finally:
        prof.stop()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("calitas:")]
    got = {e.name(): e for e in events}
    assert sorted(got) == ["calitas:contig", "calitas:launch", "calitas:request"]
    req = got["calitas:request"]
    for e in events:  # on the request's thread, inside its range
        assert e.start_thread_id() == req.start_thread_id()
        assert req.start_ns() <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= req.start_ns() + req.duration_ns()
    assert {r.request for r in spans.drain()} == {rid}


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    rng = np.random.default_rng(31)
    b = ReferenceSetBuilder(assembly="spans")
    for name, n in (("chr1", 60000), ("chr2", 40000)):
        seq = "".join(rng.choice(list("ACGT"), n))
        site = GUIDE[:20] + "TGG"
        seq = seq[:7000] + site + seq[7000 + len(site):]
        b.add(name).add(seq)
    return b.to_file(tmp / "ref.fa"), {"chr1": 60000, "chr2": 40000}


def test_a_resident_search_spans_counts_and_table(genome, monkeypatch):
    ref, lengths = genome
    monkeypatch.setattr(hits, "now_timestamp", lambda: "Sat Oct 17 00:00:00 UTC 2026")
    server = ResidentSearcher(ref, threads=1, engine="gpu", device="cpu")
    assert spans.counts()["stage_read_ns"] > 0
    off = server.search(GUIDE, "g1")
    assert spans.drain() == []
    spans.enable()
    on = server.search(GUIDE, "g1")
    records = spans.drain()
    assert on == off and on.count("\n") > 1  # byte for byte, a row besides the header

    got = by_name(records)
    [req] = got["request"]
    assert {r.request for r in records} == {req.request}
    ids = {r.id: r for r in records}

    def parent(r):
        return ids[r.parent].name if r.parent is not None else None

    want = {
        "run": "request", "table_read": "request", "reference_pass": "run",
        "stage_wait": "reference_pass", "contig": "reference_pass",
        "launch": "contig", "annotate": "launch", "segment_launch": "launch",
        "segment_wait": "contig", "candidates": "contig", "finish": "contig",
        "finalize": "run", "dedup_sort_serialize": "finalize", "write": "finalize",
    }
    assert set(got) == set(want) | {"request"}
    for name, p in want.items():
        assert {parent(r) for r in got[name]} == {p}, name
    assert len(got["contig"]) == 2 and len(got["launch"]) == 2
    assert {r.thread for r in records} == {req.thread}  # one thread: the finish ran inline

    # the readback's bytes: packed flags [2, ceil(n/8)] and ranges [2, n, 2]
    # of every segment
    step = server._screen.window - (len(GUIDE) + Defaults.MAX_GUIDE_DIFFS
                                    + Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM - 1)
    segs = [n for length in lengths.values()
            for _i0, n in server._screen.segment_spans(len(range(0, length - 1, step)))]
    assert len(got["segment_launch"]) == len(got["segment_wait"]) == len(segs)
    [last] = spans.requests()[-1:]
    assert last.id == req.request
    assert last.counts["d2h_bytes"] == sum(2 * math.ceil(n / 8) + 4 * n for n in segs)
    assert last.counts["finish_chunks_inline"] == len(got["finish"]) >= 1
    assert "finish_chunks_pooled" not in last.counts
