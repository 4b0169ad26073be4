"""The readers of the program's own spans and counters: the idle split on
made-up traces, the counter metrics on made-up requests, nothing read (and
nothing raised) from a program without spans, and a whole traced run at a
small size on the CPU with the spans on."""

import json
import sys
import time
from pathlib import Path

import pytest

from calitas_tpu_torch import spans
from perfbench.harness import procs, session, spec
from perfbench.harness.program_spans import (
    CLASSES,
    OTHER,
    Event,
    idle_by_class,
    idle_by_span,
)
from perfbench.harness.session import Request, Window
from perfbench.harness.trace import summarize
from perfbench.harness.trace import Event as TraceEvent

ROOT = Path(__file__).resolve().parents[2]
NEW = ("finish_inline_pct", "d2h_mb_per_gbase", "stage_read_s")


@pytest.fixture(autouse=True)
def fresh_spans():
    spans.disable()
    spans.drain()
    spans.reset()
    yield
    spans.disable()
    spans.drain()
    spans.reset()


def read(name, w):
    return spec.metric_reader(name)(w)


def _ev(name, s, e, device=False, thread=1):
    return Event(name, int(s * 1e9), int(e * 1e9), device, thread)


def test_idle_splits_by_the_innermost_span_of_the_request_thread():
    events = [
        _ev("perfbench:request", 0.0, 1.0), _ev("calitas:request", 0.0, 0.95),
        _ev("calitas:run", 0.0, 0.9), _ev("calitas:contig", 0.1, 0.7),
        _ev("calitas:launch", 0.1, 0.2), _ev("calitas:annotate", 0.12, 0.15),
        _ev("calitas:segment_wait", 0.3, 0.4), _ev("calitas:candidates", 0.4, 0.45),
        _ev("calitas:finish", 0.5, 0.65), _ev("calitas:finalize", 0.75, 0.85),
        _ev("calitas:write", 0.8, 0.85),
        # the finish pool's feeder, on another thread, takes no idle from
        # the request's
        _ev("calitas:candidates", 0.5, 0.65, thread=2),
        _ev("kernel", 0.15, 0.3, True), _ev("copy", 0.35, 0.38, True),
    ]
    by_span = idle_by_span(events)
    assert by_span["annotate"] == pytest.approx(0.03) and by_span[""] == pytest.approx(0.05)
    assert by_span["candidates"] == pytest.approx(0.05)
    assert by_span["finish"] == pytest.approx(0.15)
    split = idle_by_class(by_span)
    assert set(split) == {*CLASSES, OTHER}
    # busy 0.15-0.3 and 0.35-0.38; other: 0-0.1 run, 0.45-0.5 and 0.65-0.7
    # contig, 0.7-0.75 and 0.85-0.9 run, 0.9-0.95 request, 0.95-1.0 no span
    want = {"launch": 0.05, "candidates": 0.05 + 0.02 + 0.05, "finish": 0.15,
            "finalize": 0.1, "other": 0.1 + 6 * 0.05}
    assert split == pytest.approx(want)
    plain = summarize([TraceEvent(e.name, e.start, e.end, e.device) for e in events])
    assert sum(split.values()) == pytest.approx(plain.window_s - plain.busy_s)


def test_no_split_without_the_program_spans_in_the_trace():
    events = [_ev("perfbench:request", 0.0, 1.0), _ev("kernel", 0.1, 0.2, True)]
    assert idle_by_span(events) is None and idle_by_class(None) is None


def _request(t0, t1, gbases=2.0):
    return Request(("g",), t0, t1, gbases, 0.001, None, "", [])


def test_counter_metrics_read_the_window_searches_only():
    with spans.request():  # set-up's search, before the window
        spans.count("d2h_bytes", 10**9)
        spans.count("finish_chunks_pooled", 50)
    reqs = []
    for inline, pooled in ((3, 1), (4, 0)):
        t0 = time.perf_counter()
        with spans.request():
            spans.count("d2h_bytes", 4_000_000)
            spans.count("finish_chunks_inline", inline)
            spans.count("finish_chunks_pooled", pooled)
        reqs.append(_request(t0, time.perf_counter()))
    failed = _request(time.perf_counter(), 0.0)
    failed.error = "boom"
    w = Window(reqs + [failed], 1.0, 10.0, {}, None)
    assert read("finish_inline_pct", w) == pytest.approx(100.0 * 7 / 8)
    assert read("d2h_mb_per_gbase", w) == pytest.approx(8.0 / 4.0)
    assert read("stage_read_s", w) is None
    spans.count("stage_read_ns", 2_500_000_000)
    assert read("stage_read_s", w) == pytest.approx(2.5)


def test_a_program_without_spans_gives_nothing_and_raises_nothing(monkeypatch):
    spans.count("stage_read_ns", 10**9)
    t0 = time.perf_counter()
    with spans.request():
        spans.count("d2h_bytes", 100)
        spans.count("finish_chunks_inline", 1)
    w = Window([_request(t0, time.perf_counter())], 1.0, 10.0, {}, None)
    import calitas_tpu_torch

    monkeypatch.delattr(calitas_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "calitas_tpu_torch.spans", None)  # import fails
    for name in NEW:
        assert read(name, w) is None


def small_cell() -> spec.Cell:
    cfg = json.loads((ROOT / "perfbench/configs/grch38.json").read_text())
    cfg["contigs"] = [["chr1", 300_000], ["chr2", 200_000], ["chrM", 16_569]]
    cfg["searcher"]["threads"] = 2
    tr = json.loads((ROOT / "perfbench/traffic/d3_spcas9.json").read_text())
    tr["guides"], tr["margin"] = 4, 2000
    metrics = {m["name"]: m["unit"] for m in spec.load_benchmark()["per_layer"]
               if m["name"] in NEW}
    return spec.Cell("small", 1, cfg, tr, metrics, True)


def test_a_traced_run_with_spans_reads_the_split_and_the_counters(tmp_path, monkeypatch):
    from perfbench import trace_spans

    monkeypatch.setattr(session, "GENOME_DIR", tmp_path / "genome")
    real = session.events_of
    try:
        result = trace_spans.run_traced(small_cell(), 2**31 + 11, 0.5, True, "cpu",
                                        time.perf_counter())
    finally:
        procs.stop_processes()
    assert session.events_of is real and not spans.enabled()
    assert result["correct"] and set(result["metrics"]) == set(NEW)
    assert result["metrics"]["finish_inline_pct"]["value"] == 100.0
    got = result["spans"]
    assert got["requests"] == result["attempted"] and got["per_request"] > 10
    assert {"request", "run", "contig", "launch", "finish"} <= set(got["by_name"])
    idle = 100.0 * (1 - result["device"]["busy_s"] / result["device"]["window_s"])
    split = sum(got[f"idle_{c}_pct"] for c in [*CLASSES, OTHER])
    assert split == pytest.approx(idle)
    assert sum(got["idle_pct_by_span"].values()) == pytest.approx(idle)
