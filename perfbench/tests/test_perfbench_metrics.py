"""The metric arithmetic on made-up request logs and traces."""

import pytest

from perfbench.harness import spec, work
from perfbench.harness.session import Request, Window
from perfbench.harness.trace import Event, summarize


def request(t0, wall, gbases=3.0, least=0.008, error=None, marks=()):
    return Request(("g",), t0, t0 + wall, gbases, least, error, "", list(marks))


def read(name, w):
    return spec.metric_reader(name)(w)


def test_the_window_rate_counts_completed_searches_over_the_whole_window():
    reqs = [request(0.0, 0.5), request(0.5, 0.5), request(1.0, 0.5, error="boom")]
    w = Window(reqs, 1.5, 20.0, {}, None)
    assert read("wall_gbases_per_s", w) == pytest.approx(6.0 / 1.5)
    assert read("setup_s", w) == 20.0


def test_phase_and_screen_metrics_from_the_program_records():
    marks = [(0.30, "screen", "Screen chr1/g: 5 of 1000 windows are candidates (0.50%)."),
             (0.35, "screen", "Screen chr2/g: 15 of 1000 windows are candidates (1.50%)."),
             (0.40, "reference_done", "Reference windows processed."),
             (0.41, "finalize_start", "Sorting and Outputting."),
             (0.44, "done", "Done: ...")]
    w = Window([request(0.0, 0.5, marks=marks)], 0.5, 1.0, {"screen_dual": 30}, None)
    assert read("reference_pass_s", w) == pytest.approx(0.40)
    assert read("finalize_s", w) == pytest.approx(0.03)
    assert read("candidate_window_pct", w) == pytest.approx(1.0)
    assert read("screen_launches_per_gbase", w) == pytest.approx(10.0)
    assert read("device_ms_per_gbase", w) is None  # no trace: nothing to read


def test_roofline_from_the_shapes():
    # one 10,000-base contig, step 973, window 1000, Q 20: windows at 0..9730
    assert work.n_windows(10_000, 973) == 11
    ops, nbytes = work.grid_work(10_000, 973, 1000, 20)
    assert ops == 2 * (2 * 20 * 11 * 1000)
    assert nbytes == 10_000 + (2 * 20 * 4 + 4) + 2 * 11 * 12
    assert work.least_seconds([10_000], 973, 1000, 20) == ops / work.INT32_OPS_PER_S
    # a contig of GRCh38's chr1 length: about 8 ms of the card per guide
    # over the whole assembly is what the bound gives
    t = work.least_seconds([248_956_422], 973, 1000, 20)
    assert 0.5e-3 < t < 1e-2


def _ev(name, s, e, device=False):
    return Event(name, int(s * 1e9), int(e * 1e9), device)


def test_trace_busy_idle_gaps_and_top_operations():
    events = [
        _ev("perfbench:request", 0.0, 1.0), _ev("perfbench:reference_done", 0.6, 0.6),
        _ev("perfbench:finalize_start", 0.7, 0.7), _ev("perfbench:done", 0.9, 0.9),
        _ev("perfbench:request", 1.2, 2.0), _ev("perfbench:reference_done", 1.8, 1.8),
        _ev("kernel_a", 0.1, 0.3, True), _ev("kernel_b", 0.2, 0.4, True),
        _ev("kernel_a", 1.3, 1.5, True), _ev("host_op", 0.0, 2.0),
    ]
    t = summarize(events)
    assert t.window_s == pytest.approx(2.0)
    assert t.busy_s == pytest.approx(0.5)  # [0.1, 0.4] and [1.3, 1.5]
    assert t.device_ops[0][0] == "kernel_a" and t.device_ops[0][1] == pytest.approx(0.4)
    # idle 0.0-0.1, 0.4-1.3 and 1.5-2.0, cut at the phases' edges
    assert sorted((p, round(s, 6)) for p, s in t.idle_gaps) == [
        ("between_requests", 0.2), ("between_requests", 0.3), ("finalize", 0.2),
        ("reference_pass", 0.1), ("reference_pass", 0.1), ("reference_pass", 0.3),
        ("reference_pass", 0.3)]
    w = Window([request(0.0, 1.0, gbases=3.0, least=0.01),
                request(1.2, 0.8, gbases=3.0, least=0.01)], 2.0, 1.0, {}, t)
    assert read("device_ms_per_gbase", w) == pytest.approx(1e3 * 0.5 / 6.0)
    assert read("device_roofline_pct", w) == pytest.approx(100 * 0.02 / 0.5)
    assert read("device_idle_pct", w) == pytest.approx(75.0)


def test_a_group_counts_its_guides_in_gbases_and_least_time():
    import json
    from pathlib import Path

    from perfbench.harness.session import limits, request_work
    from perfbench.harness.traffic import Guide

    root = Path(__file__).resolve().parents[2]
    cfg = json.loads((root / "perfbench/configs/grch38.json").read_text())
    tr = json.loads((root / "perfbench/traffic/d3_four_spcas9.json").read_text())
    lim = limits(tr, tr["search"], cfg["searcher"]["window_size"])
    guides = [Guide(f"g{i}", "ACGTACGTACGTACGTACGT" + "nrg", "ACGTACGTACGTACGTACGT")
              for i in range(4)]
    one, four = request_work(cfg, lim, guides[:1]), request_work(cfg, lim, guides)
    assert one[0] == pytest.approx(3.088286401) and four[0] == pytest.approx(4 * one[0])
    assert four[1] == pytest.approx(4 * one[1], rel=1e-12)
