"""Reading a ``torch.profiler`` trace of the window: the device's busy time,
its longest idle gaps named by what the host was doing, and the device
operations that took most time.

The harness marks the host's phases with ``record_function`` events named
``perfbench:<mark>`` (the request around each search, and a zero-length mark
at each of the program's phase records), so marks and device operations come
from one clock.  Busy time is the union of the intervals of the device's
kernels, copies and sets inside the traced window: the first request's start
to the last one's end.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

#: entries kept in each list of a breakdown
TOP = 10


@dataclass
class Event:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    device: bool


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: list  # [[name, seconds]], most time first
    idle_gaps: list  # [[phase, seconds]], longest first


def events_of(profiler) -> list:
    """The profiler's events as :class:`Event`: the host's, and the device's
    kernels, copies and sets.  The device-side copies of ``record_function``
    ranges (user annotations) are no work of the device and are left out."""
    out = []
    for e in profiler.profiler.kineto_results.events():
        on_device = "CUDA" in str(e.device_type())
        if on_device and e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append(Event(e.name(), int(start), int(start + e.duration_ns()), on_device))
    return out


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def phases(events) -> list:
    """``(start, end, phase)`` of the host's phases inside the requests,
    from the marks: ``reference_pass`` from a request's start to the
    program's "Reference windows processed." record, ``finalize`` from its
    "Sorting and Outputting." record to its "Done:" record.  Everything
    else is ``between_requests``."""
    host = [e for e in events if not e.device]
    marks = sorted((e.start, e.name[len("perfbench:"):]) for e in host
                   if e.name.startswith("perfbench:") and e.name != "perfbench:request")
    out = []
    for r in sorted((e.start, e.end) for e in host if e.name == "perfbench:request"):
        inside = [(t, m) for t, m in marks if r[0] <= t <= r[1]]
        t_ref = next((t for t, m in inside if m == "reference_done"), None)
        t_fin = next((t for t, m in inside if m == "finalize_start"), None)
        t_done = next((t for t, m in inside if m == "done"), None)
        if t_ref is not None:
            out.append((r[0], t_fin if t_fin is not None else t_ref, "reference_pass"))
        if t_fin is not None and t_done is not None:
            out.append((t_fin, t_done, "finalize"))
    return out


def _split(gaps, spans):
    """Each gap cut at the phases' edges: ``(phase, start, end)``, the parts
    outside every phase ``between_requests``."""
    out = []
    for s, e in gaps:
        t = s
        for ps, pe, phase in spans:
            if pe <= t or ps >= e:
                continue
            if ps > t:
                out.append(("between_requests", t, ps))
            out.append((phase, max(ps, t), min(pe, e)))
            t = min(pe, e)
        if t < e:
            out.append(("between_requests", t, e))
    return out


def summarize(events) -> TraceSummary:
    """Busy time, idle gaps and top operations of the traced window."""
    requests = [(e.start, e.end) for e in events
                if e.name == "perfbench:request" and not e.device]
    if not requests:
        raise ValueError("the trace holds no request")
    w0, w1 = min(s for s, _e in requests), max(e for _s, e in requests)
    device = [e for e in events if e.device and e.end > w0 and e.start < w1]
    busy = _union((max(e.start, w0), min(e.end, w1)) for e in device)
    by_name = defaultdict(int)
    for e in device:
        by_name[e.name[:100]] += min(e.end, w1) - max(e.start, w0)
    edges = [w0] + [x for b in busy for x in b] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)]
    named = [[phase, (e - s) / 1e9] for phase, s, e in _split(gaps, phases(events)) if e > s]
    return TraceSummary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        device_ops=[[n, t / 1e9] for n, t in sorted(by_name.items(), key=lambda x: -x[1])][:TOP],
        idle_gaps=sorted(named, key=lambda x: -x[1])[:TOP],
    )
