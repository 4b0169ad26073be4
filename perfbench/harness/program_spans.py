"""Reading the program's own spans and counters
(``calitas_tpu_torch/spans.py``): its counters over the window's searches,
and the device's idle time split by what the searching thread was doing.

A program without that module (an older checkout) gives nothing to read:
every reader here returns None and raises nothing.

The split: while a ``torch.profiler`` records and the program's spans are
on, each span is a ``calitas:<name>`` range in the trace on the thread that
ran it.  Each idle stretch of the device inside the window (the window and
the busy time as :func:`perfbench.harness.trace.summarize` takes them) goes
to the innermost ``calitas:`` range open at that time on the thread of the
program's ``calitas:request`` ranges, and so to that span's class; a stretch
with no range open, or only one of no class, is ``other``.  So the classes
sum to the device's idle time, and a span on another thread (the finish
pool's feeder) takes none of it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from perfbench.harness.trace import _union

PREFIX = "calitas:"

#: the idle classes and the spans whose time each takes
CLASSES = {
    "launch": ("launch", "annotate", "segment_launch"),
    "candidates": ("candidates", "segment_wait"),
    "finish": ("finish",),
    "finalize": ("finalize", "dedup_sort_serialize", "write", "table_read"),
}
OTHER = "other"
_CLASS_OF = {name: cls for cls, names in CLASSES.items() for name in names}


def program_spans():
    """The program's ``spans`` module, or None where it has none."""
    try:
        from calitas_tpu_torch import spans
    except ImportError:
        return None
    return spans


def window_counts(w) -> Optional[dict]:
    """The program's counters summed over its requests that ran inside the
    window's completed searches."""
    spans = program_spans()
    if spans is None:
        return None
    out: dict = {}
    for p in spans.requests():
        if any(r.t0 * 1e9 <= p.start_ns and p.end_ns <= r.t1 * 1e9 for r in w.done):
            for k, v in p.counts.items():
                out[k] = out.get(k, 0) + v
    return out


@dataclass
class Event:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    device: bool
    thread: int  # the profiler's id of the host thread


def events_of(profiler) -> list:
    """The events of :func:`perfbench.harness.trace.events_of`, with the
    thread of each."""
    out = []
    for e in profiler.profiler.kineto_results.events():
        on_device = "CUDA" in str(e.device_type())
        if on_device and e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append(Event(e.name(), int(start), int(start + e.duration_ns()), on_device,
                         int(e.start_thread_id())))
    return out


def _innermost(ranges) -> list:
    """``(start, end, name)`` pieces of nested ``ranges`` (events of one
    thread), each piece named by the innermost range open over it."""
    out, stack, t = [], [], None
    for r in sorted(ranges, key=lambda e: (e.start, -e.end)):
        while stack and stack[-1][0] <= r.start:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end
        if stack and r.start > t:
            out.append((t, r.start, stack[-1][1]))
        t = r.start if t is None else max(t, r.start)
        end = min(r.end, stack[-1][0]) if stack else r.end
        stack.append((end, r.name[len(PREFIX):]))
    while stack:
        end, name = stack.pop()
        if end > t:
            out.append((t, end, name))
            t = end
    return out


def idle_by_span(events) -> Optional[dict]:
    """``{span name: idle seconds}`` over the window, the innermost
    ``calitas:`` range on the request's thread naming each idle stretch
    (``""`` where none is open); None without the harness's requests or the
    program's ``calitas:request`` ranges in the trace."""
    host = [e for e in events if not e.device]
    requests = [(e.start, e.end) for e in host if e.name == "perfbench:request"]
    threads = {e.thread for e in host if e.name == PREFIX + "request"}
    if not requests or not threads:
        return None
    w0, w1 = min(s for s, _e in requests), max(e for _s, e in requests)
    busy = _union((max(e.start, w0), min(e.end, w1)) for e in events
                  if e.device and e.end > w0 and e.start < w1)
    edges = [w0] + [x for b in busy for x in b] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    pieces = sorted(p for th in threads for p in _innermost(
        [e for e in host if e.thread == th and e.name.startswith(PREFIX)]))
    out = {"": 0}
    k = 0
    for gs, ge in gaps:
        covered = 0
        while k < len(pieces) and pieces[k][1] <= gs:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < ge:
            ps, pe, name = pieces[j]
            part = min(pe, ge) - max(ps, gs)
            if part > 0:
                out[name] = out.get(name, 0) + part
                covered += part
            j += 1
        out[""] += (ge - gs) - covered
    return {name: ns / 1e9 for name, ns in out.items()}


def idle_by_class(by_span: Optional[dict]) -> Optional[dict]:
    """``{class: idle seconds}`` of :func:`idle_by_span`'s split, the
    classes of :data:`CLASSES` and :data:`OTHER`."""
    if by_span is None:
        return None
    out = dict.fromkeys([*CLASSES, OTHER], 0.0)
    for name, s in by_span.items():
        out[_CLASS_OF.get(name, OTHER)] += s
    return out
