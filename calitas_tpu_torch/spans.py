"""Spans and counters of the port's own layers: the one place where the
program times and counts itself.

:func:`span` marks a layer boundary.  Recording is off by default, and a
span then costs one flag check.  After :func:`enable`, each span keeps its
name, request id, parent, thread and start and end
(``time.perf_counter_ns``) in a bounded buffer that :func:`drain` empties.
Parents come from a stack per thread, so a span opened on a worker thread
has no parent.  While a ``torch.profiler`` records on the span's thread,
the span also opens a profiler range ``calitas:<name>``: it then sits
in the profiler's trace on the profiler's clock, beside the device's
kernels and copies, and a request's spans lie inside its
``calitas:request`` event on the request's thread.

:func:`count` adds to a named counter.  Counters are always on, and are
called once per segment or chunk, never per window.  :func:`request`
scopes one request: a new request id, the ``request`` span, and the
request's counter deltas, kept for :func:`requests`.  Requests are
sequential, so the current request id is one for the whole process: a
span on a worker thread carries the id of the request it works for.

A span made with ``tally=True`` also adds its duration to the counter
``<name>_ns``, whether recording is on or not; it is for steps that run a
few times per process (staging), not for the search's own path.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import NamedTuple, Optional

#: recorded spans kept until drained; past this the oldest are dropped
BUFFER = 1 << 16
#: finished requests whose counter deltas are kept
REQUESTS = 1 << 12

_on = False
_records: deque = deque(maxlen=BUFFER)
_requests: deque = deque(maxlen=REQUESTS)
_local = threading.local()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_request: Optional[int] = None
_counts: dict = {}
_lock = threading.Lock()
_NULL = nullcontext()


class Span(NamedTuple):
    """One recorded span; ``parent`` is the ``id`` of the span open on the
    same thread when it started."""

    id: int
    name: str
    request: Optional[int]
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int


@dataclass(frozen=True)
class Request:
    """One finished request: its id, its start and end
    (``time.perf_counter_ns``) and the counters it moved."""

    id: int
    start_ns: int
    end_ns: int
    counts: dict


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> list:
    """The recorded spans, in the order they ended; the buffer is left
    empty."""
    out = []
    while True:
        try:
            out.append(_records.popleft())
        except IndexError:
            return out


def _profiler_range():
    """The profiler's range type: torch's C++ ``_RecordFunctionFast``, a
    tenth of ``torch.profiler.record_function``'s host time (which makes
    two dispatcher calls), where this torch has it."""
    import torch

    return getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)


def _profiling() -> bool:
    """A ``torch.profiler`` records on this thread (torch is never
    imported here: the host modules and the finish workers run without
    it)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "record", "tally", "id", "parent", "start", "mark")

    def __init__(self, name: str, record: bool, tally: bool):
        self.name, self.record, self.tally = name, record, tally

    def __enter__(self):
        self.mark = None
        if self.record:
            stack = _stack()
            self.parent = stack[-1].id if stack else None
            self.id = next(_span_ids)
            stack.append(self)
            if _profiling():
                self.mark = _profiler_range()("calitas:" + self.name)
                self.mark.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self.mark is not None:
            self.mark.__exit__(*exc)
        if self.tally:
            count(self.name + "_ns", end - self.start)
        if self.record:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:  # a generator closed on another thread
                stack.remove(self)
            _records.append(Span(self.id, self.name, _request, self.parent,
                                 threading.get_ident(), self.start, end))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, tally: bool = False):
    """A context manager around one layer's work (see the module's
    docstring)."""
    if _on or tally:
        return _Span(name, _on, tally)
    return _NULL


def count(name: str, n: int) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> dict:
    """The counters since the process started (or :func:`reset`)."""
    with _lock:
        return dict(_counts)


def reset() -> None:
    """Counters to zero and the finished requests forgotten."""
    with _lock:
        _counts.clear()
    _requests.clear()


@contextmanager
def request():
    """One request's scope, yielding its id.  Inside an open request it
    opens nothing and yields that request's id."""
    global _request
    if _request is not None:
        yield _request
        return
    rid = _request = next(_request_ids)
    before = counts()
    start = time.perf_counter_ns()
    try:
        with span("request"):
            yield rid
    finally:
        end = time.perf_counter_ns()
        moved = {k: v - before.get(k, 0) for k, v in counts().items()
                 if v != before.get(k, 0)}
        _requests.append(Request(rid, start, end, moved))
        _request = None


def requests() -> list:
    """The finished requests, oldest first."""
    return list(_requests)


def self_ns(spans: list) -> dict:
    """``{span id: ns}``: each span's duration less the time its children
    (spans on its thread whose parent it is) cover."""
    out = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out
