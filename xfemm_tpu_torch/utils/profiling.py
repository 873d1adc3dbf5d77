"""The port's tracer: phase timers that are also parented spans.

The reference has only printf progress lines (spars.cpp:254 percent
counters, static2d.cpp:994 Newton lines). Here ``phase(name)`` is the
one instrument, switched on by XFEMM_TPU_PROFILE=1 (or by setting
``ENABLED``); while it is off a phase costs one check of ``ENABLED``.
While it is on each phase

* adds its host seconds to a sum per name (``snapshot``,
  ``phase_seconds``; ``report`` prints the table, also at exit);
* records a span (``spans``): its name, host start and end on the
  ``time.perf_counter_ns`` clock, its id, the id of the span open around
  it on the same thread, its request id (the id of the outermost span
  of its thread, its root: ``models.solve`` opens the root "solve") and
  whether an exception went through it;
* opens ``torch.profiler.record_function("phase:" + name)`` while a
  ``torch.profiler`` is active, so a profiler trace carries the spans on
  its own clock.

A phase that enqueues device work opts in with ``device=True``: while a
CUDA device is in use it records a timing event on the current stream
as it opens and another as it closes. Each root takes one anchor (a
synchronise, then an event and its host time, with the device idle), and
``spans`` resolves the events against it into ``device_start_ns`` /
``device_end_ns`` on the host clock once the device has passed them.
``device_record`` adds a device-only record under the open span (the
loop driver's masked tails, ``ops/loop.py``).

The program's modules bind ``phase`` as they are imported, so a caller
that replaces the module's attribute (``benchmark/trace.py`` wraps it
with a one-argument marker) changes none of the program's spans.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import os
import threading
import time

import torch

ENABLED = bool(os.environ.get("XFEMM_TPU_PROFILE"))

#: spans kept in memory; the oldest go first
SPAN_LIMIT = 1 << 16

_acc: dict[str, float] = collections.defaultdict(float)
_cnt: dict[str, int] = collections.defaultdict(int)
_SPANS: collections.deque = collections.deque(maxlen=SPAN_LIMIT)
_IDS = itertools.count(1)
_LOCAL = threading.local()


class Span:
    """One phase of one thread (``start_ns`` / ``end_ns`` None: a
    device-only record)."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns",
                 "error", "device_start_ns", "device_end_ns", "engine",
                 "_anchor", "_events")

    def __init__(self, name: str, parent: "Span | None", start_ns):
        self.name = name
        self.id = next(_IDS)
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else self.id
        self._anchor = (parent._anchor if parent is not None
                        else _take_anchor())
        self.start_ns = start_ns
        self.end_ns = None
        self.error = False
        self.device_start_ns = self.device_end_ns = None
        self.engine = None
        self._events = None


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _take_anchor():
    """(event, host ns) recorded with the device idle, or None when no
    CUDA device is in use."""
    if not torch.cuda.is_initialized():
        return None
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter_ns()
    ev.record()
    return ev, t


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@contextlib.contextmanager
def phase(name: str, device: bool = False):
    if not ENABLED:
        yield
        return
    stack = _stack()
    span = Span(name, stack[-1] if stack else None, time.perf_counter_ns())
    mark = None
    if torch._C._autograd._profiler_enabled():
        mark = torch.profiler.record_function("phase:" + name)
        mark.__enter__()
    if device and span._anchor is not None:
        span._events = (_event(), None)
    stack.append(span)
    _SPANS.append(span)
    try:
        yield
    except BaseException:
        span.error = True
        raise
    finally:
        if span._events is not None:
            span._events = (span._events[0], _event())
        span.end_ns = time.perf_counter_ns()
        stack.pop()
        if mark is not None:
            mark.__exit__(None, None, None)
        _acc[name] += (span.end_ns - span.start_ns) * 1e-9
        _cnt[name] += 1


def device_record(name: str, start, end, engine: str | None = None) -> None:
    """A device-only record under the open span: the interval between
    two recorded CUDA timing events. Nothing is kept while tracing is
    off, outside any span, or without a CUDA device."""
    stack = _stack()
    if not ENABLED or not stack or stack[-1]._anchor is None:
        return
    rec = Span(name, stack[-1], None)
    rec.engine = engine
    rec._events = (start, end)
    _SPANS.append(rec)


def _resolve(span: Span) -> None:
    start, end = span._events
    if end is None or not end.query():
        return                      # still open, or not yet reached
    ev0, t0 = span._anchor
    span.device_start_ns = t0 + round(ev0.elapsed_time(start) * 1e6)
    span.device_end_ns = t0 + round(ev0.elapsed_time(end) * 1e6)
    span._events = None


def spans() -> list:
    """The spans kept, in the order they opened (a copy of the list).
    Device times resolve here, for events the device has passed: call
    after a synchronise."""
    out = list(_SPANS)
    for s in out:
        if s._events is not None:
            _resolve(s)
    return out


def phase_seconds(name: str) -> float:
    """Accumulated seconds recorded under ``name`` (0.0 if never hit)."""
    return _acc.get(name, 0.0)


def snapshot() -> dict:
    """{phase: seconds} accumulated so far (a copy)."""
    return dict(_acc)


def reset() -> None:
    _acc.clear()
    _cnt.clear()
    _SPANS.clear()


def report() -> str:
    """Host seconds and calls per phase, and the device seconds of its
    spans where it opted in (``device=True``) and the device has passed
    them."""
    dev: dict[str, float] = collections.defaultdict(float)
    for s in spans():
        if s.device_end_ns is not None and s.start_ns is not None:
            dev[s.name] += (s.device_end_ns - s.device_start_ns) * 1e-9
    lines = ["xfemm_tpu phase timers:"]
    for name, tot in sorted(_acc.items(), key=lambda kv: -kv[1]):
        line = f"  {name:<28s} {tot:9.3f}s  x{_cnt[name]}"
        if name in dev:
            line += f"  device {dev[name]:9.3f}s"
        lines.append(line)
    return "\n".join(lines)


def _atexit_report():
    if ENABLED and _acc:
        print(report(), flush=True)


atexit.register(_atexit_report)
