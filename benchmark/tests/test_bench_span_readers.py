"""The span readers (``loop_setup_s``, ``loop_device_s``,
``masked_device_s``) on made-up spans and runs: totals per served
request, roots an exception went through left out, and None where the
program records no spans or none of the reader's."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from xfemm_tpu_torch.utils import profiling

READERS = ("loop_setup_s", "loop_device_s", "masked_device_s")


def _span(name, sid, parent, request, host=None, device=None,
          error=False):
    """A span with host and device intervals in seconds."""
    h0, h1 = host or (None, None)
    d0, d1 = device or (None, None)
    ns = (lambda t: None if t is None else int(t * 1e9))
    return SimpleNamespace(name=name, id=sid, parent=parent,
                           request=request, start_ns=ns(h0), end_ns=ns(h1),
                           device_start_ns=ns(d0), device_end_ns=ns(d1),
                           error=error)


def _request(rid, setup, cg, masked, error=False):
    """One "solve" tree: a loop set-up span, "device newton" and "device
    cg" spans (their device seconds add to ``cg``), and a masked tail
    under the "device cg" span (ids rid .. rid + 4)."""
    return [
        _span("solve", rid, None, rid, (0, 10), error=error),
        _span("newton loop setup", rid + 1, rid, rid, (1, 1 + setup),
              (1, 1 + setup)),
        _span("device newton", rid + 2, rid, rid, (2, 3 + cg),
              (2, 2 + cg / 2)),
        _span("device cg", rid + 3, rid, rid, (5, 6), (5, 5 + cg / 2)),
        _span("masked tail", rid + 4, rid + 3, rid, None,
              (5.1, 5.1 + masked)),
    ]


def _run(n):
    return SimpleNamespace(requests=[SimpleNamespace(error=None)
                                     for _ in range(n)])


def _read(name, spans, run, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: spans, raising=False)
    return spec.metric(name).read(run)


def test_per_served_request(monkeypatch):
    # an older root (before the window) is not among the last two
    spans = (_request(1, 9.0, 9.0, 9.0) + _request(10, 0.5, 0.25, 0.125)
             + _request(20, 0.25, 0.5, 0.0625))
    run = _run(2)
    assert _read("loop_setup_s", spans, run, monkeypatch) == \
        pytest.approx(0.375)
    assert _read("loop_device_s", spans, run, monkeypatch) == \
        pytest.approx(0.375)
    assert _read("masked_device_s", spans, run, monkeypatch) == \
        pytest.approx(0.09375)


def test_failed_roots_are_left_out(monkeypatch):
    spans = (_request(10, 0.5, 0.25, 0.125)
             + _request(20, 8.0, 8.0, 8.0, error=True))
    run = _run(2)
    run.requests[1].error = "RuntimeError: planted"
    assert _read("loop_setup_s", spans, run, monkeypatch) == \
        pytest.approx(0.5)
    assert _read("masked_device_s", spans, run, monkeypatch) == \
        pytest.approx(0.125)


def test_requests_without_the_span_count_as_zero(monkeypatch):
    """Heat builds its loop once per new problem: a request that builds
    none adds 0 and still divides."""
    spans = _request(10, 0.5, 0.25, 0.125) + _request(20, 0.5, 0.25, 0.125)
    spans = [s for s in spans if s.id != 21]
    assert _read("loop_setup_s", spans, _run(2), monkeypatch) == \
        pytest.approx(0.25)


@pytest.mark.parametrize("name", READERS)
def test_none_without_spans(name, monkeypatch):
    assert _read(name, [], _run(2), monkeypatch) is None
    roots_only = [s for s in _request(10, 0.5, 0.25, 0.125)
                  if s.name == "solve"]
    assert _read(name, roots_only, _run(1), monkeypatch) is None
    # on the CPU a span has no device times
    cpu = [_span(s.name, s.id, s.parent, s.request,
                 (0, 1) if s.start_ns is not None else None)
           for s in _request(10, 0.5, 0.25, 0.125)]
    got = _read(name, cpu, _run(1), monkeypatch)
    assert (got is None) == (name != "loop_setup_s")
    # a program without spans (a tracer that has none)
    monkeypatch.delattr(profiling, "spans")
    assert spec.metric(name).read(_run(1)) is None
