"""The ``axi_setup_reuse_share`` reader on made-up spans and runs: the
"axi setup (sources)" and "axi setup (reused)" spans over every "axi
setup (<kind>)" span of the served requests (roots an exception went
through left out), and None where the program records no spans or none
of the reader's (a program from before the axisymmetric set-up tier, or
the planar model's spans alone)."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from xfemm_tpu_torch.utils import profiling

NAME = "axi_setup_reuse_share"


def _span(name, sid, parent, request, error=False):
    return SimpleNamespace(name=name, id=sid, parent=parent,
                           request=request, start_ns=0, end_ns=1,
                           device_start_ns=None, device_end_ns=None,
                           error=error)


def _request(rid, kind, error=False, model="axi"):
    """One "solve" tree: "<model> static setup" and under it the set-up's
    one "<model> setup (<kind>)" span (ids rid .. rid + 2); no set-up
    span where ``kind`` is None."""
    tree = [_span("solve", rid, None, rid, error=error),
            _span(f"{model} static setup", rid + 1, rid, rid)]
    if kind is not None:
        tree.append(_span(f"{model} setup ({kind})", rid + 2, rid + 1, rid))
    return tree


def _run(n):
    return SimpleNamespace(requests=[SimpleNamespace(error=None)
                                     for _ in range(n)])


def _read(spans, run, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: spans, raising=False)
    return spec.metric(NAME).read(run)


def test_kept_over_every_setup(monkeypatch):
    """The warm-up's build (before the window) and a failed request's
    set-up are left out; a window of builds alone reads 0, one of J
    changes alone 100."""
    spans = (_request(1, "built") + _request(10, "sources")
             + _request(20, "reused") + _request(30, "built")
             + _request(40, "sources"))
    assert _read(spans, _run(4), monkeypatch) == pytest.approx(75.0)
    spans += _request(50, "built", error=True)
    run = _run(5)
    run.requests[4].error = "RuntimeError: planted"
    assert _read(spans, run, monkeypatch) == pytest.approx(75.0)
    built = _request(10, "built") + _request(20, "built")
    assert _read(built, _run(2), monkeypatch) == 0.0
    sweep = _request(1, "built") + sum(
        (_request(10 * k, "sources") for k in range(1, 5)), [])
    assert _read(sweep, _run(4), monkeypatch) == pytest.approx(100.0)


def test_none_without_spans(monkeypatch):
    """None without spans, where no request opened a set-up span, and
    where only the planar model's set-up spans are there."""
    assert _read([], _run(2), monkeypatch) is None
    older = _request(10, None) + _request(20, None)
    assert _read(older, _run(2), monkeypatch) is None
    planar = _request(10, "sources", model="mag") + _request(
        20, "reused", model="mag")
    assert _read(planar, _run(2), monkeypatch) is None
    monkeypatch.delattr(profiling, "spans")
    assert spec.metric(NAME).read(_run(1)) is None
