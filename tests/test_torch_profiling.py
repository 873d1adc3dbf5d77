"""The port's tracer (``xfemm_tpu_torch/utils/profiling.py``) on the CPU.

With tracing off a phase records nothing. With it on, each phase is a
span: meshing is one root "mesh", and a small magnetostatic and a small
heat-flow solve through ``models.solve`` each give one tree under one
root "solve", whose id every span under it carries; host intervals nest
as the spans do; the device fields stay None without a CUDA device. A span that raises is
marked and its thread's stack unwinds. Under a CPU ``torch.profiler``
every span is a ``phase:<name>`` range, nested as the spans nest. The
loop driver (``ops/loop.py``) records no masked tail on the CPU, and
its counts are those of ``tests/test_torch_loop_driver.py``.
"""

import collections
import threading

import pytest
import torch

from xfemm_tpu_torch import models
from xfemm_tpu_torch.mesh import mesher
from xfemm_tpu_torch.models import benchprob
from xfemm_tpu_torch.models import heatflow
from xfemm_tpu_torch.models import magnetostatics
from xfemm_tpu_torch.ops import loop
from xfemm_tpu_torch.ops import solver
from xfemm_tpu_torch.utils import profiling

torch.set_num_threads(1)

ON_CPU = dict(device="cpu", hbm_bytes=16e9)


@pytest.fixture
def tracing(monkeypatch):
    """Tracing on, with no spans or sums from before."""
    monkeypatch.setattr(profiling, "ENABLED", True)
    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.fixture
def small_band(monkeypatch):
    """The band engine and the device loop from 4 x 64 unknowns, fresh
    caches."""
    monkeypatch.delenv("XFEMM_TPU_NO_DEVICE_NEWTON", raising=False)
    monkeypatch.setattr(solver, "ROW_TILE_MIN", 64)
    for mod, name in ((solver, "_BAND_CACHE"), (solver, "_PATTERN_CACHE"),
                      (magnetostatics, "_PACK_CACHE"),
                      (heatflow, "_HEAT_SETUP_CACHE")):
        monkeypatch.setattr(mod, name, collections.OrderedDict())


def _nest(spans):
    """{span id: span} after checking that each child's host interval
    lies in its parent's."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (p, s)
    return by_id


def test_off_records_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "ENABLED", False)
    profiling.reset()
    with profiling.phase("off"), profiling.phase("dev", device=True):
        pass
    assert profiling.spans() == []
    assert profiling.snapshot() == {} and profiling.phase_seconds("off") == 0
    assert not hasattr(profiling, "trace")


def test_on_keeps_the_host_sums(tracing):
    for _ in range(3):
        with profiling.phase("a"):
            with profiling.phase("b", device=True):
                pass
    assert profiling._cnt == {"a": 3, "b": 3}
    spans = profiling.spans()
    assert [s.name for s in spans] == ["a", "b"] * 3
    assert profiling.phase_seconds("a") == pytest.approx(sum(
        s.end_ns - s.start_ns for s in spans if s.name == "a") * 1e-9)
    assert "device" not in profiling.report()    # no device on the CPU
    profiling.reset()
    assert profiling.spans() == [] and profiling.snapshot() == {}


@pytest.mark.parametrize("build,loop_names", [
    (benchprob.build, {"newton loop setup", "device newton"}),
    (benchprob.build_heat, {"heat loop setup", "device heat"}),
], ids=["magnetostatic", "heat"])
def test_one_tree_per_solve(tracing, small_band, build, loop_names):
    problem = build(3_000)
    mesh = mesher.mesh_problem(problem)
    for _ in range(2):
        models.solve(build(3_000), mesh, **ON_CPU)
    spans = profiling.spans()
    by_id = _nest(spans)
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["mesh", "solve", "solve"]
    roots = roots[1:]
    for s in spans:
        assert s.request == (s.id if s.parent is None else
                             by_id[s.parent].request)
        assert s.device_start_ns is None and s.device_end_ns is None
        assert not s.error
    first = {s.name for s in spans if s.request == roots[0].id}
    assert loop_names | {"device cg", "host csr assembly"} <= first
    assert profiling._stack() == []


def test_a_raising_span_is_marked(tracing):
    with pytest.raises(ValueError):
        with profiling.phase("outer"):
            with profiling.phase("inner"):
                raise ValueError("planted")
    with profiling.phase("after"):
        pass
    outer, inner, after = profiling.spans()
    assert outer.error and inner.error and not after.error
    assert inner.parent == outer.id and after.parent is None
    assert after.request == after.id != outer.request
    assert profiling._stack() == []


def test_each_thread_has_its_own_stack(tracing):
    def work():
        with profiling.phase("worker"):
            pass

    with profiling.phase("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    spans = {s.name: s for s in profiling.spans()}
    assert spans["worker"].parent is None
    assert spans["worker"].request == spans["worker"].id


def test_device_record_outside_a_span_is_dropped(tracing):
    profiling.device_record("masked tail", None, None, "bt")
    with profiling.phase("cpu"):
        profiling.device_record("masked tail", None, None, "bt")
    assert [s.name for s in profiling.spans()] == ["cpu"]


def test_the_store_is_bounded(tracing, monkeypatch):
    monkeypatch.setattr(profiling, "_SPANS", collections.deque(maxlen=3))
    for k in range(5):
        with profiling.phase(f"p{k}"):
            pass
    assert [s.name for s in profiling.spans()] == ["p2", "p3", "p4"]


def test_spans_are_profiler_ranges(tracing, small_band):
    """Under a CPU ``torch.profiler`` each span is one ``phase:<name>``
    range, in the order the spans open, each inside its parent's."""
    problem = benchprob.build(3_000)
    mesh = mesher.mesh_problem(problem)
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        models.solve(problem, mesh, **ON_CPU)
    spans = profiling.spans()
    marks = sorted(((e.time_range.start, -e.time_range.end, e.name)
                    for e in prof.events() if e.name.startswith("phase:")))
    assert [m[2] for m in marks] == ["phase:" + s.name for s in spans]
    at = {s.id: (m[0], -m[1]) for s, m in zip(spans, marks)}
    for s in spans:
        if s.parent is not None:
            (a, b), (c, d) = at[s.parent], at[s.id]
            assert a <= c <= d <= b, s


def _synthetic(stop_at: int):
    """``tests/test_torch_loop_driver.py``'s loop: its flag is
    ``it < stop_at``; a step adds 1/(it + 1) to x where active."""
    st = dict(x=torch.zeros((), dtype=torch.float32),
              it=torch.zeros((), dtype=torch.int32))

    def running():
        return st["it"] < stop_at

    def step(active):
        inc = 1.0 / (st["it"].to(torch.float32) + 1.0)
        st["x"] = st["x"] + torch.where(active, inc, torch.zeros_like(inc))
        st["it"] = st["it"] + active.to(torch.int32)

    return st, running, step


@pytest.mark.parametrize("limit", [5, None])
@pytest.mark.parametrize("stop_at", [0, 3, 5, 7])
def test_loop_tally_records_nothing_on_the_cpu(tracing, stop_at, limit):
    masked0 = loop.MASKED["band"]
    st, running, step = _synthetic(stop_at)
    launched = 0
    with profiling.phase("device cg", device=True):
        while True:
            launched += loop.masked_loop(running, step, "band", limit)
            if not bool(running()):
                break
        loop.tally("band", launched, int(st["it"]))
    masked = loop.MASKED["band"] - masked0
    if limit is None:
        want = loop.IN_FLIGHT
    elif stop_at > 0 and stop_at % limit == 0:
        want = 0
    else:
        want = min(loop.IN_FLIGHT, limit - stop_at % limit)
    assert int(st["it"]) == stop_at and masked == want
    assert loop._TAILS == []
    assert [s.name for s in profiling.spans()] == ["device cg"]
