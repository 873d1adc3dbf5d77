"""The ``ac125k.freq`` cell's files and readers: the configuration and
traffic load by name, the eddy-current regions' mesh resolves their
skin depth at the traffic's top frequency, the traffic takes every
stratum of 10-400 Hz once per cycle, the AC readers read made-up spans,
counters and trace summaries as their docstrings say
(``ac_apply_roofline``'s bytes by a hand count, and None on a window
with a fallback pass), and a whole traced run of the cell on the CPU at
~3700 nodes comes out correct with the readings the CPU has."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import run, spec
from benchmark.traffic import Traffic
from xfemm_tpu_torch.utils import profiling

BENCH = spec.load_benchmark()
READERS = ("ac_refresh_s", "ac_device_s", "gmres_per_solve",
           "ac_fallback_share", "ac_apply_roofline")
#: the accepted metrics the cell reports too
SHARED = ("model_host_s", "bt_roofline", "device_idle_share")
#: a CPU size: ~3700 nodes, the steel meshed for its skin depth at 10 Hz
SMALL = {"target_nodes": 3000, "skin_freq": 10.0}


def test_spec_loads_the_cell():
    w = spec.cell(BENCH, "ac125k.freq")
    assert (w["config"], w["traffic"], w["chips"]) == \
        ("ac125k", "freq_sweep", 1)
    config = spec.config(BENCH, "ac125k")
    assert "regime" not in config and config["reduced"] == []
    mod = spec.problem(config["problem"])
    p = mod.build(config["params"])
    assert p.Frequency == 50.0
    steel = p.blockproplist[2]
    assert (steel.name, steel.mu_x, steel.mu_y, steel.Cduct) == \
        ("LinSteel", 1000.0, 1000.0, 4.0)
    coil = p.labellist[1]
    assert (p.blockproplist[coil.BlockType].LamType, coil.Turns,
            p.circproplist[coil.InCircuit].Amps) == (3, 100, 10.0)
    mix = spec.traffic("freq_sweep")
    assert mix["vary"] == {"freq": [10.0, 400.0]}
    assert "set" not in mix and mix["mesh"] == "once"
    assert set(config["phases"]) == {"model_host_s"}
    names = {m["name"] for m in spec.metrics_for(BENCH, "ac125k.freq",
                                                 "per_layer")}
    assert names == set(READERS) | set(SHARED)
    assert {m["name"] for m in spec.metrics_for(
        BENCH, "ac125k.freq", "end_to_end")} == \
        {"solve_s", "solve_p90_s", "peak_mem_gib", "setup_s"}


def test_eddy_regions_resolve_the_skin_depth():
    """At the configuration's size every eddy-current region's MaxArea
    is at most the equilateral triangle of side half its skin depth at
    the traffic's top frequency; the other labels keep the source's
    MaxArea times one factor (0.05), and the steel's cap binds."""
    config = spec.config(BENCH, "ac125k")
    mod = spec.problem(config["problem"])
    params = config["params"]
    top = spec.traffic("freq_sweep")["vary"]["freq"][1]
    assert params["skin_freq"] == top and mod.SKIN_ELEMENTS == 2.0
    areas = dict(zip(mod.LABELS, mod.label_areas(params)))
    for name, mu_r, sigma in (("steel", 1000.0, 4.0), ("alum", 1.0, 35.0)):
        side = mod.skin_depth_cm(top, mu_r, sigma) / 2.0
        assert areas[name] <= np.sqrt(3.0) / 4.0 * side * side * (1 + 1e-12)
    assert mod.skin_depth_cm(top, 1000.0, 4.0) == pytest.approx(0.03979,
                                                                rel=1e-3)
    assert areas["steel"] < 0.05 * params["max_area"]["steel"]
    for name in ("air", "coil", "alum"):
        assert areas[name] == pytest.approx(
            0.05 * params["max_area"][name])
    assert mod.max_area(params) == areas["air"]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12345, 2 ** 33 + 1])
def test_traffic_takes_every_stratum_once_per_cycle(seed):
    t = Traffic(spec.traffic("freq_sweep"), seed)
    assert t.strata == 8
    for c in range(4):
        f = np.array([t.request(c * 8 + j)["freq"] for j in range(8)])
        assert ((f >= 10.0) & (f < 400.0)).all()
        assert sorted(np.floor((f - 10.0) / 48.75).astype(int)) == \
            list(range(8))
        assert all(set(t.request(c * 8 + j)) == {"freq"} for j in range(8))


def _span(name, sid, parent, request, host=None, device=None,
          error=False):
    ns = (lambda t: None if t is None else int(round(t * 1e9)))
    h0, h1 = host or (None, None)
    d0, d1 = device or (None, None)
    return SimpleNamespace(name=name, id=sid, parent=parent,
                           request=request, start_ns=ns(h0), end_ns=ns(h1),
                           device_start_ns=ns(d0), device_end_ns=ns(d1),
                           error=error)


def _request(rid, refresh, device, engines=("band gmres + bt",),
             error=False):
    """One AC "solve" tree: refresh spans whose host seconds add to
    ``refresh``, and one "ac pass" span per engine in ``engines`` around
    a device span of ``device`` seconds each."""
    out = [_span("solve", rid, None, rid, (0, 10), error=error),
           _span("ac band refresh", rid + 1, rid, rid, (1, 1 + refresh / 4)),
           _span("bt refactor (ac)", rid + 2, rid, rid, (2, 2 + refresh / 4),
                 (2, 2.5)),
           _span("ac band fill", rid + 3, rid, rid, (3, 3 + refresh / 2),
                 (3, 3.5))]
    for k, engine in enumerate(engines):
        sid = rid + 4 + 2 * k
        inner = ("device cg (ac pairs)" if engine == "jacobi pairs"
                 else "device gmres (ac)")
        out += [_span(f"ac pass ({engine})", sid, rid, rid, (4, 5)),
                _span(inner, sid + 1, sid, rid, (4, 5), (4, 4 + device))]
    return out


def _run(n, iterations=60, carried=0, trace=None, mesh=None):
    return SimpleNamespace(
        requests=[SimpleNamespace(error=None, iterations=iterations,
                                  phases={}, mesh=mesh)
                  for _ in range(n)],
        carried=carried, trace=trace, device_name="NVIDIA H100 80GB HBM3",
        op_bytes=[0] * n, config=spec.config(BENCH, "ac125k"))


def _read(name, spans, run, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: spans, raising=False)
    return spec.metric(name).read(run)


def test_span_readers(monkeypatch):
    # the older root (before the window) is not among the last two
    spans = (_request(1, 9.0, 9.0) + _request(100, 0.5, 0.25)
             + _request(200, 0.25, 0.125,
                        ("band gmres + bt", "band gmres + bt")))
    run = _run(2)
    assert _read("ac_refresh_s", spans, run, monkeypatch) == \
        pytest.approx(0.375)
    assert _read("ac_device_s", spans, run, monkeypatch) == \
        pytest.approx(0.25)
    assert _read("ac_fallback_share", spans, run, monkeypatch) == 0.0
    # one pass of five off the factor's engine
    spans = (_request(100, 0.5, 0.25, ("band gmres + bt",
                                       "band gmres + vcycle"))
             + _request(200, 0.5, 0.25, ("band gmres + vcycle",
                                         "jacobi pairs", "jacobi pairs")))
    assert _read("ac_fallback_share", spans, run, monkeypatch) == \
        pytest.approx(80.0)
    assert _read("ac_device_s", spans, run, monkeypatch) == \
        pytest.approx(0.625)


@pytest.mark.parametrize("name", ["ac_refresh_s", "ac_device_s",
                                  "ac_fallback_share"])
def test_span_readers_read_none_without_spans(name, monkeypatch):
    assert _read(name, [], _run(1), monkeypatch) is None
    roots = [s for s in _request(10, 0.5, 0.25) if s.name == "solve"]
    assert _read(name, roots, _run(1), monkeypatch) is None
    monkeypatch.delattr(profiling, "spans")
    assert spec.metric(name).read(_run(1)) is None


def test_model_host_s_sums_the_ac_phases():
    run = _run(2)
    run.requests[0].phases = {"pack": 0.25, "ac static setup": 0.5,
                              "ac elements": 0.125, "solve": 9.0}
    run.requests[1].phases = {"ac csr assembly": 0.125,
                              "ac band fill": 9.0}
    assert spec.metric("model_host_s").read(run) == pytest.approx(0.5)


def test_gmres_per_solve_leaves_out_the_pairs_iterations():
    read = spec.metric("gmres_per_solve").read
    assert read(_run(4, iterations=60)) == 60.0
    # 40 of the window's iterations were Jacobi pairs CG
    assert read(_run(4, iterations=70, carried=40)) == 60.0
    failed = _run(2)
    failed.requests[1].error = "RuntimeError: planted"
    assert read(failed) is None
    assert read(_run(0)) is None


def _summary(k1_events, sweeps=()):
    """A trace summary with two requests (0-100, 100-200 ns) and K1
    events (start, duration ns)."""
    return SimpleNamespace(
        roles={"operator_apply": [(s, d, {}) for s, d in k1_events],
               "bt_sweep": [(s, d, {}) for s, d in sweeps]},
        request_of=lambda t: 0 if 0 <= t <= 100 else (
            1 if 100 < t <= 200 else -1),
        sweep_calls=len(sweeps), sweep_bytes=1000 * len(sweeps))


def test_ac_apply_roofline_counts_bytes_by_hand(monkeypatch):
    """Two triangles of a unit square, node 3 fixed: the free nodes 0-2
    couple pairwise (9 nonzeros) and node 3 keeps a unit diagonal (1):
    10 f32 values and int32 columns, 5 int32 row pointers, and two f32
    columns of x read and two of y written, 4 nodes each: 164 bytes per
    launch."""
    from benchmark import roofline
    mesh = SimpleNamespace(nodes=np.array([[0, 0], [1, 0], [1, 1], [0, 1.]]),
                           elements=np.array([[0, 1, 2], [0, 2, 3]]))
    fixed = np.array([False, False, False, True])
    apply_bytes = roofline.csr_apply_bytes(mesh.elements, 4, fixed)
    assert apply_bytes + 8 * 4 == 10 * 4 + 10 * 4 + 5 * 4 + 2 * 2 * 4 * 4
    # three launches of 1 us in the window's requests, one outside
    run = _run(2, mesh=mesh, trace=_summary([(10, 1000), (50, 1000),
                                             (150, 1000), (500, 1000)]))
    run.op_bytes = [apply_bytes, apply_bytes]
    spans = _request(100, 0.5, 0.25) + _request(200, 0.5, 0.25)
    got = _read("ac_apply_roofline", spans, run, monkeypatch)
    assert got == pytest.approx(100.0 * (3 * 164 / 3.35e12) / 3e-6)
    # a window with a V-cycle pass: the V-cycle's K1 launches are not
    # the apply
    spans = (_request(100, 0.5, 0.25)
             + _request(200, 0.5, 0.25, ("band gmres + bt",
                                         "band gmres + vcycle")))
    assert _read("ac_apply_roofline", spans, run, monkeypatch) is None
    # no trace, or a card without published peaks
    run.trace = None
    assert _read("ac_apply_roofline", [], run, monkeypatch) is None


def test_bt_roofline_reads_the_ac_sweeps():
    """The AC GMRES applies the shifted real matrix's factor with the
    same ``bt_fwd`` / ``bt_qbwd`` launches the real solves use, so the
    accepted ``bt_roofline`` reads them unchanged."""
    run = _run(1, trace=_summary([], sweeps=[(10, 1000), (20, 1000)]))
    assert spec.metric("bt_roofline").read(run) == \
        pytest.approx(100.0 * (2000 / 3.35e12) / 2e-6)


def test_traced_run_on_the_cpu():
    out, window = run.run_cell("ac125k.freq", 2 ** 31 + 5, 2.0, True,
                               device="cpu", hbm_bytes=2e9,
                               override=SMALL,
                               t0=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and window.requests
    got = out["metrics"]
    # no device times, kernels or sweeps on the CPU
    assert set(got) == {"model_host_s", "ac_refresh_s", "gmres_per_solve",
                        "ac_fallback_share", "device_idle_share"}
    assert got["ac_fallback_share"]["value"] == 0.0
    assert got["gmres_per_solve"]["value"] > 0
    assert got["model_host_s"]["value"] > 0
    assert got["ac_refresh_s"]["value"] > 0
