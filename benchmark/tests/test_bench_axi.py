"""The ``axi250k.sweep`` cell's files, reference and reader.

The plain reference (``reference/axisymmetric.py``) meets the golden
answer of the unmodified upstream fsolver on the premeshed AxiSolenoid
fixture, its log-mean radius integral meets closed forms, the problem
module is the fixture's problem, the configuration and traffic load by
name, the traffic takes every stratum of 1-4 MA/m^2 once per cycle, the
program's answers meet the configuration's ``gap`` limit and the
control's (the reference in float32) do not, ``host_newton_passes``
reads made-up spans as its docstring says, and a whole traced run of
the cell on the CPU at ~15k nodes comes out correct."""

import math
import pathlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from benchmark import run, spec
from benchmark.reference import axisymmetric
from benchmark.traffic import Traffic
from xfemm_tpu_torch.utils import profiling

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"
BENCH = spec.load_benchmark()
CONFIG = spec.config(BENCH, "axi250k")
MOD = spec.problem(CONFIG["problem"])
#: a CPU size: every MaxArea at a quarter of the source's, 15,415 nodes
SMALL = {"area_scale": 0.25}
#: the accepted metrics the cell reports, and the one it adds
SHARED = ("model_host_s", "session_setup_s", "cg_per_solve",
          "loop_setup_s", "loop_device_s", "masked_share",
          "masked_device_s", "op_roofline", "bt_roofline",
          "device_idle_share")


def _fixture_reference():
    from xfemm_tpu_torch.mesh.meshdata import read_mesh_files
    mesh = read_mesh_files(str(FIXTURES / "AxiSolenoid"))
    params = CONFIG["params"]
    return mesh, MOD.reference(params, mesh.nodes, mesh.elements,
                               mesh.element_labels)


def test_reference_reproduces_axisolenoid_golden():
    """The fixture's mesh (6,415 nodes, its labels in the source's order,
    which is LABELS') and J 3 MA/m^2: the golden flux to 2e-6 of its
    largest (the planar reference meets Temp's golden to 1.37e-6), and
    the judge reads the golden's distance from the reference's answer."""
    from xfemm_tpu_torch.io import ansfile

    mesh, ref = _fixture_reference()
    flux, steps = axisymmetric.solve(ref)
    assert steps <= 10
    g = ansfile.read_ans(str(FIXTURES / "AxiSolenoid.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-12
    Ag = np.real(g.values)
    assert np.abs(flux[idx] - Ag).max() / np.abs(Ag).max() < 2e-6
    golden = np.zeros_like(flux)
    golden[idx] = Ag
    err = np.abs(golden - flux).max() / np.abs(flux).max()
    assert MOD.judge(ref, golden) == pytest.approx(err, rel=0.05)
    # on the axis and the outer edge the flux is 0
    assert np.abs(flux[MOD.fixed_nodes(CONFIG["params"], mesh.nodes)]).max() \
        == 0.0


def test_judge_reads_a_broken_pin():
    """A flux that is not 0 on the axis breaks its pin: the judge reads
    it, relative to the largest flux."""
    mesh, ref = _fixture_reference()
    flux, _ = axisymmetric.solve(ref)
    on_axis = np.nonzero(mesh.nodes[:, 0] == 0.0)[0]
    broken = flux.copy()
    broken[on_axis[len(on_axis) // 2]] = 1e-3 * np.abs(flux).max()
    assert MOD.judge(ref, broken) == pytest.approx(1e-3, rel=0.01)
    assert MOD.judge(ref, flux[:-1]) == math.inf


def _tri(*corners):
    v = torch.tensor([corners], dtype=torch.float64)
    return axisymmetric.inverse_r_integral(v[:, :, 0], v[:, :, 1])[0].item()


@pytest.mark.parametrize("a,b,h", [(0.5, 2.0, 1.0), (1.0, 1.001, 0.3),
                                   (1.0, 1.0 + 1e-9, 2.0), (0.0, 2.0, 1.5)])
def test_inverse_r_integral_meets_closed_forms(a, b, h):
    """The right triangle (a, 0), (b, 0), (b, h): the integral of dA / r
    is h (1 - a ln(b / a) / (b - a)), h where a = 0; with its mirror
    (a, 0), (b, h), (a, h) the rectangle's h ln(b / a). Near a = b the
    series takes the closed form's place."""
    lower = _tri((a, 0.0), (b, 0.0), (b, h))
    if a == 0.0:
        assert lower == pytest.approx(h, rel=1e-14)
        return
    want = h * (1.0 - a * math.log(b / a) / (b - a))
    assert lower == pytest.approx(want, rel=1e-9, abs=1e-15)
    upper = _tri((a, 0.0), (b, h), (a, h))
    assert lower + upper == pytest.approx(h * math.log(b / a), rel=1e-9)


def test_problem_module_is_the_fixture():
    """``build`` at area_scale 1 gives AxiSolenoid.fem's problem: its
    nodes, segments and boundary, label points and MaxAreas, materials
    and B-H points, units, type and contract."""
    from xfemm_tpu_torch.geometry import femfile

    src = femfile.load(str(FIXTURES / "AxiSolenoid.fem"))
    got = MOD.build(dict(CONFIG["params"], area_scale=1.0))
    for k in ("Precision", "MinAngle", "LengthUnits", "ProblemType",
              "Frequency", "DoSmartMesh"):
        assert getattr(got, k) == getattr(src, k), k
    assert [(n.x, n.y) for n in got.nodelist] == \
        [(n.x, n.y) for n in src.nodelist]
    assert [(s.n0, s.n1, s.BoundaryMarker) for s in got.linelist] == \
        [(s.n0, s.n1, s.BoundaryMarker) for s in src.linelist]
    assert [b.BdryFormat for b in got.lineproplist] == \
        [b.BdryFormat for b in src.lineproplist]
    for g, s in zip(got.labellist, src.labellist, strict=True):
        assert (g.x, g.y, g.BlockType) == (s.x, s.y, s.BlockType)
        assert g.MaxArea == pytest.approx(s.MaxArea, rel=1e-12)
    for g, s in zip(got.blockproplist, src.blockproplist, strict=True):
        assert (g.name, g.mu_x, g.mu_y, complex(g.J), g.Bdata) == \
            (s.name, s.mu_x, s.mu_y, complex(s.J), s.Bdata)
        assert [complex(h) for h in g.Hdata] == \
            [complex(h) for h in s.Hdata]


def test_spec_loads_the_cell():
    w = spec.cell(BENCH, "axi250k.sweep")
    assert (w["config"], w["traffic"], w["chips"]) == \
        ("axi250k", "coil_sweep", 1)
    assert CONFIG["reduced"] == [] and CONFIG["regime"] == "bt-alone"
    assert CONFIG["params"]["area_scale"] == 0.0151
    assert set(CONFIG["phases"]) == {"model_host_s", "session_setup_s"}
    assert "axi static setup" in CONFIG["phases"]["model_host_s"]
    mix = spec.traffic("coil_sweep")
    assert mix["vary"] == {"J": [1.0, 4.0]}
    assert "set" not in mix and mix["mesh"] == "once"
    # 8-11 requests a window: too few for solve_p90_s
    assert {m["name"] for m in spec.metrics_for(
        BENCH, "axi250k.sweep", "end_to_end")} == \
        {"solve_s", "peak_mem_gib", "setup_s"}
    names = {m["name"] for m in spec.metrics_for(BENCH, "axi250k.sweep",
                                                 "per_layer")}
    assert names == set(SHARED) | {"host_newton_passes"}


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12345, 2 ** 33 + 1])
def test_traffic_takes_every_stratum_once_per_cycle(seed):
    t = Traffic(spec.traffic("coil_sweep"), seed)
    assert t.strata == 4
    for c in range(4):
        J = np.array([t.request(c * 4 + j)["J"] for j in range(4)])
        assert ((J >= 1.0) & (J < 4.0)).all()
        assert sorted(np.floor((J - 1.0) / 0.75).astype(int)) == [0, 1, 2, 3]
        assert all(set(t.request(c * 4 + j)) == {"J"} for j in range(4))


@pytest.fixture(scope="module")
def small():
    from xfemm_tpu_torch.mesh import mesher
    params = dict(CONFIG["params"], **SMALL)
    mesh = mesher.mesh_problem(MOD.build(params))
    return params, mesh


@pytest.mark.parametrize("J", [1.0, 3.0, 4.0])
def test_program_meets_the_limit(J, small):
    """``models.solve`` on the CPU at ~15k nodes: within the
    configuration's ``gap`` limit, the mesh within its checks."""
    from benchmark import meshcheck
    from xfemm_tpu_torch import models

    params, mesh = small
    params = dict(params, J=J)
    checks = meshcheck.check(MOD, params, mesh)
    assert 14000 < len(mesh.nodes) < 17000
    sol = models.solve(MOD.build(params), mesh, device="cpu", hbm_bytes=2e9)
    ref = MOD.reference(params, mesh.nodes, mesh.elements,
                        mesh.element_labels)
    checks["gap"] = MOD.judge(ref, MOD.answer(sol))
    for k, limit in CONFIG["limits"].items():
        assert checks[k] <= limit, (k, checks[k])


def test_control_fails_the_limit():
    """The control, the reference's own Newton solve in float32
    throughout, reads above the ``gap`` limit at the source's J on a
    quarter of the cell's node count (63,764 nodes: 8.4e-6 there; the
    card's readings at the cell's size are in PERF.md). Its reading
    grows with the node count and moves with J: at 15,415 nodes it read
    1.4e-6 to 4.5e-6 over J 1, 3 and 4."""
    from xfemm_tpu_torch.mesh import mesher

    params = dict(CONFIG["params"], area_scale=0.06)
    mesh = mesher.mesh_problem(MOD.build(params))
    assert 60000 < len(mesh.nodes) < 68000
    ref = MOD.reference(params, mesh.nodes, mesh.elements,
                        mesh.element_labels)
    x32, _ = MOD.reference_solve(ref, dtype=np.float32)
    assert MOD.judge(ref, x32) > CONFIG["limits"]["gap"]


def _span(name, sid, parent, request):
    return SimpleNamespace(name=name, id=sid, parent=parent,
                           request=request, start_ns=0, end_ns=1,
                           device_start_ns=None, device_end_ns=None,
                           error=False)


def _request(rid, passes, error=False):
    """One axisymmetric "solve" tree with ``passes`` host passes and one
    device Newton run."""
    root = _span("solve", rid, None, rid)
    root.error = error
    out = [root, _span("axi static setup", rid + 1, rid, rid),
           _span("device newton", rid + 2, rid, rid)]
    out += [_span("newton host", rid + 3 + k, rid, rid)
            for k in range(passes)]
    return out


def _read(spans, n, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: spans, raising=False)
    requests = [SimpleNamespace(error=None, iterations=1, phases={})
                for _ in range(n)]
    return spec.metric("host_newton_passes").read(
        SimpleNamespace(requests=requests))


def test_host_newton_passes_counts_the_spans(monkeypatch):
    # the older root (before the window) is not among the last two
    spans = _request(1, 9) + _request(100, 3) + _request(200, 6)
    assert _read(spans, 2, monkeypatch) == 4.5
    # a request with no host pass counts 0
    assert _read(_request(100, 0) + _request(200, 5), 2,
                 monkeypatch) == 2.5
    # a request an exception went through is left out
    spans = _request(100, 4) + _request(200, 8, error=True)
    assert _read(spans, 2, monkeypatch) == 4.0


def test_host_newton_passes_reads_none_without_spans(monkeypatch):
    assert _read([], 1, monkeypatch) is None
    assert _read(_request(100, 3, error=True), 1, monkeypatch) is None
    assert _read(_request(100, 3), 0, monkeypatch) is None
    monkeypatch.delattr(profiling, "spans")
    assert spec.metric("host_newton_passes").read(
        SimpleNamespace(requests=[SimpleNamespace(error=None)])) is None


def test_model_host_s_sums_the_axi_phases():
    done = SimpleNamespace(error=None, phases={
        "pack": 0.25, "geometry": 0.125, "axi static setup": 0.5,
        "element matrices": 0.25, "newton host": 1.0, "solve": 9.0,
        "device newton": 9.0})
    failed = SimpleNamespace(error="RuntimeError: planted", phases={
        "pack": 9.0})
    got = spec.metric("model_host_s").read(
        SimpleNamespace(requests=[done, failed], config=CONFIG))
    assert got == pytest.approx(2.125)


def test_traced_run_on_the_cpu():
    out, window = run.run_cell("axi250k.sweep", 2 ** 31 + 5, 3.0, True,
                               device="cpu", hbm_bytes=2e9, override=SMALL,
                               config_override={"regime": None},
                               t0=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and window.requests
    got = out["metrics"]
    assert got["host_newton_passes"]["value"] >= 1.0
    # no device times, kernels or sweeps on the CPU
    for name, value in got.items():
        assert value["value"] >= 0.0, name
    assert "breakdown" in out and "busy_s" in out["device"]
