"""The heat model's set-up tier (``models/heatflow._HEAT_SETUP_CACHE``) on
the CPU.

The static set-up, the solver Session and the K(T) loop's device data are
kept per mesh, device and every property but the sources: a new problem
on the same mesh whose block properties differ only in ``qv`` refreshes
``qv`` and the loop's right-hand side ("heat setup (sources)"), the same
problem again takes all of it ("heat setup (reused)"), and any other
change builds anew ("heat setup (built)"). Each answer is held to a solve
of the same problem from empty caches at 1e-7 of max|T| (both accept at
Precision 1e-8). The port runs with ``device="cpu"``, the band engine
from 4 x 64 unknowns and the device loop on, as in
``tests/test_torch_heatflow.py``'s ``port_band``.
"""

import collections
from pathlib import Path

import numpy as np
import pytest
import torch

from xfemm_tpu_torch.constants import ProblemType
from xfemm_tpu_torch.geometry import femfile
from xfemm_tpu_torch.mesh import mesher
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files
from xfemm_tpu_torch.models import benchprob
from xfemm_tpu_torch.models import heatflow
from xfemm_tpu_torch.ops import newton
from xfemm_tpu_torch.ops import solver
from xfemm_tpu_torch.utils import profiling

FIXTURES = Path(__file__).parent / "fixtures"
ON_CPU = dict(device="cpu", hbm_bytes=16e9)
CACHES = ((solver, "_BAND_CACHE"), (solver, "_PATTERN_CACHE"),
          (heatflow, "_HEAT_SETUP_CACHE"))

torch.set_num_threads(1)


@pytest.fixture
def port_band(monkeypatch):
    """The port on the band engine from 4 x 64 unknowns, the device loop
    on, fresh caches; its CPU path fails on any CUDA call."""
    monkeypatch.delenv("XFEMM_TPU_NO_DEVICE_NEWTON", raising=False)
    monkeypatch.setattr(solver, "ROW_TILE_MIN", 64)
    for mod, name in CACHES:
        monkeypatch.setattr(mod, name, collections.OrderedDict())

    def no_cuda(*a, **k):
        raise AssertionError("a CPU run touched CUDA")

    for name in ("is_available", "mem_get_info", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    return monkeypatch


@pytest.fixture
def tracing(monkeypatch):
    """Tracing on, with no spans from before."""
    monkeypatch.setattr(profiling, "ENABLED", True)
    profiling.reset()
    yield
    profiling.reset()


def count_calls(mp, mod, name):
    calls = []
    real = getattr(mod, name)

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls.append(out)
        return out

    mp.setattr(mod, name, counted)
    return calls


def heated_core(qv: float, nodes: int = 3_000):
    """``benchprob.build_heat`` (the heat230k cell's problem) at about
    ``nodes`` nodes with core source ``qv`` and a 5 W point source on the
    core's arc at (0.3, 0)."""
    p = benchprob.build_heat(nodes)
    p.blockproplist[1].qv = qv
    p.nodeproplist[0].qp = 5.0
    assert (p.nodelist[4].x, p.nodelist[4].y) == (0.3, 0.0)
    p.nodelist[4].BoundaryMarker = 0
    return p


def cold(mp, problem, mesh):
    """``problem`` solved from empty caches (the module's caches are then
    new ones, holding this solve's entries)."""
    for mod, name in CACHES:
        mp.setattr(mod, name, collections.OrderedDict())
    return heatflow.solve(problem, mesh, **ON_CPU)


def assert_close(sol, ref, tol=1e-7):
    assert np.abs(sol.T - ref.T).max() <= tol * np.abs(ref.T).max()


def kinds():
    """The set-up kind of each heat solve traced, in order; every one
    under a "heat static setup" span."""
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        if s.name.startswith("heat setup ("):
            assert by_id[s.parent].name == "heat static setup"
            out.append(s.name[len("heat setup ("):-1])
    return out


def test_source_sweep_builds_once(port_band, tracing):
    """A qv sweep on one mesh: new problems (as the benchmark's traffic
    sends), the same problem again, and that problem with its qv edited
    in place (a pyFEMM or Lua edit and re-analysis). The static set-up
    and the loop are built once; the loop runs in every solve; each
    answer equals its cold solve."""
    mesh = mesher.mesh_problem(heated_core(2e4))
    built = count_calls(port_band, heatflow, "_setup_static")
    loops = count_calls(port_band, newton, "setup_heat")
    runs = count_calls(port_band, newton, "run_heat")
    problems = [heated_core(q) for q in (2e4, 1e4, 3e4)]
    sols = [heatflow.solve(p, mesh, **ON_CPU) for p in problems]
    sols.append(heatflow.solve(problems[-1], mesh, **ON_CPU))
    problems[-1].blockproplist[1].qv = 1.5e4
    sols.append(heatflow.solve(problems[-1], mesh, **ON_CPU))
    assert kinds() == ["built", "sources", "sources", "reused", "sources"]
    assert len(built) == 1
    assert len(loops) == 1 and loops[0] is not None
    assert len(runs) >= len(sols)
    for q, sol in zip((2e4, 1e4, 3e4, 3e4, 1.5e4), sols):
        assert sol.residual <= 1e-8
        assert_close(sol, cold(port_band, heated_core(q), mesh))
    # the sources moved the answer far beyond that tolerance
    assert np.abs(sols[2].T - sols[1].T).max() > 1e-2 * np.abs(sols[2].T).max()


@pytest.mark.parametrize("transient", [False, True],
                         ids=["steady", "transient"])
def test_kept_loop_takes_the_new_rhs(port_band, transient):
    """After a tier hit under a new qv (or a transient step's: the same dT
    and Tprev, the medium's K(T) elements on the fixed boundary) the
    kept loop's right-hand side equals (1e-6 of its largest) the one a
    cold ``setup_heat`` builds for that qv, and differs from the
    previous qv's beyond 1e-4; its other fields are the ones built for
    the first qv. (A stale right-hand side would not show in the
    answer: the host's accepting pass corrects it.)"""
    def problem(qv):
        p = heated_core(qv)
        if transient:
            p.dT = 50.0
            for m in p.blockproplist:
                m.Kt = 2.0
            p.blockproplist[0].Tdata = [0.0, 1000.0]
            p.blockproplist[0].Kdata = [0.8, 1.2]
        return p

    mesh = mesher.mesh_problem(heated_core(2e4))
    Tprev = np.full(mesh.num_nodes, 320.0) if transient else None
    loops = count_calls(port_band, newton, "setup_heat")
    heatflow.solve(problem(2e4), mesh, Tprev=Tprev, **ON_CPU)
    heatflow.solve(problem(3e4), mesh, Tprev=Tprev, **ON_CPU)
    assert len(loops) == 1
    kept = next(iter(heatflow._HEAT_SETUP_CACHE.values()))[1].dev_heat[1]
    for mod, name in CACHES:
        port_band.setattr(mod, name, collections.OrderedDict())
    heatflow.solve(problem(3e4), mesh, Tprev=Tprev, **ON_CPU)
    first, fresh = loops
    assert (float(first.mat_0.abs().max()) > 0.0) == transient
    scale = float(fresh.rhs_pre.abs().max())
    assert float((kept.rhs_pre - fresh.rhs_pre).abs().max()) <= 1e-6 * scale
    assert float((first.rhs_pre - fresh.rhs_pre).abs().max()) > 1e-4 * scale
    for name in newton.DeviceHeat._fields:
        if name != "rhs_pre":
            assert getattr(kept, name) is getattr(first, name), name


def _medium_k(p):
    p.blockproplist[0].Kx = p.blockproplist[0].Ky = 1.6


def _boundary_tset(p):
    p.lineproplist[0].Tset = 350.0


def _point_source(p):
    p.nodeproplist[0].qp = 50.0


@pytest.mark.parametrize("edit", [_medium_k, _boundary_tset, _point_source],
                         ids=["medium K", "boundary Tset", "point source"])
def test_other_edits_build_again(port_band, tracing, edit):
    """A change of anything but the sources between two solves on one
    mesh (the same problem edited in place) builds the set-up again; a
    new problem of the edited content then takes that set-up. The
    answers equal the cold solve and differ from the unedited
    problem's."""
    mesh = mesher.mesh_problem(heated_core(2e4))
    built = count_calls(port_band, heatflow, "_setup_static")
    p = heated_core(2e4)
    base = heatflow.solve(p, mesh, **ON_CPU)
    edit(p)
    sol = heatflow.solve(p, mesh, **ON_CPU)
    q = heated_core(2e4)
    edit(q)
    again = heatflow.solve(q, mesh, **ON_CPU)
    assert kinds() == ["built", "built", "reused"]
    assert len(built) == 2
    ref = cold(port_band, q, mesh)
    assert_close(sol, ref)
    assert_close(again, ref)
    assert np.abs(sol.T - base.T).max() > 1e-4 * np.abs(base.T).max()


def test_another_mesh_builds_its_own(port_band):
    """Equal problems on two meshes of other densities each build their
    own set-up, and an entry whose mesh is another never serves a mesh,
    even under its key (as when a freed mesh's id passes to a new
    one)."""
    mesh_a = mesher.mesh_problem(heated_core(2e4, 2_000))
    mesh_b = mesher.mesh_problem(heated_core(2e4))
    assert mesh_a.num_nodes != mesh_b.num_nodes
    built = count_calls(port_band, heatflow, "_setup_static")
    heatflow.solve(heated_core(2e4), mesh_a, **ON_CPU)
    sol_b = heatflow.solve(heated_core(2e4), mesh_b, **ON_CPU)
    assert len(built) == 2
    cache = heatflow._HEAT_SETUP_CACHE
    (key_a, entry_a), = [(k, v) for k, v in cache.items()
                         if v[1].mesh is mesh_a]
    cache.clear()
    cache[(id(mesh_b),) + key_a[1:]] = entry_a
    again = heatflow.solve(heated_core(2e4), mesh_b, **ON_CPU)
    assert len(built) == 3
    assert built[2].mesh is mesh_b
    ref = cold(port_band, heated_core(2e4), mesh_b)
    assert_close(sol_b, ref)
    assert_close(again, ref)


def test_axisymmetric_sources_match_cold(port_band, tracing):
    """HeatTemp0 (K(T) air, convection walls) as an axisymmetric problem
    under two brick sources on one mesh: the second takes the set-up and
    the loop, and each answer equals its cold solve."""
    mesh = read_mesh_files(str(FIXTURES / "HeatTemp0"))

    def problem(qv):
        p = femfile.load(str(FIXTURES / "HeatTemp0.feh"))
        p.ProblemType = ProblemType.AXISYMMETRIC
        assert p.blockproplist[0].qv == 10.0
        p.blockproplist[0].qv = qv
        return p

    loops = count_calls(port_band, newton, "setup_heat")
    sols = [heatflow.solve(problem(q), mesh, **ON_CPU) for q in (10.0, 25.0)]
    assert kinds() == ["built", "sources"]
    assert len(loops) == 1 and loops[0] is not None
    for q, sol in zip((10.0, 25.0), sols):
        assert sol.residual <= 1e-8
        assert_close(sol, cold(port_band, problem(q), mesh))
    assert np.abs(sols[1].T - sols[0].T).max() > 1e-4 * np.abs(sols[1].T).max()
