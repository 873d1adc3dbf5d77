"""The magnetostatic model's set-up tier
(``models/magnetostatics._PACK_CACHE``) on the CPU.

The pack, geometry, static terms, the solver Session, the it-0 element
blocks and the device Newton loop's data are kept per mesh, device and
every property but the blocks' J: a new problem on the same mesh whose
block properties differ only in J refreshes J, the circuits, the static
and it-0 right-hand sides and the loop's ``rhs_base`` ("mag setup
(sources)"), the same problem again takes all of it ("mag setup
(reused)"), and any other change builds anew ("mag setup (built)"). Each
answer is held to a solve of the same problem from empty caches at 1e-5
of max|A| (both accept at Precision 1e-8: the repeat-solve standard of
``tests/test_torch_newton_solve.py``). The port runs with
``device="cpu"``, the band engine from 4 x 64 unknowns and the device
loop on, as ``tests/test_torch_heat_setup_tier.py``'s ``port_band``; the
host chain (``XFEMM_TPU_NO_DEVICE_NEWTON=1``) where named. A "sources"
answer and the circuit case are also held to the JAX package's solve of
the same problem at 1e-5 of max|A| (the port-vs-JAX standard of
``tests/test_torch_newton_solve.py``).
"""

import collections

import numpy as np
import pytest
import torch

from xfemm_tpu.geometry.problem import Circuit as JCircuit
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu.models import magnetostatics as jmag
from xfemm_tpu_torch.geometry.problem import Circuit
from xfemm_tpu_torch.io import ansfile
from xfemm_tpu_torch.mesh import mesher
from xfemm_tpu_torch.models import benchprob
from xfemm_tpu_torch.models import magnetostatics
from xfemm_tpu_torch.ops import newton
from xfemm_tpu_torch.ops import solver
from xfemm_tpu_torch.utils import profiling

ON_CPU = dict(device="cpu", hbm_bytes=16e9)
CACHES = ((solver, "_BAND_CACHE"), (solver, "_PATTERN_CACHE"),
          (magnetostatics, "_PACK_CACHE"))

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


def coil_cylinder(J: float, nodes: int = 3_000, circuit: bool = False,
                  jax: bool = False):
    """``benchprob.build`` (the mag250k cell's problem) at about
    ``nodes`` nodes with coil current densities +J and -J (MA/m^2);
    ``circuit`` puts the Coil+ label in a parallel circuit of 2 kA on
    top of its block J. ``jax``: the JAX package's problem."""
    p = (jbench if jax else benchprob).build(nodes)
    p.blockproplist[2].J = J
    p.blockproplist[3].J = -J
    if circuit:
        p.circproplist = [(JCircuit if jax else Circuit)(
            name="drive", Amps=2000.0, CircType=0)]
        coil = [lab for lab in p.labellist if lab.BlockType == 2]
        assert len(coil) == 1
        coil[0].InCircuit = 0
    return p


def cold(mp, problem, mesh):
    """``problem`` solved from empty caches (the module's caches are then
    new ones, holding this solve's entries)."""
    for mod, name in CACHES:
        mp.setattr(mod, name, collections.OrderedDict())
    return magnetostatics.solve(problem, mesh, **ON_CPU)


_JAX_ANSWERS = {}


def jax_solve(J: float, mesh, circuit: bool = False):
    """The JAX package's answer for ``coil_cylinder(J, circuit=circuit)``
    on ``mesh`` (computed once per module)."""
    key = (J, circuit, mesh.num_nodes)
    if key not in _JAX_ANSWERS:
        _JAX_ANSWERS[key] = jmag.solve(
            coil_cylinder(J, circuit=circuit, jax=True), mesh)
        jmag._PACK_CACHE.clear()
    return _JAX_ANSWERS[key]


def assert_close(sol, ref, tol=1e-5):
    assert sol.residual <= 1e-8 and np.isfinite(sol.A).all()
    assert np.abs(sol.A - ref.A).max() <= tol * np.abs(ref.A).max()


def kinds():
    """The set-up kind of each magnetostatic solve traced, in order;
    every one under a "mag static setup" span."""
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        if s.name.startswith("mag setup ("):
            assert by_id[s.parent].name == "mag static setup"
            out.append(s.name[len("mag setup ("):-1])
    return out


def record_starts(mp):
    """Each host linear solve's system (the volume block's matrices and
    the right-hand side, copied) and each device loop dispatch's start
    (max|V|), in call order."""
    events = []
    real_solve, real_run = solver.solve, newton.run

    def host_solve(blocks, b, *a, **kw):
        events.append(("solve", blocks[0].mat.copy(), np.array(b)))
        return real_solve(blocks, b, *a, **kw)

    def run(dn, amg, V, *a, **kw):
        events.append(("run", float(V.abs().max())))
        return real_run(dn, amg, V, *a, **kw)

    mp.setattr(solver, "solve", host_solve)
    mp.setattr(newton, "run", run)
    return events


@pytest.mark.parametrize("chain", ["device loop", "host chain"])
def test_current_sweep_builds_once(port_band, tracing, chain):
    """A J sweep on one mesh: new problems (as the benchmark's traffic
    sends), the same problem again, and that problem with its J edited
    in place (a pyFEMM or Lua edit and re-analysis). The set-up and the
    loop's data are built once; each answer equals its cold solve, and
    the answers of different J differ. After the first solve the device
    loop starts each solve from V = 0 (a kept it-0 solution serves only
    its own J); on the host chain each solve's iteration 0 solves its
    cold solve's system exactly, though the kept it-0 blocks' nonlinear
    slots hold the previous solve's Newton matrices when it starts."""
    if chain == "host chain":
        port_band.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")
    mesh = mesher.mesh_problem(coil_cylinder(2.0))
    packs = count_calls(port_band, magnetostatics, "pack")
    loops = count_calls(port_band, newton, "setup")
    events = record_starts(port_band)
    firsts = []

    def solve(p):
        n = len(events)
        sol = magnetostatics.solve(p, mesh, **ON_CPU)
        firsts.append(events[n])
        return sol

    problems = [coil_cylinder(J) for J in (2.0, 1.0, 3.0)]
    sols = [solve(p) for p in problems]
    sols.append(solve(problems[-1]))
    problems[-1].blockproplist[2].J = 1.5
    problems[-1].blockproplist[3].J = -1.5
    sols.append(solve(problems[-1]))
    assert kinds() == ["built", "sources", "sources", "reused", "sources"]
    assert len(packs) == 1
    if chain == "device loop":
        assert len(loops) == 1 and loops[0] is not None
        assert firsts[0][0] == "solve"
        assert [e for e in firsts[1:]] == [("run", 0.0)] * 4
    else:
        assert loops == [] and not any(e[0] == "run" for e in events)
    for i, (J, sol) in enumerate(zip((2.0, 1.0, 3.0, 3.0, 1.5), sols)):
        n = len(events)
        assert_close(sol, cold(port_band, coil_cylinder(J), mesh))
        if chain == "host chain":
            (_, mat, b), (_, mat_cold, b_cold) = firsts[i], events[n]
            assert np.array_equal(mat, mat_cold) and np.array_equal(b, b_cold)
    # J moved the answer far beyond that tolerance
    assert np.abs(sols[2].A - sols[1].A).max() > 0.1 * np.abs(sols[2].A).max()
    # a "sources" answer against the JAX package on the same problem
    assert_close(sols[1], jax_solve(1.0, mesh))


def test_kept_loop_takes_the_new_rhs(port_band):
    """After a tier hit under a new J the kept loop's ``rhs_base`` equals
    (1e-6 of its largest) the one a cold ``newton.setup`` builds for that
    J, and differs from the previous J's beyond 1e-4; every other field
    is the one built for the first J."""
    mesh = mesher.mesh_problem(coil_cylinder(2.0))
    loops = count_calls(port_band, newton, "setup")
    magnetostatics.solve(coil_cylinder(2.0), mesh, **ON_CPU)
    magnetostatics.solve(coil_cylinder(3.0), mesh, **ON_CPU)
    assert len(loops) == 1
    kept = next(iter(magnetostatics._PACK_CACHE.values()))[2]["dn"]
    cold(port_band, coil_cylinder(3.0), mesh)
    (first, first_lam), (fresh, _) = loops
    assert kept[1] == first_lam
    kept = kept[0]
    scale = float(fresh.rhs_base.abs().max())
    assert float((kept.rhs_base - fresh.rhs_base).abs().max()) \
        <= 1e-6 * scale
    assert float((first.rhs_base - fresh.rhs_base).abs().max()) \
        > 1e-4 * scale
    for name in newton.DeviceNewton._fields:
        if name != "rhs_base":
            assert getattr(kept, name) is getattr(first, name), name


@pytest.mark.parametrize("chain", ["device loop", "host chain"])
def test_circuit_takes_the_new_J(port_band, tracing, chain):
    """Coil+ in a parallel circuit: its current is the circuit's Amps
    less what the block J carries, so the circuit's J follows the block
    J. Under a new J the circuits' Case, J and dV, and the answer, equal
    the cold solve's; the first solution's circuits are left as they
    were."""
    if chain == "host chain":
        port_band.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")
    mesh = mesher.mesh_problem(coil_cylinder(2.0, circuit=True))
    first = magnetostatics.solve(coil_cylinder(2.0, circuit=True), mesh,
                                 **ON_CPU)
    first_J = [c.J for c in first.circuits]
    sol = magnetostatics.solve(coil_cylinder(3.0, circuit=True), mesh,
                               **ON_CPU)
    assert kinds() == ["built", "sources"]
    assert [c.J for c in first.circuits] == first_J
    ref = cold(port_band, coil_cylinder(3.0, circuit=True), mesh)
    assert_close(sol, ref)
    assert [(c.Case, c.J, c.dV) for c in sol.circuits] == \
        [(c.Case, c.J, c.dV) for c in ref.circuits]
    assert sol.circuits[0].Case == 1
    assert sol.circuits[0].J != first.circuits[0].J
    assert np.array_equal(sol.label_case, ref.label_case)
    assert np.abs(sol.A - first.A).max() > 1e-2 * np.abs(sol.A).max()
    assert_close(sol, jax_solve(3.0, mesh, circuit=True))


def test_prevsoln_sweep_takes_the_set_up(port_band, tracing, tmp_path):
    """A J sweep about a DC offset: new problems naming one previous
    solution (PrevType 1, incremental permeability), each with its own
    J, on one mesh. The second takes the first one's set-up; each
    problem's own B-H curves are set up (the incremental permeability
    reads them, and the solution file writes them from there), and each
    answer equals its cold solve."""
    mesh = mesher.mesh_problem(coil_cylinder(2.0))
    offset = coil_cylinder(2.0)
    base = magnetostatics.solve(offset, mesh, **ON_CPU)
    path = tmp_path / "offset.ans"
    ansfile.write_ans(ansfile.SolutionFile(
        problem=offset, mesh=ansfile.solution_mesh_from_solver(mesh, 1.0),
        values=base.A, label_case=base.label_case), str(path))

    def about_offset(J):
        p = coil_cylinder(J)
        p.PrevSoln, p.PrevType = str(path), 1
        return p

    problems = [about_offset(J) for J in (0.1, 0.3)]
    sols = [magnetostatics.solve(p, mesh, **ON_CPU) for p in problems]
    assert kinds() == ["built", "built", "sources"]
    for p in problems:
        assert p.blockproplist[1].slope
    for J, sol in zip((0.1, 0.3), sols):
        assert_close(sol, cold(port_band, about_offset(J), mesh))
    assert np.abs(sols[1].A - sols[0].A).max() > 0.1 * np.abs(sols[1].A).max()


def _air_mu(p):
    p.blockproplist[0].mu_x = p.blockproplist[0].mu_y = 1.5


def _bh_curve(p):
    # as pyFEMM's mi_clearbhpoints / mi_addbhpoint: the curve anew
    steel = p.blockproplist[1]
    steel.Bdata.clear()
    steel.Hdata.clear()
    for b, h in benchprob.STEEL_BH:
        steel.Bdata.append(b)
        steel.Hdata.append(100.0 * h)
    steel.slope = []


def _precision(p):
    p.Precision = 1e-9


def _boundary_A(p):
    p.lineproplist[0].A0 = 0.002


def _circuit_amps(p):
    p.circproplist[0].Amps = 3000.0


@pytest.mark.parametrize("edit", [_air_mu, _bh_curve, _precision,
                                  _boundary_A, _circuit_amps],
                         ids=["air mu", "B-H curve", "Precision",
                              "boundary A", "circuit Amps"])
def test_other_edits_build_again(port_band, tracing, edit):
    """A change of anything but the blocks' J between two solves on one
    mesh (the same problem edited in place) builds the set-up again; a
    new problem of the edited content then takes that set-up. The
    answers equal the cold solve, and differ from the unedited
    problem's where the edit moves the field."""
    mesh = mesher.mesh_problem(coil_cylinder(2.0, circuit=True))
    packs = count_calls(port_band, magnetostatics, "pack")
    p = coil_cylinder(2.0, circuit=True)
    base = magnetostatics.solve(p, mesh, **ON_CPU)
    edit(p)
    sol = magnetostatics.solve(p, mesh, **ON_CPU)
    q = coil_cylinder(2.0, circuit=True)
    edit(q)
    again = magnetostatics.solve(q, mesh, **ON_CPU)
    assert kinds() == ["built", "built", "reused"]
    assert len(packs) == 2
    ref = cold(port_band, q, mesh)
    assert_close(sol, ref)
    assert_close(again, ref)
    if edit is not _precision:
        assert np.abs(sol.A - base.A).max() > 1e-3 * np.abs(base.A).max()


def test_another_mesh_builds_its_own(port_band):
    """Equal problems on two meshes of other densities each build their
    own set-up, and an entry whose mesh is another never serves a mesh,
    even under its key (as when a freed mesh's id passes to a new
    one)."""
    mesh_a = mesher.mesh_problem(coil_cylinder(2.0, 2_000))
    mesh_b = mesher.mesh_problem(coil_cylinder(2.0))
    assert mesh_a.num_nodes != mesh_b.num_nodes
    packs = count_calls(port_band, magnetostatics, "pack")
    magnetostatics.solve(coil_cylinder(2.0), mesh_a, **ON_CPU)
    sol_b = magnetostatics.solve(coil_cylinder(3.0), mesh_b, **ON_CPU)
    assert len(packs) == 2
    cache = magnetostatics._PACK_CACHE
    (key_a, entry_a), = [(k, v) for k, v in cache.items()
                         if v[1][0].mesh is mesh_a]
    cache.clear()
    cache[(id(mesh_b),) + key_a[1:]] = entry_a
    again = magnetostatics.solve(coil_cylinder(3.0), mesh_b, **ON_CPU)
    assert len(packs) == 3
    assert packs[2].mesh is mesh_b
    ref = cold(port_band, coil_cylinder(3.0), mesh_b)
    assert_close(sol_b, ref)
    assert_close(again, ref)
