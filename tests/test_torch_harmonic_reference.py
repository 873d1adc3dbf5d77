"""The port's planar AC eddy-current solve against the benchmark's plain
reference (``benchmark/reference/harmonic.py``, a complex128 sparse
direct solve), on the CPU at ~10,000 nodes of the ``ac125k``
configuration's problem (``benchmark/problems/wound_coil.py``, the
ACwound fixture's geometry, materials and circuit; the steel's mesh set
for the skin depth at 25 Hz instead of 400 Hz to keep it small).

The problem module builds the fixture's problem, and the reference
reproduces the fixture's golden answer (from the unmodified upstream
fsolver) on its own mesh. ``models.solve`` meets the configuration's
``gap`` limit at 10, 50 and 400 Hz, the ends and the source of the
``freq_sweep`` traffic. Faults planted in the problem the program is
given, each a mistake an AC solver can make, come out above the limit:
the angular frequency taken in Hz (omega = f), the eddy term's sign
flipped (sigma < 0), the aluminium's source density conjugated, and the
winding's proximity permeability left out. The control, the reference
solved in complex64 in the program's place, reads above the limit
already at this size.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark import spec
from xfemm_tpu_torch import models
from xfemm_tpu_torch.geometry import femfile
from xfemm_tpu_torch.io import ansfile
from xfemm_tpu_torch.mesh import mesher

torch.set_num_threads(1)

SMALL = {"target_nodes": 10_000, "skin_freq": 25.0}
ON_CPU = dict(device="cpu", hbm_bytes=2e9)


@pytest.fixture(scope="module")
def cell():
    """(problem module, parameters at SMALL, the gap limit, the mesh)."""
    bench = spec.load_benchmark()
    config = spec.config(bench, "ac125k")
    mod = spec.problem(config["problem"])
    params = dict(config["params"], **SMALL)
    mesh = mesher.mesh_problem(mod.build(params))
    return mod, params, config["limits"]["gap"], mesh


def test_problem_is_the_fixture(fixtures, cell):
    """The built problem is ACwound.fem but for its MaxAreas, and the
    reference on the fixture's own mesh gives its golden answer."""
    mod, params, _limit, _mesh = cell
    src = femfile.load(str(fixtures / "ACwound.fem"))
    got = mod.build(dict(params, freq=src.Frequency))
    for key in ("Frequency", "Precision", "MinAngle", "Depth",
                "LengthUnits", "ProblemType", "DoSmartMesh", "nodelist",
                "linelist", "arclist", "blockproplist", "lineproplist",
                "circproplist"):
        assert getattr(got, key) == getattr(src, key), key
    assert [dataclasses.replace(lb, MaxArea=0.0) for lb in got.labellist] \
        == [dataclasses.replace(lb, MaxArea=0.0) for lb in src.labellist]
    g = ansfile.read_ans(str(fixtures / "ACwound.ans.golden"))
    ref = mod.reference(dict(params, freq=src.Frequency), g.mesh.nodes,
                        g.mesh.elements, g.mesh.element_labels)
    A, _ = mod.reference_solve(ref)
    assert np.abs(A - g.values).max() / np.abs(g.values).max() < 1e-9


def _gap(cell, params, problem):
    """The reference's gap of the program's answer to ``problem``,
    judged against the problem ``params`` describe."""
    mod, _params, _limit, mesh = cell
    sol = models.solve(problem, mesh, **ON_CPU)
    ref = mod.reference(params, mesh.nodes, mesh.elements,
                        mesh.element_labels)
    return mod.judge(ref, mod.answer(sol))


@pytest.mark.parametrize("freq", [10.0, 50.0, 400.0])
def test_program_meets_the_limit(cell, freq):
    mod, params, limit, mesh = cell
    p = dict(params, freq=freq)
    assert 8000 < len(mesh.nodes) < 20000
    assert _gap(cell, p, mod.build(p)) < limit


def _material(problem, name):
    return next(m for m in problem.blockproplist if m.name == name)


def _omega_in_hz(problem):
    problem.Frequency = problem.Frequency / (2.0 * math.pi)


def _eddy_sign_flipped(problem):
    steel = _material(problem, "LinSteel")
    steel.Cduct = -steel.Cduct


def _alum_source_conjugated(problem):
    alum = _material(problem, "Alum")
    alum.J = alum.J.conjugate()


def _winding_without_proximity(problem):
    _material(problem, "Coil").LamType = 0
    _material(problem, "Coil").Cduct = 0.0


@pytest.mark.parametrize("fault", [_omega_in_hz, _eddy_sign_flipped,
                                   _alum_source_conjugated,
                                   _winding_without_proximity],
                         ids=["omega_in_hz", "eddy_sign_flipped",
                              "alum_source_conjugated",
                              "winding_without_proximity"])
def test_planted_fault_is_not_correct(cell, fault):
    mod, params, limit, _mesh = cell
    p = dict(params, freq=50.0)
    problem = mod.build(p)
    fault(problem)
    assert _gap(cell, p, problem) > limit


def test_control_fails_the_limit(cell):
    """The reference in complex64 reads above the limit at SMALL (and
    at the cell's size, PERF.md)."""
    mod, params, limit, mesh = cell
    ref = mod.reference(params, mesh.nodes, mesh.elements,
                        mesh.element_labels)
    x64, _ = mod.reference_solve(ref, dtype=np.float32)
    assert mod.judge(ref, x64) > limit
    x128, _ = mod.reference_solve(ref)
    assert mod.judge(ref, x128) == 0.0
