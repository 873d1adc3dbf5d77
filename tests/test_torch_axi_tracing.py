"""The axisymmetric magnetostatic path's spans (``models/axisymmetric``)
on the CPU, on the premeshed AxiSolenoid fixture (6,415 nodes).

An axisymmetric solve is one tree under its root "solve": "pack",
"geometry", the model's host set-up "axi static setup" (sources,
magnetization, initial permeabilities, the Kelvin warp, the DOF
coordinates), then the Newton chain, which opens one "newton host" span
per host pass after iteration 0. So the "newton host" spans count the
host passes: the solution's Newton iterations less the it-0 pass and
the device loop's steps, on the default path and on the host chain
alike. The answers are bit for bit the same with the tracer on and
off.
"""

import collections

import numpy as np
import pytest
import torch

from xfemm_tpu_torch import models
from xfemm_tpu_torch.geometry import femfile
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files
from xfemm_tpu_torch.models import axisymmetric
from xfemm_tpu_torch.ops import solver
from xfemm_tpu_torch.utils import profiling

torch.set_num_threads(1)

ON_CPU = dict(device="cpu", hbm_bytes=1e9)


@pytest.fixture
def fresh(monkeypatch):
    """Empty pattern, band and axisymmetric set-up caches, the tracer's
    sums, spans and switch as they were."""
    for name in ("_BAND_CACHE", "_PATTERN_CACHE"):
        monkeypatch.setattr(solver, name, collections.OrderedDict())
    monkeypatch.setattr(axisymmetric, "_SETUP_CACHE",
                        collections.OrderedDict())
    monkeypatch.setattr(profiling, "ENABLED", False)
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def mesh(fixtures):
    return read_mesh_files(str(fixtures / "AxiSolenoid"))


@pytest.fixture(scope="module")
def path(fixtures):
    return str(fixtures / "AxiSolenoid.fem")


def _solve(path, mesh, J=None):
    p = femfile.load(path)
    if J is not None:
        p.blockproplist[2].J = J
    return models.solve(p, mesh, **ON_CPU)


def _tree(root):
    return [s for s in profiling.spans()
            if s.request == root.id and s is not root]


def test_an_axisymmetric_solve_is_one_tree(fresh, path, mesh, monkeypatch):
    monkeypatch.setattr(profiling, "ENABLED", True)
    _solve(path, mesh)
    _solve(path, mesh, 1.5)
    spans = profiling.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["solve", "solve"]
    for root in roots:
        tree = _tree(root)
        setup = [s for s in tree if s.name == "axi static setup"]
        assert len(setup) == 1
        assert setup[0].parent == root.id
        assert setup[0].request == root.id
        names = [s.name for s in tree if s.parent == root.id]
        # the set-up runs between "geometry" and the Newton chain
        assert names.index("geometry") < names.index("axi static setup") \
            < names.index("element matrices")
        assert {"pack", "device newton", "newton loop setup",
                "newton host"} <= set(names)
        for s in tree:
            assert s.end_ns is not None and not s.error
            assert s.device_start_ns is None      # no CUDA device


@pytest.mark.parametrize("chain", ["device loop", "host chain"])
def test_newton_host_spans_count_the_host_passes(chain, fresh, path, mesh,
                                                 monkeypatch):
    """One "newton host" span per host pass after iteration 0: the
    solution's Newton iterations less the it-0 pass and the device
    loop's steps (none on the host chain)."""
    if chain == "host chain":
        monkeypatch.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")
    steps = []
    real = axisymmetric._device_chain

    def chain_steps(*a, **kw):
        out = real(*a, **kw)
        steps.append(int(out[4]))
        return out

    monkeypatch.setattr(axisymmetric, "_device_chain", chain_steps)
    monkeypatch.setattr(profiling, "ENABLED", True)
    for J in (1.0, 3.0, 4.0):
        before = len(steps)
        sol = _solve(path, mesh, J)
        root = [s for s in profiling.spans() if s.parent is None][-1]
        tree = _tree(root)
        passes = sum(s.name == "newton host" for s in tree)
        device = sum(steps[before:])
        assert (device > 0) == (chain == "device loop")
        assert sum(s.name == "device newton" for s in tree) == \
            len(steps) - before
        assert passes == sol.newton_iterations - 1 - device
        assert passes >= 1
        assert all(s.parent == root.id for s in tree
                   if s.name == "newton host")


def test_answers_are_bit_for_bit_with_tracing_on_and_off(fresh, path, mesh,
                                                         monkeypatch):
    answers = []
    for on in (False, True):
        monkeypatch.setattr(profiling, "ENABLED", on)
        solver._BAND_CACHE.clear()
        solver._PATTERN_CACHE.clear()
        answers.append([_solve(path, mesh, J) for J in (3.0, 1.0)])
    assert profiling.spans()
    for off, on in zip(*answers):
        assert np.array_equal(off.A, on.A)
        assert off.iterations == on.iterations
        assert off.newton_iterations == on.newton_iterations
