"""The AC path's spans (``ops/solver.solve_complex``,
``models/harmonic.solve``) on the CPU, on ``benchprob.build_ac`` at
~3,000 nodes (the band engine's smallest size).

An AC solve is one tree under its root "solve": the model's host set-up
("ac static setup"), the band fill, and one "ac pass (<engine>)" span
per refinement pass around its device span; a solve that reuses the
pattern refreshes and refactors ("ac band refresh", "bt refactor
(ac)"). The pass spans agree with the passes ``solver.TRACE`` prints
and the loop driver's carried count with their Jacobi-pairs iterations
on every engine, the fallbacks included, and the answers are bit for
bit the same with the tracer on and off.
"""

import collections
import re

import numpy as np
import pytest
import torch

from xfemm_tpu_torch import models
from xfemm_tpu_torch.mesh import mesher
from xfemm_tpu_torch.models import benchprob, magnetostatics
from xfemm_tpu_torch.ops import band, loop, solver
from xfemm_tpu_torch.utils import profiling

torch.set_num_threads(1)

ON_CPU = dict(device="cpu", hbm_bytes=2e9)
PASS_LINE = re.compile(r"ac pass \(([^)]*)\): n=\d+ it=(\d+)")


@pytest.fixture
def fresh(monkeypatch):
    """Empty AC caches and the tracer's sums, spans and switch as they
    were."""
    for mod, name in ((solver, "_CBAND_CACHE"),
                      (solver, "_PATTERN_CACHE"),
                      (magnetostatics, "_PACK_CACHE")):
        monkeypatch.setattr(mod, name, collections.OrderedDict())
    monkeypatch.setattr(profiling, "ENABLED", False)
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def mesh():
    return mesher.mesh_problem(benchprob.build_ac(3000))


def _solve(mesh, freq=50.0):
    return models.solve(benchprob.build_ac(3000, freq), mesh, **ON_CPU)


def test_an_ac_solve_is_one_tree(fresh, mesh, monkeypatch):
    monkeypatch.setattr(profiling, "ENABLED", True)
    assert len(mesh.nodes) > 4 * solver.ROW_TILE_MIN
    _solve(mesh, 50.0)
    _solve(mesh, 400.0)
    spans = profiling.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["solve", "solve"]
    by_id = {s.id: s for s in spans}
    for k, root in enumerate(roots):
        tree = [s for s in spans if s.request == root.id and s is not root]
        names = {s.name for s in tree}
        assert {"pack", "ac static setup", "ac elements", "ac csr assembly",
                "ac band fill", "ac pass (band gmres + bt)",
                "device gmres (ac)"} <= names
        # the first solve builds the pattern's entry, the second
        # refreshes and refactors it
        assert ({"ac band refresh", "bt refactor (ac)"} <= names) == (k == 1)
        for s in tree:
            assert s.end_ns is not None and not s.error
            assert s.device_start_ns is None      # no CUDA device
            if s.name == "device gmres (ac)":
                assert by_id[s.parent].name == "ac pass (band gmres + bt)"
            if s.name.startswith("ac pass"):
                assert s.parent == root.id


ENGINES = {"bt": {}, "vcycle": {"AC_FACTOR_GATE": 0.0},
           "pairs": {"AC_BAND_GATE": 0.0}}
NAMES = {"bt": "band gmres + bt", "vcycle": "band gmres + vcycle",
         "pairs": "jacobi pairs"}


def _passes(root):
    """The "ac pass (<engine>)" spans of one solve, in order, each with
    the names of its children."""
    spans = [s for s in profiling.spans() if s.request == root.id]
    return [(s.name[len("ac pass ("):-1],
             [c.name for c in spans if c.parent == s.id])
            for s in spans if s.name.startswith("ac pass (")]


def _last_root():
    return [s for s in profiling.spans() if s.parent is None][-1]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_pass_spans_match_the_passes_and_iterations(engine, fresh, mesh,
                                                    monkeypatch, capsys):
    """One "ac pass" span per pass ``solver.TRACE`` prints, named by its
    engine, around one device span; the Jacobi-pairs iterations are the
    loop driver's carried count, so a solution's iterations less the
    carried ones are its GMRES iterations (``gmres_per_solve``)."""
    for name, value in ENGINES[engine].items():
        monkeypatch.setattr(solver, name, value)
    monkeypatch.setattr(solver, "TRACE", True)
    monkeypatch.setattr(profiling, "ENABLED", True)
    for freq in (10.0, 400.0):
        capsys.readouterr()
        carried = loop.CARRIED["csym-pairs"]
        sol = _solve(mesh, freq)
        carried = loop.CARRIED["csym-pairs"] - carried
        lines = PASS_LINE.findall(capsys.readouterr().out)
        passes = _passes(_last_root())
        assert lines and [e for e, _c in passes] == [e for e, _it in lines]
        # the V-cycle may latch the band engine off for the pattern
        assert passes[0][0] == NAMES[engine]
        assert {e for e, _c in passes} <= {NAMES[engine], "jacobi pairs"}
        if engine == "bt":
            assert {e for e, _c in passes} == {NAMES[engine]}
        for e, children in passes:
            assert children == ["device cg (ac pairs)" if e == "jacobi pairs"
                                else "device gmres (ac)"]
        on_pairs = sum(int(it) for e, it in lines if e == "jacobi pairs")
        assert carried == on_pairs
        assert sol.iterations == sum(int(it) for _e, it in lines)
        assert (sol.iterations - carried > 0) == (engine != "pairs")


def test_fallbacks_show_in_the_pass_spans(fresh, mesh, monkeypatch, capsys):
    """A GMRES that never moves the solution drops the factor, then
    latches the band engine off; Jacobi pairs CG finishes the solve, and
    the pass spans name each engine in turn."""
    def stuck(amg, Aop, Ai, br, bi, tol, m=24, cycles=8, bt=None):
        return torch.zeros_like(br), torch.zeros_like(bi), 1.0, 0

    monkeypatch.setattr(band, "band_csym_fgmres_fused", stuck)
    monkeypatch.setattr(solver, "TRACE", True)
    monkeypatch.setattr(profiling, "ENABLED", True)
    carried = loop.CARRIED["csym-pairs"]
    sol = _solve(mesh)
    carried = loop.CARRIED["csym-pairs"] - carried
    out = capsys.readouterr().out
    assert out.count("dropping the factor") == out.count("latched off") == 1
    engines = [e for e, _c in _passes(_last_root())]
    assert engines == [e for e, _it in PASS_LINE.findall(out)]
    assert engines[:2] == ["band gmres + bt", "band gmres + vcycle"]
    assert len(engines) >= 3 and set(engines[2:]) == {"jacobi pairs"}
    assert carried == sol.iterations > 0
    assert sol.residual <= 1e-8


def test_answers_are_bit_for_bit_with_tracing_on_and_off(fresh, mesh,
                                                         monkeypatch):
    answers = []
    for on in (False, True):
        monkeypatch.setattr(profiling, "ENABLED", on)
        solver._CBAND_CACHE.clear()
        solver._PATTERN_CACHE.clear()
        answers.append([_solve(mesh, f).A for f in (10.0, 400.0)])
    assert profiling.spans()
    for off, on in zip(*answers):
        assert np.array_equal(off, on)
