"""Solver model families: one module per (problem class, geometry).

``solve(problem, mesh)`` dispatches on the problem's file type and
coordinate system, mirroring the runSolver dispatch of the reference
(cfemm/fsolver/fsolver.cpp:1213-1340). The port solves magnetics in
every geometry and at every frequency: planar and axisymmetric
magnetostatics (models/magnetostatics.py, models/axisymmetric.py) and
AC harmonic problems (models/harmonic.py, models/harmonicaxi.py). Heat
flow and electrostatics raise ``NotImplementedError`` naming the
ROADMAP item that ports them, which removes the raise. Keyword
arguments (``device``, ``hbm_bytes``, ...) go to the family's ``solve``.
"""

from __future__ import annotations

from ..constants import FileType, ProblemType


def _later(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to xfemm_tpu_torch yet (ROADMAP {item})")


def solve(problem, mesh, **kw):
    if problem.filetype == FileType.MAGNETICS:
        if problem.Frequency != 0:
            if problem.ProblemType == ProblemType.AXISYMMETRIC:
                from . import harmonicaxi
                return harmonicaxi.solve(problem, mesh, **kw)
            from . import harmonic
            return harmonic.solve(problem, mesh, **kw)
        if problem.ProblemType == ProblemType.AXISYMMETRIC:
            from . import axisymmetric
            return axisymmetric.solve(problem, mesh, **kw)
        from . import magnetostatics
        return magnetostatics.solve(problem, mesh, **kw)
    if problem.filetype == FileType.HEATFLOW:
        _later("heat flow", "A.4")
    if problem.filetype == FileType.ELECTROSTATICS:
        _later("electrostatics", "A.4")
    raise ValueError(f"unsupported problem type {problem.filetype}")
