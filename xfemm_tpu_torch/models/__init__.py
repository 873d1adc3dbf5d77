"""Solver model families: one module per (problem class, geometry).

``solve(problem, mesh)`` dispatches on the problem's file type and
coordinate system, mirroring the runSolver dispatch of the reference
(cfemm/fsolver/fsolver.cpp:1213-1340). The port solves planar
magnetostatics; every other family raises ``NotImplementedError``
naming the ROADMAP item that ports it, which removes its raise.
Keyword arguments (``device``, ``hbm_bytes``, ``x0_A``, ...) go to the
family's ``solve``.
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
                _later("axisymmetric AC magnetics", "A.3")
            _later("planar AC magnetics", "A.3")
        if problem.ProblemType == ProblemType.AXISYMMETRIC:
            _later("axisymmetric magnetostatics", "A.2")
        from . import magnetostatics
        return magnetostatics.solve(problem, mesh, **kw)
    if problem.filetype == FileType.HEATFLOW:
        _later("heat flow", "A.4")
    if problem.filetype == FileType.ELECTROSTATICS:
        _later("electrostatics", "A.4")
    raise ValueError(f"unsupported problem type {problem.filetype}")
