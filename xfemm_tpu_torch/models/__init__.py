"""Solver model families: one module per (problem class, geometry).

``solve(problem, mesh)`` dispatches on the problem's file type and
coordinate system, mirroring the runSolver dispatch of the reference
(cfemm/fsolver/fsolver.cpp:1213-1340). The port solves every problem
class of the reference: planar and axisymmetric magnetostatics
(models/magnetostatics.py, models/axisymmetric.py), AC harmonic
problems (models/harmonic.py, models/harmonicaxi.py), heat flow
(models/heatflow.py) and electrostatics (models/electrostatics.py).
Keyword arguments (``device``, ``hbm_bytes``, ...) go to the family's
``solve``.
"""

from __future__ import annotations

from ..constants import FileType, ProblemType


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
        from . import heatflow
        return heatflow.solve(problem, mesh, **kw)
    if problem.filetype == FileType.ELECTROSTATICS:
        from . import electrostatics
        return electrostatics.solve(problem, mesh, **kw)
    raise ValueError(f"unsupported problem type {problem.filetype}")
