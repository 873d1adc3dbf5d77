"""Bodies that every rank of a process group runs (``launch.spawn``):
the group path of the domain decomposition on given inputs, its results
returned as numpy for the caller to hold against the stacked path.

They live in the package, not beside the tests, so that a spawned rank
imports only the port. Each takes ``(group, device, ...)`` and returns a
picklable result; a rank's full solution vectors are returned so that
the caller can check that every rank holds the same ones.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import torch

from ..ops import solver as solver_mod
from . import driver, halo, partition
from .comm import STACKED, GroupComm


def _blocks(arrays):
    return [solver_mod.ElementBlock(idx=idx, sign=sign, mat=mat)
            for idx, sign, mat in arrays]


def comm_ops(group, device, x: np.ndarray) -> dict:
    """``GroupComm``'s operations on this rank's row of the (P, m, k)
    array ``x``: both ring shifts, ``psum``, ``pdot`` of its first two
    columns and ``all_gather`` of its first column; then ``check_same``
    on ``x`` itself (the same on every rank) and on this rank's row (the
    ranks differ: the message it raises, or None)."""
    comm = GroupComm(group)
    t = torch.as_tensor(comm.local(x), device=device)
    out = dict(
        right=comm.ring_shift(t, 1).cpu().numpy(),
        left=comm.ring_shift(t, -1).cpu().numpy(),
        psum=comm.psum(t).cpu().numpy(),
        pdot=comm.pdot(t[:, :, 0], t[:, :, 1]).item(),
        gather=comm.all_gather(t[:, :, 0]).cpu().numpy())
    comm.check_same(x, "x")
    try:
        comm.check_same(comm.local(x), "the rank's row")
        out["drift"] = None
    except RuntimeError as exc:
        out["drift"] = str(exc)
    return out


def linear_solves(group, device, real, eddy, tol: float) -> dict:
    """The four linear solvers of the domain decomposition, one solve
    each over the group's parts (``"group"``): the sharded band engine
    through a session (``real`` = (blocks, b, fixed_mask, fixed_vals,
    coords) with more than 4*P*128 unknowns; f32 CG passes in the f64
    refinement), the element-block halo PCG with Jacobi and with the
    Schwarz AMG and global coarse solve (``halo.solve_distributed``), and
    the complex-symmetric PCG through a session (``eddy``, complex
    blocks). Rank 0 then runs the same solves on the stacked
    communicator (``"stacked"``), in the same process environment (one
    host thread: LAPACK's rounding follows its thread count), as their
    reference. Returns each one's (x, relative residual, iterations),
    and the band engine's CG per refinement pass."""
    comm = GroupComm(group)
    out = {"group": _solves(comm.world, group, comm, device, real, eddy,
                            tol),
           "stacked": None}
    if comm.rank == 0:
        out["stacked"] = _solves(comm.world, None, STACKED, device, real,
                                 eddy, tol)
    return out


def _solves(P, mesh, comm, device, real, eddy, tol: float) -> dict:
    blocks, b, fixed, fvals, coords = real
    out = {}
    sess = driver.DistributedSession(P, mesh=mesh, device=device)
    out["band_dd"] = sess.solve(_blocks(blocks), b, fixed, fvals, tol,
                                coords=coords)
    out["band_dd_passes"] = list(sess.pass_iters)
    if sess._bdd is None:
        raise RuntimeError("the band engine did not serve the solve")
    ps = partition.partition(blocks, len(b), fixed, fvals, coords, P)
    for name, schwarz in (("jacobi", False), ("schwarz", True)):
        out[name] = halo.solve_distributed(ps, b, tol, device,
                                           schwarz=schwarz, comm=comm)
    cblocks, cb, cfixed, cfvals, ccoords = eddy
    csess = driver.DistributedSession(P, mesh=mesh, schwarz=False,
                                      device=device)
    out["csym"] = csess.solve_complex(_blocks(cblocks), cb, cfixed, cfvals,
                                      tol, coords=ccoords)
    return out


def model_solve(group, device, problem, mesh, hbm_bytes: float) -> dict:
    """``models.solve(problem, mesh, devices=P, device_mesh=group)`` of a
    magnetic problem on the rank's device; first ``devices=2P`` with the
    same group, which must raise ValueError on every rank before any
    collective. Returns the solution's A, residual and iteration counts,
    and the ValueError's message."""
    from .. import models
    P = group.size()
    try:
        models.solve(problem, mesh, devices=2 * P, device_mesh=group,
                     device=device, hbm_bytes=hbm_bytes)
        mismatch = None
    except ValueError as exc:
        mismatch = str(exc)
    sol = models.solve(problem, mesh, devices=P, device_mesh=group,
                       device=device, hbm_bytes=hbm_bytes)
    return dict(A=np.asarray(sol.A), residual=sol.residual,
                newton=sol.newton_iterations, iterations=sol.iterations,
                mismatch=mismatch)


def cli(group, device, argvs: list) -> tuple:
    """``python -m xfemm_tpu_torch`` with ``argvs[rank]`` in each rank
    (the launch's environment names it a rank, as torchrun does).
    Returns (exit code, what it printed)."""
    from ..__main__ import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argvs[group.rank()]))
    return rc, buf.getvalue()
