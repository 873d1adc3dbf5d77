"""Electrostatics (ESolver semantics) on PyTorch.

Functional equivalent of the reference's ``ESolver::AnalyzeProblem``
(cfemm/esolver/esolver.cpp:389-650): linear orthotropic permittivity,
volume/surface/point charge sources (with the 1e-6/eo scaling and mm
internal units, esolver.cpp:65,398), mixed boundaries, planar +
axisymmetric, and conductors (fixed V -> Dirichlet set; fixed total
charge -> merged reduced DOF with the charge on its RHS). Total charge on
fixed-V conductors is recovered with the indicator-gradient integral
(esolver.cpp:786-850 ChargeOnConductor).

The assembly is host numpy; the one linear solve runs on ``device``
(``solver.solve``, CUDA by default).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import PI, ProblemType
from ..geometry.problem import Problem
from ..mesh.meshdata import EdgeMultiplicity, MeshData
from ..ops import assembly, solver
from ..ops.solver import ElementBlock
from ..parallel import driver as dd_driver
from ..utils import profiling
from .heatflow import compute_node_Q, conductor_prolongation, \
    decode_markers

EPS0 = 8.85418781762e-12
#: length-unit -> mm (esolver.cpp:65)
LENGTH_TO_MM = [25.4, 1.0, 10.0, 1000.0, 0.0254, 0.001]


@dataclass
class ElecSolution:
    problem: Problem
    mesh: MeshData
    V: np.ndarray                 # (N,) nodal voltage
    node_Q: np.ndarray            # (N,) .res Q col: -2 free, -1 fixed/
                                  # point-prop node, else conductor index
    conductor_V: np.ndarray
    conductor_q: np.ndarray
    iterations: int = 0
    residual: float = 0.0


def solve(problem: Problem, mesh: MeshData, devices: int | None = None,
          device_mesh=None, device=None,
          hbm_bytes: float | None = None) -> ElecSolution:
    """Electrostatic solve: one linear ``solver.solve`` on ``device``
    (CUDA when omitted; ``"cpu"`` runs the kernels' plain versions and
    needs ``hbm_bytes``). ``devices=N`` solves it as a domain
    decomposition over N parts (``parallel/driver.py``) on that device or
    the one device of ``device_mesh``, or one part per rank of a process
    group ``device_mesh``."""
    from ..mesh.meshdata import resolve_default_labels
    dev = solver.resolve_device(device)
    dsess = dd_driver.session(devices, device_mesh, dev)
    resolve_default_labels(problem, mesh)
    units = LENGTH_TO_MM[int(problem.LengthUnits)]
    xy = mesh.nodes * units
    tris = mesh.elements
    N = mesh.num_nodes
    T = mesh.num_elements
    axi = problem.ProblemType == ProblemType.AXISYMMETRIC
    depth = problem.Depth * units if not axi else 1.0
    c = 1e-6 / EPS0

    labels = [l for l in problem.labellist if not l.is_hole()]
    mats = problem.blockproplist
    conductors = problem.circproplist
    with profiling.phase("elec element properties"):
        blk = np.array([labels[i].BlockType for i in mesh.element_labels])

    with profiling.phase("elec marker decoding"):
        node_pp, node_cond, edge_bdry, edge_cond = decode_markers(mesh)
        ridx, rsign, nred, cond_dof = conductor_prolongation(
            N, mesh.pbc_pairs, node_cond, conductors)

    with profiling.phase("elec static setup"):
        geom = assembly.tri_geometry(xy, tris)
        area = np.asarray(geom.area)
        rc = xy[tris][:, :, 0].mean(axis=1)
        dep_el = 2.0 * PI * rc if axi else np.full(T, depth)

        kludge = np.ones(T)
        if axi:
            is_ext = np.array([labels[i].IsExternal
                               for i in mesh.element_labels], bool)
            if is_ext.any():
                extRo = problem.extRo * units
                extRi = problem.extRi * units
                extZo = problem.extZo * units
                z = xy[tris][:, :, 1].mean(axis=1) - extZo
                kludge = np.where(is_ext, (rc * rc + z * z) / (extRi * extRo),
                                  1.0)

        fixed_mask = np.zeros(nred, bool)
        fixed_vals = np.zeros(nred)
        npp = len(problem.nodeproplist)
        special = np.nonzero((node_cond >= 0)
                             | ((node_pp >= 0) & (node_pp < npp)))[0]
        for i in special:
            ci = node_cond[i]
            if ci >= 0 and conductors[ci].CircType == 1:
                fixed_mask[ridx[i]] = True
                fixed_vals[ridx[i]] = conductors[ci].V
            j = node_pp[i]
            if 0 <= j < npp:
                pp = problem.nodeproplist[j]
                if pp.qp == 0:
                    fixed_mask[ridx[i]] = True
                    fixed_vals[ridx[i]] = pp.V

        bdry_edges = []
        edge_count = EdgeMultiplicity(tris)
        marked = np.nonzero((np.asarray(edge_bdry) >= 0)
                            & (np.asarray(edge_bdry)
                               < len(problem.lineproplist)))[0]
        for ei in marked:
            a, b = mesh.edges[ei]
            bi = edge_bdry[ei]
            bp = problem.lineproplist[bi]
            if bp.BdryFormat == 0:
                # prescribed voltage is stored in A0 (<Vs> in the .fee)
                for nd in (a, b):
                    fixed_mask[ridx[nd]] = True
                    fixed_vals[ridx[nd]] = bp.A0
            elif bp.BdryFormat in (1, 2):
                mult = edge_count.get(tuple(sorted((int(a), int(b)))), 1)
                bdry_edges.append((int(a), int(b), bi, mult))

        b_extra = np.zeros(nred)
        for i in special:
            j = node_pp[i]
            if 0 <= j < npp:
                pp = problem.nodeproplist[j]
                if pp.qp != 0 and not fixed_mask[ridx[i]]:
                    dp = 2.0 * PI * xy[i, 0] if axi else depth
                    b_extra[ridx[i]] += 1e6 * dp * c * pp.qp
        for ci, cond in enumerate(conductors):
            if cond.CircType == 0 and cond_dof[ci] >= 0:
                b_extra[cond_dof[ci]] += 1e9 * c * cond.q

    with profiling.phase("elec element properties"):
        ex = np.array([mats[b].ex for b in blk])
        ey = np.array([mats[b].ey for b in blk])
        qv = np.array([mats[b].qv for b in blk])

    with profiling.phase("elec assembly"):
        Kx = -dep_el * ex / (4.0 * area) / kludge
        Ky = -dep_el * ey / (4.0 * area) / kludge
        Me = (Kx[:, None, None] * geom.p[:, :, None] * geom.p[:, None, :]
              + Ky[:, None, None] * geom.q[:, :, None] * geom.q[:, None, :])
        be = (-dep_el * c * qv * area / 3.0)[:, None] * np.ones((1, 3))

        blocks = [ElementBlock(idx=ridx[tris], sign=rsign[tris], mat=-Me)]
        b = np.zeros(nred)
        np.add.at(b, ridx[tris].reshape(-1), -(rsign[tris] * be).reshape(-1))
        b += b_extra

        if bdry_edges:
            eidx = np.zeros((len(bdry_edges), 2), np.int64)
            esgn = np.ones((len(bdry_edges), 2))
            emat = np.zeros((len(bdry_edges), 2, 2))
            for row, (a, bb, bi, mult) in enumerate(bdry_edges):
                bp = problem.lineproplist[bi]
                length = float(np.hypot(*(xy[bb] - xy[a])))
                dp = PI * (xy[a, 0] + xy[bb, 0]) if axi else depth
                eidx[row] = (ridx[a], ridx[bb])
                esgn[row] = (rsign[a], rsign[bb])
                if bp.BdryFormat == 1:      # mixed
                    K = -1000.0 * dp * c * complex(bp.c0).real * length / 6.0
                    emat[row] = -mult * K * np.array([[2.0, 1.0], [1.0, 2.0]])
                    Kb = 1000.0 * dp * c * complex(bp.c1).real * length / 2.0
                    b[ridx[a]] -= rsign[a] * Kb * mult
                    b[ridx[bb]] -= rsign[bb] * Kb * mult
                else:                        # surface charge
                    Kb = -1000.0 * dp * c * bp.qs * length / 2.0
                    b[ridx[a]] -= rsign[a] * Kb * mult
                    b[ridx[bb]] -= rsign[bb] * Kb * mult
            blocks.append(ElementBlock(idx=eidx, sign=esgn, mat=emat))

        dof_coords = np.zeros((nred, 2))
        dof_coords[ridx] = xy

    if dsess is not None:
        # the domain decomposition (parallel/driver.py), same contract
        V, rel_resid, cg_iters = dsess.solve(
            blocks, b, fixed_mask, fixed_vals, problem.Precision,
            coords=dof_coords)
    else:
        V, rel_resid, cg_iters = solver.solve(
            blocks, b, fixed_mask, fixed_vals, problem.Precision,
            coords=dof_coords, device=dev, hbm=hbm_bytes)
    V = np.asarray(V)
    Vn = V[ridx] * rsign

    with profiling.phase("elec conductor results"):
        cond_V = np.zeros(len(conductors))
        cond_q = np.zeros(len(conductors))
        for ci, cond in enumerate(conductors):
            if cond.CircType == 0:
                cond_q[ci] = cond.q
                if cond_dof[ci] >= 0:
                    cond_V[ci] = V[cond_dof[ci]]
            else:
                cond_V[ci] = cond.V
                cond_q[ci] = _charge_on_conductor(
                    ci, node_cond, xy, tris, blk, mats, Vn, axi, depth)

        node_Q = compute_node_Q(problem, mesh, node_pp, node_cond, edge_bdry)
    return ElecSolution(problem=problem, mesh=mesh, V=Vn,
                        node_Q=node_Q, conductor_V=cond_V,
                        conductor_q=cond_q, iterations=int(cg_iters),
                        residual=float(rel_resid))


def _charge_on_conductor(ci, node_cond, xy, tris, blk, mats, Vn, axi,
                         depth):
    """Total charge via the indicator-gradient integral
    (esolver.cpp:786-850); lengths are mm -> the 1e-3 factor."""
    P = (node_cond == ci).astype(float)
    sel = P[tris].any(axis=1)
    if not sel.any():
        return 0.0
    t = tris[sel]
    v = xy[t]
    bb = v[:, [1, 2, 0], 1] - v[:, [2, 0, 1], 1]
    cc = v[:, [2, 0, 1], 0] - v[:, [1, 2, 0], 0]
    da = bb[:, 0] * cc[:, 1] - bb[:, 1] * cc[:, 0]
    a = da / 2.0
    if axi:
        a = a * 2.0 * PI * v[:, :, 0].mean(axis=1)
    else:
        a = a * depth
    vx = -(P[t] * bb).sum(axis=1) / da
    vy = -(P[t] * cc).sum(axis=1) / da
    Dx = -(Vn[t] * bb).sum(axis=1) / da * EPS0 * np.array(
        [mats[bi].ex for bi in blk[sel]])
    Dy = -(Vn[t] * cc).sum(axis=1) / da * EPS0 * np.array(
        [mats[bi].ey for bi in blk[sel]])
    # internal mm: D in V/mm * eps -> x1e3 for V/m; area mm^2 -> m^2 1e-6;
    # net factor 1e-3 (esolver.cpp:848)
    return float(np.sum(a * (Dx * vx + Dy * vy)) * 1e-3)
