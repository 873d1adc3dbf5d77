"""Steady/transient heat flow (HSolver semantics) on PyTorch.

Functional equivalent of the reference's ``HSolver::AnalyzeProblem``
(cfemm/hsolver/hsolver.cpp:458-857): nonlinear K(T) conductivity by
successive substitution (3-node-average lookup), convection / heat-flux /
radiation boundary formats (radiation linearized about the previous
iterate), lumped transient term from dT/Tprev, planar + axisymmetric
(2*pi*r element depth, Kelvin-transform external region), and conductor
constraints: fixed-temperature conductors become Dirichlet sets, while
total-flux conductors merge their nodes into one reduced DOF whose summed
equation *is* the flux balance (the replacement for the reference's
extra conductor rows, hsolver.cpp:744-760). Internal working units are
meters (hsolver.cpp:65).

The element assembly and the conductor bookkeeping are host numpy; the
linear solves run on ``device`` (``solver.solve``, CUDA by default), and
after the first pass the middle of the substitution runs there as one
loop (``ops/newton.run_heat``). ``XFEMM_TPU_NO_DEVICE_NEWTON=1`` keeps
every pass on the host chain.
"""

from __future__ import annotations

import collections
import math
import os
from dataclasses import dataclass

import numpy as np

from ..constants import LENGTH_TO_METERS, PI, ProblemType
from ..geometry.problem import Problem, source_free_fingerprint
from ..mesh.meshdata import EdgeMultiplicity, MeshData
from ..ops import assembly, solver
from ..ops.solver import ElementBlock
from ..parallel import driver as dd_driver
from ..utils.profiling import phase
from .magnetostatics import build_prolongation

KSB = 5.67032e-8      # Stefan-Boltzmann (femmconstants.h:26)


@dataclass
class HeatSolution:
    problem: Problem
    mesh: MeshData
    T: np.ndarray                 # (N,) nodal temperature
    node_Q: np.ndarray            # (N,) .anh Q col: -2 free, -1 fixed/
                                  # point-prop node, else conductor index
    conductor_V: np.ndarray       # (C,) solved conductor temperature
    conductor_q: np.ndarray       # (C,) solved conductor total flux
    iterations: int = 0
    residual: float = 0.0


def decode_markers(mesh: MeshData):
    """Node/edge marker decoding shared by heat + electrostatics
    (hsolver.cpp:210-235, 355-385): node marker = (pointprop+2) |
    ((conductor+1)<<16); edge marker = -((bdry+2) | ((conductor+1)<<16)).
    Edge conductors propagate to their endpoint nodes."""
    m = mesh.node_markers.astype(np.int64)
    node_pp = np.where(m > 1, (m & 0xFFFF) - 2, -1)
    node_pp = np.where(node_pp < 0, -1, node_pp)
    node_cond = np.where(m > 1, (m >> 16) - 1, -1)

    em = mesh.edge_markers.astype(np.int64)
    neg = em < 0
    em2 = np.where(neg, -em, 0)
    edge_bdry = np.where(neg, (em2 & 0xFFFF) - 2, -1)
    edge_cond = np.where(neg, (em2 >> 16) - 1, -1)
    # the last conductor edge touching a node sets its conductor
    hot = np.nonzero(edge_cond >= 0)[0]
    ends = mesh.edges[hot]
    last = np.full(len(node_cond), -1, np.int64)
    np.maximum.at(last, ends[:, 0], hot)
    np.maximum.at(last, ends[:, 1], hot)
    touched = last >= 0
    node_cond[touched] = edge_cond[last[touched]]
    return node_pp, node_cond, edge_bdry, edge_cond


def compute_node_Q(problem: Problem, mesh: MeshData, node_pp, node_cond,
                   edge_bdry) -> np.ndarray:
    """The reference's per-node Q bookkeeping, written to the solution
    file and consumed by the postprocessor's nodal smoothing
    (hsolver.cpp:495-533 + :764-775, esolver.cpp:410-440 + :590-600):
    -2 free, -1 for any point-property node or fixed-potential segment
    endpoint, conductor index for any conductor node (last wins).
    getNodalD treats Q != -2 as 'do not smooth across this node'."""
    Q = np.full(len(mesh.nodes), -2, np.int64)
    npp = len(problem.nodeproplist)
    Q[(node_pp >= 0) & (node_pp < npp)] = -1
    eb = np.asarray(edge_bdry)
    nlp = len(problem.lineproplist)
    for ei in np.nonzero((eb >= 0) & (eb < nlp))[0]:
        if problem.lineproplist[eb[ei]].BdryFormat == 0:
            a, b = mesh.edges[ei]
            Q[a] = -1
            Q[b] = -1
    cond = np.asarray(node_cond)
    Q[cond >= 0] = cond[cond >= 0]
    return Q


def conductor_prolongation(n, pbc_pairs, node_cond, conductors):
    """(Anti)periodic folding composed with total-flux conductor merges:
    all nodes of a CircType-0 conductor share one reduced DOF."""
    ridx, rsign, nred = build_prolongation(n, pbc_pairs)
    remap = np.arange(nred)
    for ci, cond in enumerate(conductors):
        if cond.CircType != 0:
            continue
        members = np.unique(ridx[node_cond == ci])
        if len(members) > 1:
            remap[members] = members.min()
    # compress ids
    uniq, newid = np.unique(remap, return_inverse=True)
    ridx = newid[remap[ridx]]
    # conductor -> reduced DOF map
    cond_dof = np.full(len(conductors), -1, np.int64)
    for ci, cond in enumerate(conductors):
        sel = node_cond == ci
        if sel.any():
            cond_dof[ci] = ridx[np.nonzero(sel)[0][0]]
    return ridx, rsign, len(uniq), cond_dof


@dataclass
class HeatSetup:
    """The (problem, mesh)-static state of a heat solve (``_setup_static``):
    geometry, marker decoding, the conductor prolongation, fixed DOFs,
    derivative boundary edges, per-element properties, and the solver
    Session (whose band state lives on one device). Of the problem's
    properties only the sources ``qv`` may change under it."""
    mesh: MeshData
    xy: np.ndarray            # (N, 2) node coordinates, meters
    tris: np.ndarray          # (T, 3)
    blk: np.ndarray           # (T,) block property per element
    node_pp: np.ndarray
    node_cond: np.ndarray
    edge_bdry: np.ndarray
    ridx: np.ndarray          # node -> reduced DOF
    rsign: np.ndarray
    nred: int
    cond_dof: np.ndarray      # conductor -> reduced DOF (-1: none)
    geom: object              # assembly.TriGeometry
    area: np.ndarray
    dep_el: np.ndarray        # element depth (2 pi r when axisymmetric)
    kludge: np.ndarray        # external-region warp
    fixed_mask: np.ndarray
    fixed_vals: np.ndarray
    bdry_edges: list          # (a, b, boundary index, multiplicity)
    b_extra: np.ndarray       # point sources + conductor total flux
    dof_coords: np.ndarray
    nonlinear: bool
    Kt: np.ndarray            # (T,) volumetric heat capacity
    qv: np.ndarray            # (T,) volume heat source
    nl_el: np.ndarray         # (T,) elements with a K(T) curve
    has_rad: bool
    axi: bool
    depth: float
    sess: "solver.Session"
    #: (Tprev key, the K(T) loop's DeviceHeat or None when ineligible,
    #: the ``qv`` its right-hand side holds), once a solve's first pass
    #: has built it
    dev_heat: "tuple | None" = None
    #: (index, value) pairs of the A.g coupling of every element but
    #: the K(T) ones (``_rhs_nofixed``); () with no nonzero Dirichlet value
    lift: "tuple | None" = None


#: the static setup of the heat solve, keyed by (mesh identity, device,
#: ``_source_free_fingerprint``) and holding (that fingerprint,
#: HeatSetup): a new problem on the same mesh that differs only in its
#: sources takes the setup and refreshes ``qv``. The setup holds its
#: mesh, so the mesh's id cannot pass to another while it is cached; the
#: Session keeps tensors on its device, so a CPU solve and a CUDA solve
#: each keep their own
_HEAT_SETUP_CACHE: "collections.OrderedDict[tuple, tuple]" = \
    collections.OrderedDict()
_HEAT_SETUP_CACHE_MAX = 4


def _source_free_fingerprint(problem: Problem):
    """The content hash of everything the static setup depends on (the
    property fingerprint, ``dT`` and the external region) with every
    block property's ``qv`` left out; None when it cannot be taken
    (then nothing is cached)."""
    fp = source_free_fingerprint(problem, "qv")
    if fp is None:
        return None
    return (fp, getattr(problem, "dT", 0.0), problem.extRo, problem.extRi,
            problem.extZo)


def _element_qv(blk, mats) -> np.ndarray:
    """(T,) volume heat source per element."""
    return np.array([m.qv for m in mats])[blk]


def _setup_static(problem, mesh, labels, mats, conductors, units, axi,
                  depth):
    """All (problem, mesh)-static state of the heat solve: geometry,
    marker decoding, conductor prolongation, fixed DOFs, boundary
    edges, per-element property arrays and the solver Session, as a
    ``HeatSetup``. Cached per mesh in _HEAT_SETUP_CACHE."""
    xy = mesh.nodes * units
    tris = mesh.elements
    N = mesh.num_nodes
    T = mesh.num_elements
    with phase("heat element properties"):
        lbl_bt = np.array([l.BlockType for l in labels], np.int64)
        blk = lbl_bt[mesh.element_labels]

    with phase("heat marker decoding"):
        node_pp, node_cond, edge_bdry, edge_cond = decode_markers(mesh)
        ridx, rsign, nred, cond_dof = conductor_prolongation(
            N, mesh.pbc_pairs, node_cond, conductors)

    geom = assembly.tri_geometry(xy, tris)
    area = np.asarray(geom.area)
    rc = xy[tris][:, :, 0].mean(axis=1)
    dep_el = 2.0 * PI * rc if axi else np.full(T, depth)

    # external-region warp (hsolver.cpp:578-586)
    kludge = np.ones(T)
    if axi:
        lbl_ext = np.array([l.IsExternal for l in labels], bool)
        is_ext = lbl_ext[mesh.element_labels]
        if is_ext.any():
            extRo = problem.extRo * units
            extRi = problem.extRi * units
            extZo = problem.extZo * units
            z = xy[tris][:, :, 1].mean(axis=1) - extZo
            kludge = np.where(is_ext, (rc * rc + z * z) / (extRi * extRo),
                              1.0)

    # fixed DOFs
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
    # fixed-T segments (BdryFormat 0)
    bdry_edges = []        # (a, b, bf_index, mult)
    edge_count = EdgeMultiplicity(tris)
    marked = np.nonzero((np.asarray(edge_bdry) >= 0)
                        & (np.asarray(edge_bdry)
                           < len(problem.lineproplist)))[0]
    for ei in marked:
        a, b = mesh.edges[ei]
        bi = edge_bdry[ei]
        bp = problem.lineproplist[bi]
        if bp.BdryFormat == 0:
            for nd in (a, b):
                fixed_mask[ridx[nd]] = True
                fixed_vals[ridx[nd]] = bp.Tset
        elif bp.BdryFormat in (1, 2, 3):
            mult = edge_count.get(tuple(sorted((int(a), int(b)))), 1)
            bdry_edges.append((int(a), int(b), bi, mult))

    # point sources + conductor total-flux RHS
    b_extra = np.zeros(nred)
    for i in special:
        j = node_pp[i]
        if 0 <= j < npp:
            pp = problem.nodeproplist[j]
            if pp.qp != 0 and not fixed_mask[ridx[i]]:
                dp = 2.0 * PI * xy[i, 0] if axi else depth
                b_extra[ridx[i]] += dp * pp.qp
    for ci, cond in enumerate(conductors):
        if cond.CircType == 0 and cond_dof[ci] >= 0:
            b_extra[cond_dof[ci]] += cond.q

    dof_coords = np.zeros((nred, 2))
    dof_coords[ridx] = xy

    with phase("heat element properties"):
        mat_npts = np.array([m.npts for m in mats], np.int64)
        mat_kt = np.array([m.Kt for m in mats])
        nl_el = mat_npts[blk] > 0
        Kt = mat_kt[blk]
        qv = _element_qv(blk, mats)
    has_rad = any(problem.lineproplist[bi].BdryFormat == 3
                  for _a, _b, bi, _m in bdry_edges)
    nonlinear = bool(nl_el.any()) or has_rad

    return HeatSetup(
        mesh=mesh, xy=xy, tris=tris, blk=blk, node_pp=node_pp,
        node_cond=node_cond, edge_bdry=edge_bdry, ridx=ridx, rsign=rsign,
        nred=nred, cond_dof=cond_dof, geom=geom, area=area, dep_el=dep_el,
        kludge=kludge, fixed_mask=fixed_mask, fixed_vals=fixed_vals,
        bdry_edges=bdry_edges, b_extra=b_extra, dof_coords=dof_coords,
        nonlinear=nonlinear, Kt=Kt, qv=qv, nl_el=nl_el, has_rad=has_rad,
        axi=axi, depth=depth, sess=solver.Session())


def system(problem: Problem, su: HeatSetup, Vo: np.ndarray,
           Tp: np.ndarray):
    """The linear system of one substitution pass: the element blocks
    at the conductivity of the nodal temperatures ``Vo`` (the 3-node
    average of K(T)), the transient lumped term about the previous
    step's ``Tp``, the derivative boundary edges (radiation linearized
    about ``Vo``) and the right-hand side. Returns ``(blocks, b)``."""
    xy, tris, blk, ridx, rsign = su.xy, su.tris, su.blk, su.ridx, su.rsign
    geom, area, dep_el, kludge = su.geom, su.area, su.dep_el, su.kludge
    axi, depth = su.axi, su.depth
    dT = getattr(problem, "dT", 0.0)
    mats = problem.blockproplist
    T = tris.shape[0]
    # element conductivity: 3-node average of K(T_prev)
    knx = np.zeros(T)
    kny = np.zeros(T)
    for bidx in set(blk.tolist()):
        sel = blk == bidx
        mat = mats[bidx]
        if mat.npts == 0:
            knx[sel] = mat.Kx
            kny[sel] = mat.Ky
        else:
            kav = mat.get_k_array(Vo[tris[sel]]).mean(axis=1)
            knx[sel] = kav
            kny[sel] = kav

    Kx = -dep_el * knx / (4.0 * area) / kludge
    Ky = -dep_el * kny / (4.0 * area) / kludge
    Me = (Kx[:, None, None] * geom.p[:, :, None] * geom.p[:, None, :]
          + Ky[:, None, None] * geom.q[:, :, None] * geom.q[:, None, :])
    be = np.zeros((T, 3))
    if dT != 0:
        Kt_term = -dep_el * su.Kt * area / (3.0 * dT)
        Me = Me + Kt_term[:, None, None] * np.eye(3)[None]
        be = be + Kt_term[:, None] * Tp[tris]
    be = be + (-dep_el * su.qv * area / 3.0)[:, None]

    blocks = [ElementBlock(idx=ridx[tris], sign=rsign[tris], mat=-Me)]
    b = np.zeros(su.nred)
    np.add.at(b, ridx[tris].reshape(-1),
              -(rsign[tris] * be).reshape(-1))
    b += su.b_extra

    # derivative boundary edges (hsolver.cpp:655-722)
    edges = su.bdry_edges
    if edges:
        eidx = np.zeros((len(edges), 2), np.int64)
        esgn = np.ones((len(edges), 2))
        emat = np.zeros((len(edges), 2, 2))
        for row, (a, bb, bi, mult) in enumerate(edges):
            bp = problem.lineproplist[bi]
            length = float(np.hypot(*(xy[bb] - xy[a])))
            bf = bp.BdryFormat
            if bf == 1:
                c0, c1 = 0.0, bp.qs
            elif bf == 2:
                c0, c1 = bp.h, -bp.h * bp.Tinf
            else:   # radiation, linearized about previous iterate
                Tlast = (Vo[a] + Vo[bb]) / 2.0
                c0 = 4.0 * bp.beta * KSB * Tlast ** 3
                c1 = -(bp.beta * KSB * (bp.Tinf ** 4
                                        + 3.0 * Tlast ** 4))
            eidx[row] = (ridx[a], ridx[bb])
            esgn[row] = (rsign[a], rsign[bb])
            if axi:
                ra, rb = xy[a, 0], xy[bb, 0]
                K = -2.0 * PI * c0 * length / 6.0 * mult
                emat[row] = -np.array([
                    [2.0 * (3 * ra + rb) / 4.0, (ra + rb) / 2.0],
                    [(ra + rb) / 2.0, 2.0 * (ra + 3 * rb) / 4.0]]) * K
                Kb = 2.0 * PI * c1 * length / 2.0 * mult
                b[ridx[a]] -= rsign[a] * Kb * (2 * ra + rb) / 3.0
                b[ridx[bb]] -= rsign[bb] * Kb * (ra + 2 * rb) / 3.0
            else:
                K = -depth * c0 * length / 6.0 * mult
                emat[row] = -K * np.array([[2.0, 1.0], [1.0, 2.0]])
                Kb = depth * c1 * length / 2.0 * mult
                b[ridx[a]] -= rsign[a] * Kb
                b[ridx[bb]] -= rsign[bb] * Kb
        blocks.append(ElementBlock(idx=eidx, sign=esgn, mat=emat))
    return blocks, b


def load_previous(problem: Problem, mesh: MeshData) -> np.ndarray:
    """T of the previous time step from the file named by ``PrevSoln``
    (LoadPrev, hsolver.cpp:860-866), matched node for node by
    coordinates."""
    from scipy.spatial import cKDTree

    from ..io import ansfile
    g = ansfile.read_ans(problem.PrevSoln)
    d, idx = cKDTree(g.mesh.nodes).query(mesh.nodes)
    if d.max() > 1e-08:
        raise ValueError("previous solution mesh does not match")
    return np.real(g.values)[idx]


def _heat_chain(dev_heat, sess, V, res: float, precision: float, dev):
    """The substitution middle on the device: up to 12 budget-bounded
    ``newton.run_heat`` dispatches from the host iterate, chained while a
    dispatch ends on its CG budget and still improves (the JAX package's
    rules, steps capped at 30 over the chain). Leaves the session's
    hierarchy as the loop left it (``newton.keep_loop_band``). Returns
    ``(V, res, steps, cg_iterations)``."""
    import torch

    from ..ops import newton as newton_dev
    cg_budget = newton_dev.dispatch_cg_budget(sess)
    target = max(90.0 * precision, 3e-6)
    Vd = torch.as_tensor(V, dtype=torch.float32, device=dev)
    res_d = res
    cgit = 0.0
    steps = 0
    for _sub in range(12):
        state = torch.tensor([res_d], dtype=torch.float32, device=dev)
        Vd, dvec, oob_vals, stats = newton_dev.run_heat(
            dev_heat, sess.band_amg, Vd, state, tol_floor=max(precision, 3e-7),
            target_res=target, bt=sess.bt, cg_budget=cg_budget)
        prev_res = res_d
        res_d, ksteps, cg_sub = stats.double().cpu().numpy()
        cgit += cg_sub
        steps += int(ksteps)
        budget_cut = (cg_budget > 0 and cg_sub >= cg_budget
                      and int(ksteps) > 0 and res_d > target)
        if not budget_cut or res_d >= 0.98 * prev_res:
            break
        # the chain must not multiply the per-run step cap
        if steps >= 30:
            break
    newton_dev.keep_loop_band(sess, dvec, oob_vals)
    return Vd.double().cpu().numpy(), float(res_d), steps, cgit


def solve(problem: Problem, mesh: MeshData, Tprev: np.ndarray | None = None,
          max_iter: int = 100, devices: int | None = None,
          device_mesh=None, device=None,
          hbm_bytes: float | None = None) -> HeatSolution:
    """Heat-flow solve. ``device`` runs the linear solves and the K(T)
    loop: CUDA when omitted (an error when CUDA is unavailable), or the
    named device -- ``"cpu"`` runs the kernels' plain PyTorch versions
    on the host and needs ``hbm_bytes``, the device memory the band
    planner plans against. ``Tprev`` (or the file named by the problem's
    ``PrevSoln``) is the previous time step's nodal T of a transient
    (``dT`` != 0) step. ``devices=N`` runs every linear solve as a
    domain decomposition over N parts (``parallel/driver.py``) on the
    solve's device or the one device of ``device_mesh``, or one part per
    rank of a process group ``device_mesh``; the K(T) loop
    is then not taken, as in the JAX package."""
    from ..mesh.meshdata import resolve_default_labels
    resolve_default_labels(problem, mesh)
    dev = solver.resolve_device(device)
    dsess = dd_driver.session(devices, device_mesh, dev)
    if Tprev is None and problem.PrevSoln:
        Tprev = load_previous(problem, mesh)
    units = LENGTH_TO_METERS[problem.LengthUnits]
    axi = problem.ProblemType == ProblemType.AXISYMMETRIC
    N = mesh.num_nodes
    depth = problem.Depth * units if not axi else 1.0
    labels = [l for l in problem.labellist if not l.is_hole()]
    mats = problem.blockproplist
    conductors = problem.circproplist

    # the static setup (marker decoding, geometry, fixed DOFs, boundary
    # edges, per-element property arrays, and the Session with its band
    # state on ``dev``), kept per mesh across repeat solves (transient
    # chains, sweeps, a pyFEMM or Lua edit and re-analysis): "built",
    # "sources" (only qv differs: qv refreshed) or "reused"
    with phase("heat static setup"):
        fp = _source_free_fingerprint(problem)
        ckey = (id(mesh), str(dev), fp)
        hit = (solver.lru_get(_HEAT_SETUP_CACHE, ckey) if fp is not None
               else None)
        su = hit[1] if hit is not None and hit[1].mesh is mesh else None
        qv = None if su is None else _element_qv(su.blk, mats)
        kind = ("built" if su is None
                else "reused" if np.array_equal(qv, su.qv) else "sources")
        with phase(f"heat setup ({kind})"):
            if su is None:
                su = _setup_static(problem, mesh, labels, mats, conductors,
                                   units, axi, depth)
                if fp is not None:
                    solver.lru_put(_HEAT_SETUP_CACHE, ckey, (fp, su),
                                   _HEAT_SETUP_CACHE_MAX)
            if kind == "sources":
                su.qv = qv
                # the iteration baseline of the factor's staleness test
                # starts anew, as a fresh Session adopting the band does
                su.sess.first_iters = None
    ridx, rsign, sess = su.ridx, su.rsign, su.sess
    nonlinear = su.nonlinear

    dT = getattr(problem, "dT", 0.0)
    Tp = np.zeros(N) if Tprev is None else np.asarray(Tprev)
    # the loop's right-hand side holds the transient term of THIS Tprev:
    # a cached DeviceHeat serves only the step it was built for
    tp_key = Tp.tobytes() if dT != 0 else None

    Vo = np.zeros(N)           # previous nodal temperatures
    V = np.zeros(su.nred)
    iters_total = 0
    rel_resid = 0.0
    res = 0.0
    dev_heat = su.dev_heat[1] if (dsess is None and su.dev_heat is not None
                                  and su.dev_heat[0] == tp_key) else None
    dev_runs = 0

    for it in range(max_iter if nonlinear else 1):
        # the substitution MIDDLE runs on the device as one loop
        # (ops/newton.py::run_heat): K(T) lookup, operator refresh,
        # preconditioned CG, convergence test. The accepting pass at the
        # full contract Precision stays on the host below.
        if (dev_heat is not None and dev_runs < 2 and it > 0
                and res >= 3e4 * problem.Precision
                and sess.band_amg is not None):
            with phase("device heat", device=True):
                V, res, _steps, cgit = _heat_chain(
                    dev_heat, sess, V, res, problem.Precision, dev)
            iters_total += int(cgit)
            dev_runs += 1
            Vo = V[ridx] * rsign
            continue
        with phase("heat assembly"):
            blocks, b = system(problem, su, Vo, Tp)

        # inexact forcing: early successive-substitution iterations only
        # need to out-resolve the current outer error; acceptance always
        # follows a full-Precision solve
        if not nonlinear or (it > 0 and res < 3e4 * problem.Precision):
            tol_it = problem.Precision
        elif it == 0:
            tol_it = max(problem.Precision, 1e-4)
        else:
            tol_it = max(problem.Precision, min(1e-4, 0.03 * res))
        changed = None
        if nonlinear:
            changed = [su.nl_el]
            if len(blocks) > 1:
                changed.append(np.ones(len(blocks[1].idx), bool)
                               if su.has_rad else None)

        V_old = V
        if dsess is not None:
            with phase("distributed solve"):
                V, rel_resid, cg_iters = dsess.solve(
                    blocks, b, su.fixed_mask, su.fixed_vals, tol_it,
                    x0=V if it > 0 else None, coords=su.dof_coords)
        else:
            V, rel_resid, cg_iters = solver.solve(
                blocks, b, su.fixed_mask, su.fixed_vals, tol_it,
                x0=V if it > 0 else None, coords=su.dof_coords,
                session=sess, changed=changed, device=dev, hbm=hbm_bytes)
        V = np.asarray(V)
        iters_total += int(cg_iters)
        Vo = V[ridx] * rsign

        if not nonlinear:
            break
        e1 = float(np.sum((V - V_old) ** 2))
        e2 = float(np.sum(V_old ** 2))
        # unit sentinel when no previous iterate exists (it-0 against
        # V_old = 0): the substitution error is unknown, so the forcing
        # schedule must stay loose rather than jump to full precision
        res = math.sqrt(e1 / e2) if e2 != 0 else 1.0
        if (e2 != 0 and res < problem.Precision * 100.0
                and tol_it <= problem.Precision):
            break

        # after the it-0 solve has built the band hierarchy and value
        # maps, intermediate substitution iterations can run on device;
        # a kept loop under new sources takes this pass's right-hand side
        if it == 0 and dsess is None and not su.has_rad:
            if (dev_heat is None
                    and not os.environ.get("XFEMM_TPU_NO_DEVICE_NEWTON")):
                with phase("heat loop setup", device=True):
                    dev_heat = _setup_device_heat(problem, su, blocks, b,
                                                  dev, hbm_bytes)
                su.dev_heat = (tp_key, dev_heat, su.qv)
            elif dev_heat is not None and su.dev_heat[2] is not su.qv:
                with phase("heat loop setup", device=True):
                    dev_heat = dev_heat._replace(rhs_pre=_loop_rhs(
                        problem, su, blocks, b, dev_heat.rhs_pre.device))
                su.dev_heat = (tp_key, dev_heat, su.qv)

    Tn = V[ridx] * rsign

    # conductor results: solved T and total flux (ChargeOnConductor,
    # hsolver.cpp:987-1042: gradient of the conductor indicator weighted
    # by the flux density, integrated over adjacent elements)
    with phase("heat conductor results"):
        cond_V = np.zeros(len(conductors))
        cond_q = np.zeros(len(conductors))
        for ci, cond in enumerate(conductors):
            if cond.CircType == 0:
                cond_q[ci] = cond.q
                if su.cond_dof[ci] >= 0:
                    cond_V[ci] = V[su.cond_dof[ci]]
            else:
                cond_V[ci] = cond.V
                cond_q[ci] = _charge_on_conductor(
                    ci, su.node_cond, su.xy, su.tris, su.blk, mats, Tn, axi,
                    depth)

        node_Q = compute_node_Q(problem, mesh, su.node_pp, su.node_cond,
                                su.edge_bdry)
    return HeatSolution(problem=problem, mesh=mesh, T=Tn,
                        node_Q=node_Q, conductor_V=cond_V,
                        conductor_q=cond_q, iterations=iters_total,
                        residual=float(rel_resid))


def _lumped_mat(problem: Problem, su: HeatSetup, sel=slice(None)):
    """The k-independent block matrices of elements ``sel``: the
    transient lumped term, zero in a steady problem."""
    dT = getattr(problem, "dT", 0.0)
    area = su.area[sel]
    mat_0 = np.zeros((area.shape[0], 3, 3))
    if dT != 0:
        Kt_term0 = -su.dep_el[sel] * su.Kt[sel] * area / (3.0 * dT)
        mat_0 += -Kt_term0[:, None, None] * np.eye(3)[None]
    return mat_0


def _rhs_nofixed(su: HeatSetup, blocks, b) -> np.ndarray:
    """``b`` with the A.g coupling of every element but the K(T) ones
    removed. The coupling is matrix-only (the loop runs without
    radiation, the one boundary whose matrix follows the iterate): its
    (index, value) pairs are kept in ``su.lift`` and subtracted in the
    order of the blocks' entries."""
    fixed_mask, fixed_vals = su.fixed_mask, su.fixed_vals
    if su.lift is None:
        su.lift = ()
        if fixed_mask.any() and np.any(fixed_vals[fixed_mask] != 0.0):
            g = np.where(fixed_mask, fixed_vals, 0.0)
            idx, val = [], []
            for bi_, blkk in enumerate(blocks):
                bidx = np.asarray(blkk.idx)
                bsgn = np.asarray(blkk.sign, np.float64)
                bmat = np.asarray(blkk.mat, np.float64)
                if bi_ == 0:
                    bmat = bmat.copy()
                    bmat[su.nl_el] = 0.0
                ye = np.einsum("ekl,el->ek", bmat, bsgn * g[bidx])
                idx.append(bidx.reshape(-1))
                val.append((bsgn * ye).reshape(-1))
            su.lift = (np.concatenate(idx), np.concatenate(val))
    b_nofixed = np.asarray(b, np.float64).copy()
    if su.lift:
        np.subtract.at(b_nofixed, *su.lift)
    return b_nofixed


def _setup_device_heat(problem: Problem, su: HeatSetup, blocks, b, dev,
                       hbm_bytes):
    """The loop's device data after the it-0 solve (``newton.setup_heat``,
    None when ineligible): the block matrix as mat_0 + k * mat_k for the
    K(T) elements (the transient lumped term is k-independent), and the
    right-hand side with the changed elements' A.g coupling removed
    entirely (setup folds the k-independent part back in)."""
    from ..ops import newton as newton_dev
    geom, area, dep_el = su.geom, su.area, su.dep_el
    blk = su.blk
    mats = problem.blockproplist
    ce = dep_el / (4.0 * area) / su.kludge
    pq = (geom.p[:, :, None] * geom.p[:, None, :]
          + geom.q[:, :, None] * geom.q[:, None, :])
    mat_k_full = ce[:, None, None] * pq
    mats_T = {bi2: mats[bi2].Tdata for bi2 in set(blk.tolist())}
    mats_K = {bi2: mats[bi2].Kdata for bi2 in set(blk.tolist())}
    return newton_dev.setup_heat(
        su.sess, su.ridx, su.rsign, su.tris, su.fixed_mask, su.fixed_vals,
        mats_T, mats_K, blk, mat_k_full, _lumped_mat(problem, su),
        _rhs_nofixed(su, blocks, b), device=dev, hbm=hbm_bytes)


def _loop_rhs(problem: Problem, su: HeatSetup, blocks, b, device):
    """The loop's ``rhs_pre`` for this pass's ``b``, as ``setup_heat``
    builds it: under new sources the loop's matrices, maps and Dirichlet
    coupling stand, and only the right-hand side follows ``b``."""
    from ..ops import newton as newton_dev
    # the loop's changed elements: setup_heat's ``ns``, from the
    # ``changed`` mask the solves pass
    ns = np.nonzero(su.nl_el)[0]
    tn = su.tris[ns]
    return newton_dev.heat_rhs(
        _rhs_nofixed(su, blocks, b), su.ridx[tn], su.rsign[tn],
        _lumped_mat(problem, su, ns), su.fixed_mask, su.fixed_vals, device)


def _charge_on_conductor(ci, node_cond, xy, tris, blk, mats, Tn, axi,
                         depth):
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
    Dx = -(Tn[t] * bb).sum(axis=1) / da
    Dy = -(Tn[t] * cc).sum(axis=1) / da
    kn = np.zeros((sel.sum(), 2))
    for row, (el_nodes, bidx) in enumerate(zip(t, blk[sel])):
        mat = mats[bidx]
        ks = [mat.get_k(Tn[nd]) for nd in el_nodes]
        kn[row, 0] = sum(k[0] for k in ks) / 3.0
        kn[row, 1] = sum(k[1] for k in ks) / 3.0
    return float(np.sum(a * (Dx * kn[:, 0] * vx + Dy * kn[:, 1] * vy)))
