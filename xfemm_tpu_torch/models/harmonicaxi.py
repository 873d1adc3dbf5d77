"""Time-harmonic axisymmetric magnetics (HarmonicAxisymmetric semantics)
on PyTorch.

Functional equivalent of cfemm/fsolver/harmonicaxi.cpp:34-820: the
axisymmetric r-weighted element matrices of the static path (staticaxi
geometry with the log-mean radius R_hat) with complex effective
permeability, a lumped eddy term -j*R*a*w*sigma*c/6 * 4/3 per entry,
2r-weighted Robin/impedance boundaries, on-axis pinning, loop-factor
point currents, circuit Case 2 voltage-gradient DOFs (couplings without
the R factor, diagonal and RHS carrying 1/R and 2x factors), and flux
output 2*pi*r*c*V. Successive approximation for nonlinear B-H, with B
from the conjugated energy form.

Same sign convention and linear solve as models/harmonic.py
(``solver.solve_complex`` on the card), whose vectorised circuit
helpers it shares.
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import C_APOT, PI, ProblemType
from ..geometry.problem import Problem
from ..mesh.meshdata import MeshData
from ..ops import assembly, solver
from ..ops.solver import ElementBlock
from ..parallel import driver as dd_driver
from ..utils.profiling import phase
from .harmonic import (ACSetup, _c2_blocks, _circuit_source, _displacement,
                       _edge_blocks, _label_case, _nonlinear_mu, _rhs_c)
from .magnetostatics import MagSolution, pack


def solve(problem: Problem, mesh: MeshData, max_newton: int = 100,
          devices: int | None = None, device_mesh=None, device=None,
          hbm_bytes: float | None = None) -> MagSolution:
    """Axisymmetric AC solve; ``devices``, ``device_mesh``, ``device``
    and ``hbm_bytes`` as for ``harmonic.solve``."""
    assert problem.ProblemType == ProblemType.AXISYMMETRIC
    assert problem.Frequency != 0
    with phase("pack"):
        pk = pack(problem, mesh)
    c = C_APOT
    w = problem.Frequency * 2.0 * PI
    geom = assembly.axi_geometry(pk.xy, pk.tris)
    Mx, My, _Mxy = assembly.axi_curl_matrices(geom)
    T = pk.tris.shape[0]
    area = np.asarray(geom.area)
    R = np.asarray(geom.R)
    vol = np.asarray(geom.vol)
    mats = problem.blockproplist

    for m in mats:
        if m.BHpoints > 0 and not m.slope:
            m.get_slopes(w)

    # circuit cases: CircInt2 = a*sigma/(0.01 r) (harmonicaxi.cpp:86-160)
    ac = ACSetup(problem, pk, area, w, 1.0 / (0.01 * R))
    mu1, mu2 = ac.mu1.copy(), ac.mu2.copy()
    ntot = ac.ntot
    # lumped eddy: ref Me += (-j R a w sigma c/6)*4/3 per entry; negated
    eddy_K = 1j * R * area * w * ac.sigma_eddy * c / 6.0 * (4.0 / 3.0)
    M_eddy = eddy_K[:, None, None] * np.ones((1, 3, 3))

    # on-axis nodes already pinned by pack (fixed to 0)
    fixed_mask = np.zeros(ntot, bool)
    fixed_mask[:pk.nreduced] = pk.fixed_mask
    fixed_vals = np.zeros(ntot, complex)
    fixed_vals[:pk.nreduced] = pk.fixed_vals_c

    # sources -2R(J+Jv)a/3; Case 0 Jv = -100 dV sigma / R
    Jv = _circuit_source(pk, ac, 100.0 / R)
    src = -2.0 * R * (ac.Jc_block + Jv) * area / 3.0
    be_static = np.tile(src[:, None], (1, 3))

    # point currents: ref b -= 2r*0.01*J -> negated (pack stores 0.01*J
    # without the loop factor; apply it here)
    b_extra = np.zeros(ntot, complex)
    pp_idx = (mesh.node_markers & 0xFFFF).astype(np.int64) - 2
    nodes = np.nonzero((pp_idx >= 0)
                       & (pp_idx < len(problem.nodeproplist)))[0]
    ppJ = np.array([complex(problem.nodeproplist[j].J)
                    for j in pp_idx[nodes]], complex)
    on = ppJ != 0
    np.add.at(b_extra, pk.ridx[nodes[on]],
              2.0 * pk.xy[nodes[on], 0] * 0.01 * ppJ[on]
              * pk.rsign[nodes[on]])
    for k in ac.case2_ids:
        b_extra[ac.case2_slot[k]] -= 2.0 * 0.01 * complex(
            pk.circuits[k].Amps)
    # ref b[cdof] += (-2R J a/3)/R per corner -> negated
    sel = ac.c2_el
    np.add.at(b_extra, ac.case2_slot[pk.circuit[sel]],
              3.0 * (2.0 * ac.Jc_block[sel] * area[sel] / 3.0))

    Kc2 = 2j * area * w * ac.sigma_raw * c
    static_blocks = _edge_blocks(
        pk, c, w, lambda a, b: pk.xy[a, 0] + pk.xy[b, 0])
    static_blocks.extend(_c2_blocks(pk, ac, Kc2, Kc2 / R))

    nonlinear = bool((np.array([m.BHpoints > 0 for m in mats])[pk.blk]).any())
    bh = {int(i): mats[i].knot_arrays_complex()
          for i in np.unique(pk.blk) if mats[i].BHpoints > 0}

    # devices=N: distributed complex-symmetric solves (Jacobi on (re, im)
    # pairs); circuit Case-2 bordered rows keep the single-device path,
    # as in the JAX package
    dsess = dd_driver.session(None if ac.case2_ids else devices,
                              device_mesh, device, schwarz=False)
    dof_coords_c = np.zeros((ntot, 2))
    dof_coords_c[pk.ridx] = pk.xy

    V = np.zeros(ntot, complex)
    relax = 1.0
    res = 0.0
    lastres = 0.0
    iters_total = 0
    rel_resid = 0.0
    for it in range(max_newton if nonlinear else 1):
        with phase("ac elements"):
            Mn = np.zeros((T, 3, 3), complex)
            be = be_static.copy()
            if it > 0:
                Vl = (pk.rsign[pk.tris] * V[pk.ridx[pk.tris]]).astype(complex)
                vv_vec = np.einsum("tjw,tw->tj", (Mx + My).astype(complex),
                                   Vl)
                dv_en = np.einsum("tj,tj->t", np.conj(Vl), vv_vec) \
                    * (1e4 * c * c / vol)
                _nonlinear_mu(np.sqrt(np.abs(dv_en)), pk, bh, mu1, mu2, Mn,
                              Mx + My)
                be = be + np.einsum("tjk,tk->tj", Mn, Vl)
            Me = Mx / mu2[:, None, None] + My / mu1[:, None, None] - M_eddy
            blocks = [ElementBlock(idx=pk.ridx[pk.tris],
                                   sign=pk.rsign[pk.tris], mat=-Me)]
            blocks.extend(static_blocks)
            b = _rhs_c(pk, be, b_extra, ntot)

        V_old = V
        if dsess is not None:
            with phase("distributed solve"):
                V, rel_resid, cg_iters = dsess.solve_complex(
                    blocks, b, fixed_mask, fixed_vals, problem.Precision,
                    x0=V if it > 0 else None, coords=dof_coords_c)
        else:
            V, rel_resid, cg_iters = solver.solve_complex(
                blocks, b, fixed_mask, fixed_vals, problem.Precision,
                x0=V if it > 0 else None, device=device, hbm=hbm_bytes)
        V = np.asarray(V)
        iters_total += int(cg_iters)

        if not nonlinear:
            break
        num, den = _displacement(V, V_old, pk.nreduced)
        if den == 0:
            break
        lastres = res
        res = math.sqrt(num / den)
        if it > 5:
            if res > lastres and relax > 0.1:
                relax /= 2.0
            else:
                relax += 0.1 * (1.0 - relax)
            V = relax * V + (1.0 - relax) * V_old
        if res < 100.0 * problem.Precision and it > 0:
            break

    Vfull = V[pk.ridx] * pk.rsign
    A = Vfull * c * 2.0 * PI * pk.xy[:, 0] * 0.01
    for k in ac.case2_ids:
        ac.circdV[k] = 1j * w * c * 0.01 * V[ac.case2_slot[k]]

    return MagSolution(problem=problem, mesh=mesh, A=A,
                       circuits=pk.circuits,
                       label_case=_label_case(pk, ac, first=False),
                       iterations=iters_total, residual=float(rel_resid),
                       newton_iterations=it + 1)
