"""Nonlinear axisymmetric magnetostatics (StaticAxisymmetric semantics)
on PyTorch.

Functional equivalent of the reference's ``FSolver::StaticAxisymmetric``
(cfemm/fsolver/staticaxi.cpp:45-800): the element trial space is
``c0 + c1 r^2 + c2 z`` giving r-weighted stiffness matrices (Mr with the
arithmetic radius, Mz with the log-mean radius R_hat), on-axis DOFs pinned
to zero, loop factors 2*pi*r on sources, the Kelvin-transform permeability
warp of external regions, and the solved quantity written out as flux
2*pi*r*A (Webers). Assembly is batched on the host in f64; every linear
solve goes to ops/solver.py (the card's f32 band CG, as the planar model).

Newton chain: host iteration 0, the Newton middle on the device through
the planar model's ``magnetostatics._device_chain`` with ``axi=True``
(``newton.run``, or chained ``run_scatter`` steps above a 3 GB fine
band), then the host endgame at the full contract Precision. The JAX
package's axisymmetric model keeps its own copy of that chain; sharing
the planar one makes its scatter floor exit (``SCATTER_FLOOR``, ROADMAP
§C) apply here too, a deliberate difference from the reference.
``XFEMM_TPU_NO_DEVICE_NEWTON=1`` keeps every iteration on the host
chain. As in the JAX package every solve starts a fresh
``solver.Session``; a repeat solve adopts the band hierarchy and factor
from the solver's pattern-keyed band cache.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..constants import C_APOT, MU0, PI, ProblemType
from ..geometry.problem import Problem
from ..mesh.meshdata import MeshData
from ..ops import assembly, solver
from ..parallel import driver as dd_driver
from ..utils.profiling import phase
from .magnetostatics import (MagSolution, PackedMagnetostatic, _device_chain,
                             _element_blocks, _rhs, pack)


def _circuit_preprocess_axi(pk: PackedMagnetostatic, geom):
    """Case selection and per-circuit J / dV with the axisymmetric loop
    integrals (staticaxi.cpp:74-137): CircInt2 carries 100*a*sigma/r."""
    area = np.asarray(geom.area)
    R = np.asarray(geom.R)
    nc = len(pk.circuits)
    if nc == 0:
        return
    has = pk.circuit >= 0
    ci = pk.circuit[has]
    a_s = area[has]
    i1 = np.bincount(ci, weights=a_s, minlength=nc)
    i2 = np.bincount(ci, weights=100.0 * a_s * pk.Cduct[has] / R[has],
                     minlength=nc)
    i3 = np.bincount(ci, weights=pk.Jre[has] * a_s * 100.0, minlength=nc)
    for k, c in enumerate(pk.circuits):
        if c.CircType == 0:
            if i2[k] == 0:
                c.Case = 1
                c.J = 0.0 if i1[k] == 0 else 0.01 * (c.Amps.real - i3[k]) / i1[k]
            else:
                c.Case = 0
                c.dV = -0.01 * (c.Amps.real - i3[k]) / i2[k]
        else:
            c.Case = 0
            c.dV = c.dVolts.real


def _circuit_source(pk: PackedMagnetostatic, R):
    """Element circuit source density t (staticaxi.cpp:340-352): the
    circuit's J for Case 1, -100 dV sigma / r for Case 0."""
    T = pk.tris.shape[0]
    if not pk.circuits:
        return np.zeros(T)
    cJ = np.array([complex(c.J).real for c in pk.circuits])
    cdV = np.array([complex(c.dV).real for c in pk.circuits])
    cCase = np.array([c.Case for c in pk.circuits])
    has = pk.circuit >= 0
    cis = np.where(has, pk.circuit, 0)
    return np.where(has, np.where(cCase[cis] == 1, cJ[cis],
                                  -100.0 * cdV[cis] * pk.Cduct / R), 0.0)


def solve(problem: Problem, mesh: MeshData, max_newton: int = 100,
          devices: int | None = None, device_mesh=None, device=None,
          hbm_bytes: float | None = None) -> MagSolution:
    """Axisymmetric nonlinear magnetostatic solve. ``device`` and
    ``hbm_bytes`` as for ``magnetostatics.solve``: CUDA when omitted,
    ``"cpu"`` runs the kernels' plain versions with an explicit
    ``hbm_bytes`` for the band planner. ``devices`` / ``device_mesh``
    as for ``magnetostatics.solve``: every linear solve as a domain
    decomposition, the Newton chain on the host."""
    assert problem.ProblemType == ProblemType.AXISYMMETRIC
    dev = solver.resolve_device(device)
    dsess = dd_driver.session(devices, device_mesh, dev)
    with phase("pack"):
        pk = pack(problem, mesh)
    c = C_APOT
    with phase("geometry"):
        geom = assembly.axi_geometry(pk.xy, pk.tris)
        _circuit_preprocess_axi(pk, geom)
        Mx, My, Mxy = assembly.axi_curl_matrices(geom)

    T = pk.tris.shape[0]
    area = np.asarray(geom.area)
    R = np.asarray(geom.R)
    vol = np.asarray(geom.vol)
    rn = np.asarray(geom.rn)

    # sources: K = -2R(J+t)a/3 per corner (staticaxi.cpp:340-352)
    t_src = _circuit_source(pk, R)
    src = -2.0 * R * (pk.Jre + t_src) * area / 3.0
    # magnetization: edge j with midside radius (staticaxi.cpp:427-440)
    nxt = np.roll(np.arange(3), -1)
    prv_of = np.array([2, 0, 1])
    v = pk.xy[pk.tris]
    dxe = v[:, nxt, 0] - v[:, :, 0]
    dye = v[:, nxt, 1] - v[:, :, 1]
    redge = (rn + rn[:, nxt]) / 2.0
    th = pk.magdir * PI / 180.0
    Kmag = -0.0001 * redge * pk.Hc[:, None] * (
        np.cos(th)[:, None] * dxe + np.sin(th)[:, None] * dye)
    # edge j contributes K_j to corners j and j+1, so corner j collects
    # K_j + K_{j-1}; src is already the per-corner value -2R(J+t)a/3
    be_static = src[:, None] + Kmag + Kmag[:, prv_of]

    # initial permeabilities (staticaxi.cpp:429-451)
    lt = pk.lam_type
    f = pk.lam_fill
    mu1 = np.where(lt == 0, pk.mu_x * f,
                   np.where(lt == 1, pk.mu_x * f + (1 - f),
                            np.where(lt == 2, pk.mu_y * f + (1 - f), 1.0)))
    mu2 = np.where(lt == 0, pk.mu_y * f,
                   np.where(lt == 1, pk.mu_x / (f + pk.mu_x * (1 - f)),
                            np.where(lt == 2,
                                     pk.mu_y / (f + pk.mu_y * (1 - f)),
                                     1.0)))

    # external-region (Kelvin transform) permeability warp
    # (staticaxi.cpp:608-615); ext* are in problem units -> cm
    labels = [l for l in problem.labellist if not l.is_hole()]
    lab_ext = np.array([l.IsExternal for l in labels], bool)
    is_ext = lab_ext[pk.lbl]
    if is_ext.any():
        u = pk.units
        extRo = problem.extRo * u
        extRi = problem.extRi * u
        extZo = problem.extZo * u
        Z = v[:, :, 1].mean(axis=1) - extZo
        kludge = (R * R + Z * Z) * extRi / (extRo ** 3)
        mu1 = np.where(is_ext, mu1 / kludge, mu1)
        mu2 = np.where(is_ext, mu2 / kludge, mu2)

    nonlinear = bool(pk.nonlinear.any())
    nl = pk.nonlinear

    # representative coordinates per reduced DOF (band ordering)
    dof_coords = np.zeros((pk.nreduced, 2))
    dof_coords[pk.ridx] = pk.xy

    sess = solver.Session()
    V = np.zeros(pk.nreduced)
    relax = 1.0
    res = 0.0
    lastres = 0.0
    iters_total = 0
    rel_resid = 0.0
    dev_state = None
    dev_runs = 0
    it_shift = 0       # extra global iterations from device runs
    dev_handoff = False
    use_device = nonlinear and dsess is None and not os.environ.get(
        "XFEMM_TPU_NO_DEVICE_NEWTON")

    for it in range(max_newton if nonlinear else 1):
        # the Newton middle runs on the device (the planar model's
        # chain with the axisymmetric |B|); the accepting pass at the
        # full contract Precision stays on the host below
        if (dev_state is not None and dev_runs < 2 and it > 0
                and res >= 3e4 * problem.Precision
                and sess.band_amg is not None):
            dn, has_lam = dev_state
            with phase("device newton", device=True):
                V, relax_d, res, lastres, steps, cgit = _device_chain(
                    dn, has_lam, sess, V, relax, res, lastres,
                    float(it + it_shift), problem.Precision, dev, axi=True,
                    target=max(90.0 * problem.Precision, 3e-6))
            iters_total += int(cgit)
            dev_runs += 1
            it_shift += max(steps - 1, 0)
            # the device loop exits at an f32 noise floor; entering the
            # host tail over-damped makes it crawl
            relax = max(relax_d, 0.5)
            # the device residuals are f32-floor values: the next host
            # displacement must not trip the oscillation damping on them
            dev_handoff = True
            continue
        dev_handoff_prev = dev_handoff
        dev_handoff = False
        Mn = np.zeros((T, 3, 3))
        be = be_static
        if it > 0:
            with phase("newton host"):
                Vl = pk.rsign[pk.tris] * V[pk.ridx[pk.tris]]
                # B^2 from the energy quadratic form (staticaxi.cpp:510-521)
                MxMy0 = Mx + My
                MxMy1 = Mx + My / (f * f)[:, None, None]
                MxMy2 = Mx / (f * f)[:, None, None] + My
                Mb = np.where((lt == 0)[:, None, None], MxMy0,
                              np.where((lt == 1)[:, None, None], MxMy1,
                                       MxMy2))
                vv_vec = np.einsum("tjw,tw->tj", Mb, Vl)
                dv_en = np.einsum("tj,tj->t", Vl, vv_vec) * (1e4 * c * c
                                                             / vol)
                Bmag = np.sqrt(np.abs(dv_en))
                vv, dv = assembly.hermite_vdv(Bmag, pk.bh_B, pk.bh_H,
                                              pk.bh_S)
                mu_el = 1.0 / (MU0 * vv)
                mu1_new = np.where(lt == 0, mu_el,
                                   np.where(lt == 1, mu_el * f,
                                            mu_el / (f + mu_el * (1 - f))))
                mu2_new = np.where(lt == 0, mu_el,
                                   np.where(lt == 1,
                                            mu_el / (f + mu_el * (1 - f)),
                                            mu_el * f))
                mu1 = np.where(nl, mu1_new, mu1)
                mu2 = np.where(nl, mu2_new, mu2)
                # Newton matrices (staticaxi.cpp:523-600)
                v0 = np.einsum("tjw,tw->tj", Mx + My, Vl)
                Mn0 = (-200.0 * c ** 3 * dv / vol)[:, None, None] * \
                    v0[:, :, None] * v0[:, None, :]
                v1 = np.einsum("tjw,tw->tj", My / f[:, None, None] + Mx, Vl)
                u1 = np.einsum("tjw,tw->tj",
                               My / f[:, None, None] + f[:, None, None] * Mx,
                               Vl)
                Mn1 = (-100.0 * c ** 3 * dv / vol)[:, None, None] * (
                    v1[:, :, None] * u1[:, None, :]
                    + v1[:, None, :] * u1[:, :, None])
                v2 = np.einsum("tjw,tw->tj", Mx / f[:, None, None] + My, Vl)
                u2 = np.einsum("tjw,tw->tj",
                               Mx / f[:, None, None] + f[:, None, None] * My,
                               Vl)
                Mn2 = (-100.0 * c ** 3 * dv / vol)[:, None, None] * (
                    v2[:, :, None] * u2[:, None, :]
                    + v2[:, None, :] * u2[:, :, None])
                Mn = np.where((lt == 0)[:, None, None], Mn0,
                              np.where((lt == 1)[:, None, None], Mn1, Mn2))
                Mn = np.where(nl[:, None, None], Mn, 0.0)
                be = be + np.einsum("tjk,tk->tj", Mn, Vl)

        with phase("element matrices"):
            Me = (Mx / mu2[:, None, None] + My / mu1[:, None, None] + Mn)
            blocks = _element_blocks(pk, Me)
            b = _rhs(pk, geom, be)

        # inexact-Newton forcing, as the JAX package's axisymmetric
        # model: the accepting solve is always at full contract Precision
        if not nonlinear:
            tol_it = problem.Precision
        elif it == 0:
            tol_it = max(problem.Precision, 1e-4)
        elif res < 3e4 * problem.Precision:
            tol_it = problem.Precision
        else:
            tol_it = max(problem.Precision, min(1e-4, 0.03 * res))

        V_old = V
        if dsess is not None:
            with phase("distributed solve"):
                V, rel_resid, cg_iters = dsess.solve(
                    blocks, b, pk.fixed_mask, pk.fixed_vals, tol_it,
                    x0=V if it > 0 else None, coords=dof_coords)
        else:
            V, rel_resid, cg_iters = solver.solve(
                blocks, b, pk.fixed_mask, pk.fixed_vals, tol_it,
                x0=V if it > 0 else None, coords=dof_coords, session=sess,
                changed=[nl] if nonlinear else None, device=dev,
                hbm=hbm_bytes)
        V = np.asarray(V)
        iters_total += int(cg_iters)

        if not nonlinear:
            break
        num = float(np.sum((V - V_old) ** 2))
        den = float(np.sum(V ** 2))
        if den == 0:
            break
        lastres = res
        res = math.sqrt(num / den)
        if it + it_shift > 5:
            if res > lastres and relax > 0.125 and not dev_handoff_prev:
                relax /= 2.0
            else:
                relax += 0.1 * (1.0 - relax)
            V = relax * V + (1.0 - relax) * V_old
        # accept only after a full-Precision solve (the inexact early
        # iterations run at a looser linear tolerance)
        if (res < 100.0 * problem.Precision and it > 0
                and tol_it <= problem.Precision):
            break

        # after the it-0 solve has built the band hierarchy and value
        # maps, intermediate Newton iterations can run on the device
        if it == 0 and use_device and dev_state is None:
            from ..ops import newton as newton_dev
            with phase("newton loop setup", device=True):
                b_static = _rhs(pk, geom, be_static)
                dev_state = newton_dev.setup(pk, geom, Mx, My, sess,
                                             b_static, c, axi=True,
                                             device=dev, hbm=hbm_bytes)

    # flux output: A_i = V_i * c * 2*pi*r_m (staticaxi.cpp:779-784)
    Vfull = V[pk.ridx] * pk.rsign
    A = Vfull * c * (pk.xy[:, 0] * 0.01 * 2.0 * PI)

    label_case = _label_case(pk, T, len(labels))
    return MagSolution(problem=problem, mesh=mesh, A=A,
                       circuits=pk.circuits, label_case=label_case,
                       iterations=iters_total, residual=float(rel_resid),
                       newton_iterations=it + 1 + it_shift)


def _label_case(pk: PackedMagnetostatic, T: int, nlabels: int):
    """Per-label (case, value): each label takes the circuit of its LAST
    element, as the reference's per-element sweep leaves it."""
    label_case = np.zeros((nlabels, 2))
    seen = dict(zip(pk.lbl.tolist(), pk.circuit.tolist()))
    for k in range(nlabels):
        ci = seen.get(k, -1)
        if ci < 0:
            label_case[k] = (1, 0.0)
        else:
            circ = pk.circuits[ci]
            val = circ.dV if circ.Case == 0 else circ.J
            val = val.real if isinstance(val, complex) else val
            label_case[k] = (circ.Case, val)
    return label_case
