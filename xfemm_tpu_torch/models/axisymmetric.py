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
chain. Each host pass after iteration 0 writes the nonlinear elements'
matrices into the kept volume block and their Newton sources onto the
it-0 right-hand side; the linear elements' are never rebuilt.

The set-up (pack, geometry, the J-free static terms, the solver
Session, the it-0 element blocks and the device loop's data) is kept
per mesh in ``_SETUP_CACHE``: a problem that differs from the kept one
only in its blocks' J refreshes what J feeds (the element J, the
circuits, the static and it-0 right-hand sides and the loop's
``rhs_base``) and runs the same Newton schedule as a fresh solve, host
iteration 0 included. The JAX package starts a fresh Session on every
solve.
"""

from __future__ import annotations

import collections
import math
import os
from dataclasses import replace

import numpy as np

from ..constants import C_APOT, MU0, PI, ProblemType
from ..geometry.problem import Problem, source_free_fingerprint
from ..mesh.meshdata import MeshData
from ..ops import assembly, solver
from ..parallel import driver as dd_driver
from ..utils.profiling import phase
from .magnetostatics import (MagSolution, PackedMagnetostatic, _block_J,
                             _device_chain, _element_blocks,
                             _prepare_materials, _rhs, _with_sources, pack)


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


def _static_terms(pk: PackedMagnetostatic, geom, problem: Problem):
    """The static terms that do not depend on J: the magnetization term
    of each element edge (staticaxi.cpp:427-440), the initial
    permeabilities (staticaxi.cpp:429-451) with the external region's
    Kelvin warp (staticaxi.cpp:608-615) and each reduced DOF's
    representative coordinates (the band ordering's)."""
    R = np.asarray(geom.R)
    rn = np.asarray(geom.rn)
    # magnetization: edge j with midside radius (staticaxi.cpp:427-440)
    nxt = np.roll(np.arange(3), -1)
    v = pk.xy[pk.tris]
    dxe = v[:, nxt, 0] - v[:, :, 0]
    dye = v[:, nxt, 1] - v[:, :, 1]
    redge = (rn + rn[:, nxt]) / 2.0
    th = pk.magdir * PI / 180.0
    Kmag = -0.0001 * redge * pk.Hc[:, None] * (
        np.cos(th)[:, None] * dxe + np.sin(th)[:, None] * dye)

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

    # external-region (Kelvin transform) permeability warp; ext* are in
    # problem units -> cm
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

    dof_coords = np.zeros((pk.nreduced, 2))
    dof_coords[pk.ridx] = pk.xy
    return Kmag, mu1, mu2, dof_coords


def _be_static(pk: PackedMagnetostatic, geom, Kmag):
    """(T,3) static right-hand side per element: the sources, block J
    and circuit current, K = -2R(J+t)a/3 per corner
    (staticaxi.cpp:340-352), and the magnetization term ``Kmag`` (edge j
    contributes K_j to corners j and j+1, so corner j collects
    K_j + K_{j-1})."""
    R = np.asarray(geom.R)
    t_src = _circuit_source(pk, R)
    src = -2.0 * R * (pk.Jre + t_src) * np.asarray(geom.area) / 3.0
    prv_of = np.array([2, 0, 1])
    return src[:, None] + Kmag + Kmag[:, prv_of]


#: The set-up kept per mesh, device, device memory size, Kelvin radii
#: and every property but the blocks' J: the pack (``"pk"``, without its
#: problem), the axisymmetric geometry and curl matrices, the J-free
#: static terms (``"terms"``), the solver Session, the initial-mu
#: element blocks and right-hand side (``"it0"``), the device Newton
#: loop's data (``"dn"``, with the band layout it maps, ``"dn_band"``)
#: and the J they were refreshed for. The Kelvin
#: radii are not in the problem's fingerprint but feed the kept
#: permeabilities. The entry holds its mesh (``pk.mesh``), so the
#: mesh's id cannot pass to another while it is kept, and never a
#: problem. A dict of its own: the planar model's ``_PACK_CACHE`` holds
#: other values, and one bound over both would let one model evict the
#: other's set-up
_SETUP_CACHE: "collections.OrderedDict[tuple, dict]" = \
    collections.OrderedDict()
_SETUP_CACHE_MAX = 4


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
    c = C_APOT
    # the set-up kept per mesh: "built" (a miss), "sources" (only the
    # blocks' J differ: what J feeds is refreshed) or "reused"
    with phase("pack"):
        # pack's B-H set-up on the problem's own properties before the
        # fingerprint: a fresh problem and one solved before hash alike
        _prepare_materials(problem, problem.blockproplist)
        fp = source_free_fingerprint(problem, "J")
        ckey = (id(mesh), str(dev), hbm_bytes,
                (problem.extRo, problem.extRi, problem.extZo), fp)
        kept = (solver.lru_get(_SETUP_CACHE, ckey) if fp is not None
                else None)
        if kept is not None and kept["pk"].mesh is not mesh:
            kept = None
        J = _block_J(problem)
        kind = ("built" if kept is None
                else "reused" if np.array_equal(J, kept["J"])
                else "sources")
        if kept is None:
            pk = pack(problem, mesh)
            kept = {}
        else:
            pk = _with_sources(kept["pk"], problem)
    with phase("geometry"):
        if kind == "built":
            kept["geom"] = assembly.axi_geometry(pk.xy, pk.tris)
            kept["M"] = assembly.axi_curl_matrices(kept["geom"])[:2]
        geom = kept["geom"]
        Mx, My = kept["M"]
        _circuit_preprocess_axi(pk, geom)
    with phase("axi static setup"):
        with phase(f"axi setup ({kind})"):
            if kind == "built":
                kept["terms"] = _static_terms(pk, geom, problem)
            Kmag, mu1, mu2, dof_coords = kept["terms"]
            be_static = _be_static(pk, geom, Kmag)
    if kind != "built" and kept.get("sess") is not None:
        # the iteration baseline of the factor's staleness test starts
        # anew, as a fresh Session adopting the band does
        kept["sess"].first_iters = None
    if kind == "sources" and "it0" in kept:
        # the kept blocks and the loop's data take the new right-hand
        # side
        with phase("element matrices"):
            b_base = _rhs(pk, geom, be_static)
        kept["it0"] = kept["it0"][:2] + (b_base,)
        if kept.get("dn") is not None:
            from ..ops import newton as newton_dev
            dn, has_lam = kept["dn"]
            with phase("newton loop setup", device=True):
                rhs = newton_dev.newton_rhs(pk.fixed_mask, pk.fixed_vals,
                                            b_base, dn.rhs_base.device)
            kept["dn"] = (dn._replace(rhs_base=rhs), has_lam)
    kept["J"] = J
    kept["pk"] = replace(pk, problem=None)
    if fp is not None:
        solver.lru_put(_SETUP_CACHE, ckey, kept, _SETUP_CACHE_MAX)

    T = pk.tris.shape[0]
    vol = np.asarray(geom.vol)
    # this solve's permeabilities: the Newton passes write the nonlinear
    # elements' in place
    mu1, mu2 = mu1.copy(), mu2.copy()
    lt = pk.lam_type
    f = pk.lam_fill
    nonlinear = bool(pk.nonlinear.any())
    nl = pk.nonlinear
    ns = np.nonzero(nl)[0]

    sess = kept.get("sess")
    if sess is None:
        sess = kept["sess"] = solver.Session()
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
        if it > 0:
            with phase("newton host"):
                # element |B| and Newton matrices for the nonlinear
                # subset alone; linear elements keep mu and take no
                # Newton term
                tri_s = pk.tris[ns]
                Vl = pk.rsign[tri_s] * V[pk.ridx[tri_s]]
                lts = lt[ns]
                fs = f[ns]
                vols = vol[ns]
                Mxs = Mx[ns]
                Mys = My[ns]
                # B^2 from the energy quadratic form (staticaxi.cpp:510-521)
                Mb = Mxs + Mys
                if (lts != 0).any():
                    MxMy1 = Mxs + Mys / (fs * fs)[:, None, None]
                    MxMy2 = Mxs / (fs * fs)[:, None, None] + Mys
                    Mb = np.where((lts == 0)[:, None, None], Mb,
                                  np.where((lts == 1)[:, None, None], MxMy1,
                                           MxMy2))
                vv_vec = np.einsum("tjw,tw->tj", Mb, Vl)
                dv_en = np.einsum("tj,tj->t", Vl, vv_vec) * (1e4 * c * c
                                                             / vols)
                Bmag = np.sqrt(np.abs(dv_en))
                vv, dv = assembly.hermite_vdv(Bmag, pk.bh_B[ns],
                                              pk.bh_H[ns], pk.bh_S[ns])
                mu_el = 1.0 / (MU0 * vv)
                mu1[ns] = np.where(lts == 0, mu_el,
                                   np.where(lts == 1, mu_el * fs,
                                            mu_el / (fs + mu_el * (1 - fs))))
                mu2[ns] = np.where(lts == 0, mu_el,
                                   np.where(lts == 1,
                                            mu_el / (fs + mu_el * (1 - fs)),
                                            mu_el * fs))
                # Newton matrices (staticaxi.cpp:523-600)
                v0 = np.einsum("tjw,tw->tj", Mxs + Mys, Vl)
                Mns = (-200.0 * c ** 3 * dv / vols)[:, None, None] * \
                    v0[:, :, None] * v0[:, None, :]
                if (lts != 0).any():
                    v1 = np.einsum("tjw,tw->tj",
                                   Mys / fs[:, None, None] + Mxs, Vl)
                    u1 = np.einsum("tjw,tw->tj", Mys / fs[:, None, None]
                                   + fs[:, None, None] * Mxs, Vl)
                    Mn1 = (-100.0 * c ** 3 * dv / vols)[:, None, None] * (
                        v1[:, :, None] * u1[:, None, :]
                        + v1[:, None, :] * u1[:, :, None])
                    v2 = np.einsum("tjw,tw->tj",
                                   Mxs / fs[:, None, None] + Mys, Vl)
                    u2 = np.einsum("tjw,tw->tj", Mxs / fs[:, None, None]
                                   + fs[:, None, None] * Mys, Vl)
                    Mn2 = (-100.0 * c ** 3 * dv / vols)[:, None, None] * (
                        v2[:, :, None] * u2[:, None, :]
                        + v2[:, None, :] * u2[:, :, None])
                    Mns = np.where((lts == 0)[:, None, None], Mns,
                                   np.where((lts == 1)[:, None, None], Mn1,
                                            Mn2))
                # the Newton source term, be - be_static
                dbe = np.einsum("tjk,tk->tj", Mns, Vl)

        with phase("element matrices"):
            if it == 0:
                if "it0" in kept:
                    Me, blocks, b_base = kept["it0"]
                    # each host pass writes the nonlinear slots in
                    # place: back to the initial permeabilities
                    blocks[0].mat[nl] = -Me[nl]
                else:
                    Me = Mx / mu2[:, None, None] + My / mu1[:, None, None]
                    blocks = _element_blocks(pk, Me)
                    b_base = _rhs(pk, geom, be_static)
                    kept["it0"] = (Me, blocks, b_base)
                b = b_base
            else:
                # only the nonlinear subset's matrices and sources
                # change: write them straight into the volume block's
                # mat (-Me), and their sources onto the it-0 right-hand
                # side
                blocks[0].mat[ns] = -(Mxs / mu2[ns, None, None]
                                      + Mys / mu1[ns, None, None] + Mns)
                b = b_base.copy()
                np.add.at(b, pk.ridx[tri_s].reshape(-1),
                          -pk.rsign[tri_s].reshape(-1) * dbe.reshape(-1))

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
                # the loop's maps address the Session's band layout: a
                # band rebuilt since they were made needs them anew
                if (kept.get("dn") is None
                        or kept["dn_band"] is not sess.band_layout):
                    kept["dn"] = newton_dev.setup(
                        pk, geom, Mx, My, sess, b_base, c, axi=True,
                        device=dev, hbm=hbm_bytes)
                    kept["dn_band"] = sess.band_layout
                dev_state = kept["dn"]

    # flux output: A_i = V_i * c * 2*pi*r_m (staticaxi.cpp:779-784)
    Vfull = V[pk.ridx] * pk.rsign
    A = Vfull * c * (pk.xy[:, 0] * 0.01 * 2.0 * PI)

    labels = [l for l in problem.labellist if not l.is_hole()]
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
