"""Device-resident Newton loop for planar nonlinear magnetostatics.

The reference's Newton loop (static2d.cpp:177-1016) re-assembles and
re-solves once per iteration; the host chain of models/magnetostatics.py
pays the numpy element matrices and the f64 CSR refresh on the host
before the card sees each system. This module moves the MIDDLE of the
Newton chain onto the device, every step on tensors of the session's
device:

    element B from V  ->  B-H Hermite lookup  ->  Newton matrices
    ->  CSR value refresh (index_add)  ->  operator refresh
    ->  preconditioned CG to the step's inexact-Newton tolerance
    ->  adaptive relaxation  ->  convergence / stall test

``run`` loops over Newton steps with the fine band FROZEN: the changed
in-band entries ride a COO sidecar ``A x = A0 x + delta x``.
``run_scatter`` does one step per call and writes the changed entries
IN PLACE into the session's fine band (``index_put_``) -- the mode of
the multi-GB bands, where the sidecar's per-iteration cost would exceed
one band refresh per step. The accepting pass at the full contract
Precision runs on the host afterwards (models/magnetostatics.py), so the
reference's convergence contract is checked in f64 exactly as before.

This is the port of the JAX package's ``ops/newton.py`` planar loop.
Its ``lax.while_loop`` becomes a host loop over device tensors that
reads its continue flag with one blocking copy per step (the inner CG
syncs at each of its checks anyway, so no CUDA graph). The JAX package
donates the fine band to its jitted dispatch and so needs
``strip_fine_band`` / ``rebuild_band_amg`` around it; torch has no
donation and nothing here copies the band, so ``strip_fine_band`` is
not ported and ``rebuild_band_amg`` keeps only its effect on the
session: the refreshed ``dvec`` and sidecar values installed and the
fine level's bf16 copy ``Abf`` dropped. ``DeviceNewton`` carries only
the fields the loop reads (the JAX tuple's whole-CSR maps, which its
loops never read, are left out). The heat loop (``setup_heat``,
``run_heat``) comes with the heat-flow slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..constants import MU0
from . import assembly
from . import band as band_mod
from . import blocktri as bt_mod
from .band import BandAMG, Sidecar


class DeviceNewton(NamedTuple):
    """Static (per-solve) device data of the device Newton loop.
    Integer maps are int64, values f32."""
    # changed-element data (S = number of nonlinear elements)
    idxT: torch.Tensor        # (S, 3) reduced DOF ids
    sgnT: torch.Tensor        # (S, 3) +-1 fold signs
    q: torch.Tensor           # (S, 3)
    p: torch.Tensor           # (S, 3)
    area: torch.Tensor        # (S,) area (axi: element volume)
    lt: torch.Tensor          # (S,) lamination type
    fs: torch.Tensor          # (S,) fill factor
    bhB: torch.Tensor         # (S, K)
    bhH: torch.Tensor
    bhS: torch.Tensor
    Mx: torch.Tensor          # (S, 3, 3)
    My: torch.Tensor
    # RHS
    rhs_base: torch.Tensor    # (n,) with Dirichlet values in place
    scat_idx: torch.Tensor    # (S*3,) rows of the dbe scatter
    scat_w: torch.Tensor      # (S*3,) -sign * keep
    c: torch.Tensor           # () f32
    perm: torch.Tensor        # band ordering
    iperm: torch.Tensor
    # CSR value refresh of the changed slots
    souter: torch.Tensor      # (S, 3, 3) sign outer products
    sub_rank: torch.Tensor    # (S*9,) rank of each entry's CSR slot
    sub_zero: torch.Tensor    # (nsub,) zeros template
    # in-place band refresh (run_scatter)
    band_sub_rows: torch.Tensor   # (J,) flat band row (tile * R + rloc)
    band_sub_cols: torch.Tensor   # (J,) band column window position
    band_sub_rank: torch.Tensor   # (J,) rank into contrib
    band_sub_static: torch.Tensor  # (J,) frozen (linear) part
    # delta-COO operator refresh (run): global permuted (row, col) of
    # each changed in-band slot, its band slot, rank and frozen part;
    # triu storage appends mirrored off-diagonal duplicates
    delta_rows: torch.Tensor
    delta_cols: torch.Tensor
    delta_brows: torch.Tensor
    delta_bcols: torch.Tensor
    delta_rank: torch.Tensor
    delta_static: torch.Tensor
    kmask: "torch.Tensor | None" = None   # (S*9,) Dirichlet keep mask
    # changed diagonal entries of a triu level
    dvec_rows: "torch.Tensor | None" = None
    dvec_rank: "torch.Tensor | None" = None
    dvec_static: "torch.Tensor | None" = None
    # sidecar slots (partitioned orderings) the changed elements move
    oob_upd_pos: "torch.Tensor | None" = None
    oob_upd_rank: "torch.Tensor | None" = None
    oob_static: "torch.Tensor | None" = None


def setup(pk, geom, Mx, My, session, b_base, c: float, axi: bool = False,
          *, device, hbm: float | None = None):
    """Build the device data on ``device`` (the session band's device):
    returns (DeviceNewton, has_lam), or None when the
    session is ineligible (``_band_eligible``), has no changed elements,
    or has nonzero Dirichlet values (their A.g RHS correction would
    change per step). ``hbm`` is the device memory size, as for the
    band planner (``solver.device_hbm_bytes``). ``axi=True`` packs the
    element VOLUME into the area field and zero q/p (the axisymmetric
    |B| comes from the energy quadratic form, see _newton_elements)."""
    if not _band_eligible(session, device, hbm):
        return None
    maps = _band_refresh_maps(session, pk.fixed_mask, device)
    if maps is None:
        return None
    ns = maps["ns"]
    fixed = pk.fixed_mask
    if fixed.any() and np.any(pk.fixed_vals[fixed] != 0.0):
        return None

    f32 = np.float32
    idxT = pk.ridx[pk.tris[ns]]
    sgnT = pk.rsign[pk.tris[ns]]
    keep = (~fixed).astype(f32)
    rhs_base = np.where(fixed, pk.fixed_vals, b_base).astype(f32)
    scat_idx = idxT.reshape(-1)
    scat_w = (-sgnT.reshape(-1) * keep[scat_idx]).astype(f32)
    lts = pk.lam_type[ns]
    if axi:
        qp = np.zeros((ns.size, 3), f32)
        q = p = qp
        denom = np.asarray(geom.vol)[ns]
    else:
        q, p = geom.q[ns], geom.p[ns]
        denom = geom.area[ns]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    i64 = torch.int64
    dn = DeviceNewton(
        idxT=t(idxT, i64), sgnT=t(sgnT), q=t(q), p=t(p), area=t(denom),
        lt=t(lts, i64), fs=t(pk.lam_fill[ns]), bhB=t(pk.bh_B[ns]),
        bhH=t(pk.bh_H[ns]), bhS=t(pk.bh_S[ns]), Mx=t(Mx[ns]), My=t(My[ns]),
        rhs_base=t(rhs_base), scat_idx=t(scat_idx, i64), scat_w=t(scat_w),
        c=torch.tensor(float(c), dtype=torch.float32, device=device),
        **maps["fields"])
    return dn, bool((lts != 0).any())


def _band_bytes(lv0) -> int:
    """Bytes of the fine band and its bf16 copy."""
    d = lv0.A.dense
    out = d.numel() * d.element_size()
    if lv0.Abf is not None:
        out += lv0.Abf.dense.numel() * 2
    return out


def _band_eligible(session, device, hbm: float | None = None) -> bool:
    """Band-engine and memory eligibility of the device loop.

    The loop refreshes the SESSION's fine band (in place, or through a
    delta sidecar), so device memory must hold the fine band, the coarse
    hierarchy and the refresh temporaries: the band (and its bf16 copy)
    may take at most 0.45 of it, the JAX package's share. With a
    block-tridiagonal factor the fine level's bf16 copy (the V-cycle
    smoother's only consumer) is dropped here."""
    if session.band_amg is None or session.pattern is None \
            or session.sub_cache is None or session.perm is None:
        return False
    from .solver import device_hbm_bytes
    lv0 = session.band_amg.levels[0]
    if _band_bytes(lv0) > 0.45 * device_hbm_bytes(device, hbm):
        return False
    if session.bt is not None and lv0.Abf is not None:
        amg = session.band_amg
        session.band_amg = dataclasses.replace(
            amg, levels=(dataclasses.replace(lv0, Abf=None),)
            + amg.levels[1:])
    return True


def _band_refresh_maps(session, fixed, device):
    """Subset band-refresh maps: which band positions the changed
    elements can touch, their frozen static values, and the CSR->band
    scatter ranks (host numpy, then tensors on ``device``). Returns
    ``None`` when the session lacks the band machinery, else a dict
    with ``ns`` (changed-element ids) and ``fields`` (the DeviceNewton
    constructor kwargs for the map portion)."""
    slot_s, souter_s, kmask_s, ch_masks = session.sub_cache
    if souter_s[0] is None:
        return None
    ns = np.nonzero(ch_masks[0])[0]
    if ns.size == 0:
        return None
    lay = session.band_layout
    upper_sel, diag_pos = lay.upper_sel, lay.diag_pos
    tile, rloc, wloc, R = lay.tile, lay.rloc, lay.wloc, lay.R
    f32 = np.float32
    _slot, _indptr, _indices, _nnz, diag_slots = session.pattern

    # subset-only refresh maps: which band positions can ever change.
    # ``src_t`` maps post-triu data order -> At CSR slot; ``final_src``
    # further restricts to the in-band (kept) entries the band holds.
    sub_pos = np.unique(slot_s)
    sub_rank = np.searchsorted(sub_pos, slot_s)
    src_t = session.band_data_map if upper_sel is None \
        else session.band_data_map[upper_sel]
    final_src = src_t if lay.keep_sel is None else src_t[lay.keep_sel]
    fixed_diag = diag_slots[fixed]
    in_sub = np.isin(final_src, sub_pos)
    if fixed_diag.size:
        # unit rows are constant 1.0 from the initial build (kmask
        # zeroes their contributions): never rewrite them
        in_sub &= ~np.isin(final_src, fixed_diag)
    j_sub = np.nonzero(in_sub)[0].astype(np.int64)
    j_src = final_src[j_sub]
    band_rows_h = (tile * R + rloc).astype(np.int64)
    band_sub_static = session.vals_static[j_src].astype(f32)
    band_sub_rank = np.searchsorted(sub_pos, j_src)

    # delta-COO maps: global (row, col) of each changed in-band slot in
    # the PERMUTED numbering, so ``run`` can apply the changed entries
    # as a sidecar extension against a frozen band. Symmetric (triu)
    # storage appends mirrors for off-diagonal slots (the fused
    # symmetric product counts the frozen diagonal exactly once, so a
    # single (r, r) delta entry is the correct diagonal correction).
    cchunk = session.band_amg.levels[0].A.cchunk
    d_rows = band_rows_h[j_sub]
    d_cols = (wloc[j_sub] + (tile[j_sub] + lay.shift0) * cchunk)
    d_brows = band_rows_h[j_sub]
    d_bcols = wloc[j_sub].astype(np.int64)
    d_rank = band_sub_rank
    d_static = band_sub_static
    if upper_sel is not None:
        off = np.nonzero(d_rows != d_cols)[0]
        d_rows = np.concatenate([d_rows, d_cols[off]])
        d_cols = np.concatenate([d_cols, band_rows_h[j_sub][off]])
        d_brows = np.concatenate([d_brows, d_brows[off]])
        d_bcols = np.concatenate([d_bcols, d_bcols[off]])
        d_rank = np.concatenate([d_rank, d_rank[off]])
        d_static = np.concatenate([d_static, d_static[off]])
    dvec_rows = dvec_rank = dvec_static = None
    if diag_pos is not None:
        diag_src = src_t[diag_pos]
        dsel = np.isin(diag_src, sub_pos)
        if fixed_diag.size:
            dsel &= ~np.isin(diag_src, fixed_diag)
        dvec_rows = np.nonzero(dsel)[0]
        dvec_static = session.vals_static[diag_src[dvec_rows]].astype(f32)
        dvec_rank = np.searchsorted(sub_pos, diag_src[dvec_rows])
    # sidecar slots whose values the changed elements can move
    oob_upd_pos = oob_upd_rank = oob_static = None
    if lay.oob_src is not None:
        oob_slot = src_t[lay.oob_src]
        osel = np.isin(oob_slot, sub_pos)
        oob_upd_pos = np.nonzero(osel)[0]
        oob_static = session.vals_static[
            oob_slot[oob_upd_pos]].astype(f32)
        oob_upd_rank = np.searchsorted(sub_pos, oob_slot[oob_upd_pos])
    perm, iperm = session.perm

    def idx(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, np.int64), device=device)

    def val(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, f32), device=device)

    fields = dict(
        souter=val(souter_s[0]), kmask=val(kmask_s),
        perm=idx(perm), iperm=idx(iperm), sub_rank=idx(sub_rank),
        sub_zero=torch.zeros(sub_pos.size, dtype=torch.float32,
                             device=device),
        band_sub_rows=idx(band_rows_h[j_sub]),
        band_sub_cols=idx(wloc[j_sub]),
        band_sub_rank=idx(band_sub_rank),
        band_sub_static=val(band_sub_static),
        dvec_rows=idx(dvec_rows), dvec_rank=idx(dvec_rank),
        dvec_static=val(dvec_static),
        oob_upd_pos=idx(oob_upd_pos), oob_upd_rank=idx(oob_upd_rank),
        oob_static=val(oob_static),
        delta_rows=idx(d_rows), delta_cols=idx(d_cols),
        delta_brows=idx(d_brows), delta_bcols=idx(d_bcols),
        delta_rank=idx(d_rank), delta_static=val(d_static))
    return {"ns": ns, "fields": fields}


def rebuild_band_amg(amg: BandAMG, dvec, oob_vals=None) -> BandAMG:
    """The session's hierarchy after a device run: the fine level with
    the refreshed triu diagonal ``dvec`` and sidecar values
    ``oob_vals`` (the band itself is frozen by ``run`` and refreshed in
    place by ``run_scatter``), and without its bf16 copy ``Abf``, which
    the loop does not refresh."""
    lv0 = amg.levels[0]
    oob = lv0.oob
    if oob is not None and oob_vals is not None:
        oob = Sidecar(rows=oob.rows, cols=oob.cols, vals=oob_vals)
    lv = dataclasses.replace(lv0, Abf=None, dvec=dvec, oob=oob)
    return dataclasses.replace(amg, levels=(lv,) + amg.levels[1:])


def _newton_elements(dn: DeviceNewton, V, has_lam: bool,
                     axi: bool = False):
    """Element update: B from V, spline mu, Newton matrices Mn and the
    changed-element matrices Me (static2d.cpp:600-796 semantics, f32).

    ``axi=True`` switches |B| to the axisymmetric energy quadratic form
    (staticaxi.cpp:510-521; ``dn.area`` then carries the element VOLUME
    and the lamination-variant curl operators are formed from Mx/My on
    the fly); the mu update, Newton matrices and Me are otherwise the
    same expressions with vol in place of area."""
    Vl = dn.sgnT * V[dn.idxT]
    lt0 = dn.lt == 0
    lt1 = dn.lt == 1
    lt2 = dn.lt == 2
    if axi:
        fsn = dn.fs[:, None, None]
        Mb = torch.where(lt0[:, None, None], dn.Mx + dn.My,
                         torch.where(lt1[:, None, None],
                                     dn.Mx + dn.My / (fsn * fsn),
                                     dn.Mx / (fsn * fsn) + dn.My))
        vv_vec = torch.einsum("tjw,tw->tj", Mb, Vl)
        dv_en = torch.einsum("tj,tj->t", Vl, vv_vec) * \
            (1e4 * dn.c * dn.c / dn.area)
        Bmag = torch.sqrt(torch.abs(dv_en))
    else:
        B1 = torch.sum(Vl * dn.q, dim=1)
        B2 = torch.sum(Vl * dn.p, dim=1)
        B1 = torch.where(lt2, B1 / dn.fs, B1)
        B2 = torch.where(lt1, B2 / dn.fs, B2)
        Bmag = dn.c * torch.sqrt(B1 * B1 + B2 * B2) / (0.02 * dn.area)
    vv, dv = assembly.hermite_vdv(Bmag, dn.bhB, dn.bhH, dn.bhS)
    mu_el = 1.0 / (MU0 * vv)
    mixed = mu_el / (dn.fs + mu_el * (1.0 - dn.fs))
    mu1 = torch.where(lt0, mu_el, torch.where(lt1, mu_el * dn.fs, mixed))
    mu2 = torch.where(lt0, mu_el, torch.where(lt1, mixed, mu_el * dn.fs))
    vvec0 = torch.einsum("tjw,tw->tj", dn.Mx + dn.My, Vl)
    Mn = (-200.0 * dn.c ** 3 * dv / dn.area)[:, None, None] * \
        vvec0[:, :, None] * vvec0[:, None, :]
    if has_lam:
        fsn = dn.fs[:, None, None]
        half = (-100.0 * dn.c ** 3 * dv / dn.area)[:, None, None]
        v1 = torch.einsum("tjw,tw->tj", dn.My / fsn + dn.Mx, Vl)
        u1 = torch.einsum("tjw,tw->tj", dn.My / fsn + fsn * dn.Mx, Vl)
        Mn1 = half * (v1[:, :, None] * u1[:, None, :]
                      + v1[:, None, :] * u1[:, :, None])
        v2 = torch.einsum("tjw,tw->tj", dn.Mx / fsn + dn.My, Vl)
        u2 = torch.einsum("tjw,tw->tj", dn.Mx / fsn + fsn * dn.My, Vl)
        Mn2 = half * (v2[:, :, None] * u2[:, None, :]
                      + v2[:, None, :] * u2[:, :, None])
        Mn = torch.where(lt0[:, None, None], Mn,
                         torch.where(lt1[:, None, None], Mn1, Mn2))
    Me = dn.Mx / mu2[:, None, None] + dn.My / mu1[:, None, None] + Mn
    return Vl, Me, Mn


def _contrib(dn: DeviceNewton, Me):
    """The changed CSR slots' values minus their frozen part: the
    segment sum of the changed elements' signed, Dirichlet-masked
    entries of -Me."""
    data_s = (dn.souter * (-Me)).reshape(-1)
    if dn.kmask is not None:
        data_s = data_s * dn.kmask
    return dn.sub_zero.index_add(0, dn.sub_rank, data_s)


def _refresh_operator(dn: DeviceNewton, amg: BandAMG, Me, entry_vals):
    """Current operator from the changed element matrices, WITHOUT
    touching the fine band: the changed in-band entries ride a sidecar
    extension ``A x = A0 x + delta x`` against the frozen band values
    (``entry_vals``, gathered once per ``run``), merged with the level's
    own sidecar (a partitioned ordering's), whose touched slots take
    their current values. Returns ``(amg_new, contrib, oob_vals_new)``;
    the caller derives the final dvec / session values from ``contrib``
    after the loop."""
    contrib = _contrib(dn, Me)
    lv0 = amg.levels[0]
    dval = (dn.delta_static + contrib[dn.delta_rank]) - entry_vals
    if lv0.oob is not None:
        vals0 = lv0.oob.vals
        if dn.oob_upd_pos is not None:
            vals0 = vals0.index_put(
                (dn.oob_upd_pos,), dn.oob_static + contrib[dn.oob_upd_rank])
        merged = Sidecar(rows=torch.cat([lv0.oob.rows, dn.delta_rows]),
                         cols=torch.cat([lv0.oob.cols, dn.delta_cols]),
                         vals=torch.cat([vals0, dval]))
        oob_vals_new = vals0
    else:
        merged = Sidecar(rows=dn.delta_rows, cols=dn.delta_cols, vals=dval)
        oob_vals_new = None
    lv = dataclasses.replace(lv0, oob=merged)
    return (dataclasses.replace(amg, levels=(lv,) + amg.levels[1:]),
            contrib, oob_vals_new)


#: GMRES(24) cycles one inner solve of the loop may restart on a bf16
#: fine operator
FGMRES_RESTARTS = 4


def _inner_solve(amg_new, r_scaled, tol_eff, inner_iter, bt, n):
    """Inner linear solve of the loop: on a bf16 fine operator up to
    FGMRES_RESTARTS cycles of GMRES(24) (CG diverges on the bf16-
    perturbed operator, ``band.band_fgmres``), each restarted from the
    f32 residual recomputed on the loop's operator, until the Jacobi-
    weighted residual meets ``tol_eff``; else block-tridiagonal-
    preconditioned CG with a standalone factor; the band-AMG V-cycle PCG
    with the factor as its fine smoother (a partitioned ordering's
    BTSmoother, with a short stall window: the composite plateaus on
    interface modes, and bailing early lets the Newton step proceed with
    the partial correction -- the next step re-solves anyway); the
    V-cycle PCG alone without a factor. Returns ``(d, iterations)``
    (for GMRES the Arnoldi steps, m per cycle)."""
    lvn = amg_new.levels[0]
    x0 = torch.zeros(n, dtype=torch.float32, device=r_scaled.device)
    if lvn.A.dense.dtype == torch.bfloat16:
        invd = lvn.invd
        res0_pass = torch.dot(invd * r_scaled, r_scaled)
        res0_pass = torch.where(res0_pass == 0.0,
                                torch.ones_like(res0_pass), res0_pass)
        d = x0
        its = 0
        for _ in range(FGMRES_RESTARTS):
            rc = r_scaled - band_mod.band_apply(lvn.A, lvn.dvec, d, lvn.oob)
            dd, _rr, fits = band_mod.band_fgmres(amg_new, rc, 24)
            d = d + dd
            its += fits
            rc2 = r_scaled - band_mod.band_apply(lvn.A, lvn.dvec, d, lvn.oob)
            rn = torch.sqrt(torch.dot(invd * rc2, rc2) / res0_pass)
            if not bool(rn > tol_eff):
                break
        return d, its
    if bt is None:
        d, _rel, its = band_mod.band_pcg(amg_new, r_scaled, tol_eff, x0,
                                         inner_iter)
    elif isinstance(bt, bt_mod.BTSmoother):
        d, _rel, its = band_mod.band_pcg(amg_new, r_scaled, tol_eff, x0,
                                         inner_iter, stall_window=48, bt=bt)
    else:
        d, _rel, its = bt_mod.bt_pcg(lvn.A, lvn.dvec, lvn.invd, bt,
                                     r_scaled, tol_eff, x0, inner_iter,
                                     oob=lvn.oob)
    return d, its


def _newton_step(dn: DeviceNewton, amg_new, Vl, Mn, V, relax, res, glob,
                 tol_floor: float, bt, inner_iter: int):
    """One Newton step on the refreshed operator ``amg_new``: the RHS
    with the changed elements' Newton sources, the correction solve at
    the inexact-Newton tolerance (the host schedule's 0.03 * res,
    converted to the current residual as the host driver does), and the
    adaptive relaxation of static2d.cpp:974-989 (compare against the
    PREVIOUS displacement, active past global iteration 5, mix after
    measuring). Every scalar is an f32 device tensor. Returns
    ``(V_out, relax_new, res_new, its)``."""
    n = V.shape[0]
    dbe = torch.einsum("tjk,tk->tj", Mn, Vl)
    b = dn.rhs_base.index_add(0, dn.scat_idx, dn.scat_w * dbe.reshape(-1))
    lvn = amg_new.levels[0]
    bp = b[dn.perm]
    r = bp - band_mod.band_apply(lvn.A, lvn.dvec, V[dn.perm], lvn.oob)
    tol_k = torch.clamp(0.03 * res, tol_floor, 1e-4)
    invd = lvn.invd
    res0_sys = torch.dot(invd * bp, bp)
    res_cur = torch.dot(invd * r, r)
    tol_eff = torch.clamp(
        tol_k * torch.sqrt(res0_sys / torch.clamp_min(res_cur, 1e-30)),
        1e-7, 0.5)
    scale = torch.clamp_min(r.abs().max(), 1e-30)
    d_p, its = _inner_solve(amg_new, r / scale, tol_eff, inner_iter, bt, n)
    V_new = V + (scale * d_p)[dn.iperm]
    num = torch.linalg.norm(V_new - V)
    den = torch.clamp_min(torch.linalg.norm(V_new), 1e-30)
    res_new = num / den
    active = glob > 5.0
    worse = (res_new > res) & (relax > 0.125)
    # near the root an improving Newton step is contraction-optimal
    # undamped: lift the relaxation entirely below 3e-5 (the `worse`
    # branch re-damps if the iteration turns oscillatory again)
    relax_new = torch.where(
        active,
        torch.where(worse, relax * 0.5,
                    torch.where(res_new < 3e-5, torch.ones_like(relax),
                                relax + 0.1 * (1.0 - relax))),
        relax)
    V_out = torch.where(active, relax_new * V_new + (1.0 - relax_new) * V,
                        V_new)
    return V_out, relax_new, res_new, its


def run(dn: DeviceNewton, amg: BandAMG, V, state,
        tol_floor: float = 3e-7, target_res: float = 9e-7, bt=None,
        inner_iter: int = 400, has_lam: bool = False,
        max_steps: int = 30, axi: bool = False, cg_budget: int = 0):
    """Run the Newton MIDDLE AND TAIL as one loop on the device: element
    update -> operator refresh (delta sidecar on the frozen band) ->
    preconditioned CG -> adaptive relaxation -> convergence/stall test,
    until the displacement ``res`` is at most ``target_res``, ``max_steps``
    steps ran, three steps in a row failed to improve the best
    displacement 5%, or (``cg_budget`` > 0) the accumulated inner CG
    iterations reached ``cg_budget`` (the caller then continues from the
    returned state).

    ``state`` is a (4,) f32 tensor (relax, res, lastres, base_it), with
    ``base_it`` the host's global iteration number (the relaxation rule
    activates past global iteration 5). The carry stays on the device in
    f32; the step count and the CG total are exact host integers. ``amg``
    is not modified. Returns ``(V, dvec, oob_vals, stats)``: the fine
    level's triu diagonal from the last step (the same tensor when no
    step ran or the level is not triu), its sidecar values (None without
    a sidecar), and ``stats`` = (relax, res, lastres, steps, cg_total)
    as a (5,) f32 tensor."""
    lv0 = amg.levels[0]
    f32 = torch.float32
    state = state.to(f32)
    relax, res, lastres, base_it = state[0], state[1], state[2], state[3]
    dense = lv0.A.dense
    # frozen band values at the changed slots: the loop applies the
    # operator as A0 + delta (see _refresh_operator)
    entry_vals = dense.view(-1, dense.shape[2])[
        dn.delta_brows, dn.delta_bcols].to(f32)
    oob_vals = lv0.oob.vals if lv0.oob is not None else None
    contrib = dn.sub_zero
    V = V.to(f32)
    best = res
    since = torch.zeros((), dtype=torch.int32, device=V.device)
    k = 0
    cg_tot = 0
    while k < max_steps and (cg_budget <= 0 or cg_tot < cg_budget):
        # the one blocking read of the step
        if not bool((res > target_res) & (since < 3)):
            break
        lv_cur = dataclasses.replace(
            lv0, Abf=None, oob=None if oob_vals is None
            else Sidecar(lv0.oob.rows, lv0.oob.cols, oob_vals))
        amg_cur = dataclasses.replace(amg, levels=(lv_cur,)
                                      + amg.levels[1:])
        Vl, Me, Mn = _newton_elements(dn, V, has_lam, axi)
        amg_new, contrib, oob_new = _refresh_operator(dn, amg_cur, Me,
                                                      entry_vals)
        V, relax_new, res_new, its = _newton_step(
            dn, amg_new, Vl, Mn, V, relax, res, base_it + float(k),
            tol_floor, bt, inner_iter)
        improved = res_new < 0.95 * best
        best = torch.minimum(best, res_new)
        since = torch.where(improved, torch.zeros_like(since), since + 1)
        if oob_vals is not None:
            oob_vals = oob_new
        relax, lastres, res = relax_new, res, res_new
        k += 1
        cg_tot += int(its)
    # final dvec from the last contrib (identity when the loop never
    # ran); the session's BAND values are refreshed from the fresh CSR
    # by the next host solver.solve call, so the band stays frozen
    dvec = lv0.dvec
    if dvec is not None and dn.dvec_rows is not None and k > 0:
        dvec = dvec.index_put((dn.dvec_rows,),
                              dn.dvec_static + contrib[dn.dvec_rank])
    stats = torch.stack([relax, res, lastres,
                         torch.tensor(float(k), device=V.device),
                         torch.tensor(float(cg_tot), device=V.device)])
    return V, dvec, oob_vals, stats


def run_scatter(dn: DeviceNewton, amg: BandAMG, V, state,
                tol_floor: float = 3e-7, bt=None, inner_iter: int = 400,
                has_lam: bool = False, axi: bool = False):
    """ONE Newton step, with the changed operator entries written IN
    PLACE into the fine band of ``amg`` (``index_put_`` into the band's
    own storage, its triu diagonal and its sidecar values: no copy of
    the band is made), then the inner CG on the clean banded operator.
    ``run``'s delta sidecar costs a gather and an ``index_add`` per
    operator apply; at multi-GB bands one refresh per step is cheaper.
    The caller chains these calls like ``run``'s budget chain
    (magnetostatics picks this mode via XFEMM_TPU_DN_SCATTER_BYTES,
    default: fine band > 3 GB).

    Returns ``(V, dvec, oob_vals, stats)`` with the same stats layout
    as ``run`` (relax, res, lastres, steps=1, cg_its); ``dvec`` and
    ``oob_vals`` are the level's own (refreshed) tensors."""
    lv0 = amg.levels[0]
    f32 = torch.float32
    state = state.to(f32)
    relax, res, base_it = state[0], state[1], state[3]
    V = V.to(f32)

    Vl, Me, Mn = _newton_elements(dn, V, has_lam, axi)
    _scatter_refresh(dn, lv0, Me)
    amg_new = dataclasses.replace(
        amg, levels=(dataclasses.replace(lv0, Abf=None),) + amg.levels[1:])
    V_out, relax_new, res_new, its = _newton_step(
        dn, amg_new, Vl, Mn, V, relax, res, base_it, tol_floor, bt,
        inner_iter)
    stats = torch.stack([relax_new, res_new, res,
                         torch.tensor(1.0, device=V.device),
                         torch.tensor(float(its), device=V.device)])
    return V_out, lv0.dvec, None if lv0.oob is None else lv0.oob.vals, stats


def _scatter_refresh(dn: DeviceNewton, lv0, Me) -> None:
    """Write the changed entries of the operator at element matrices
    ``Me`` in place into the fine level ``lv0``: its band (through a
    2-D view of its own storage), its triu diagonal and its sidecar
    values."""
    contrib = _contrib(dn, Me)
    dense = lv0.A.dense
    vals_new = dn.band_sub_static + contrib[dn.band_sub_rank]
    dense.view(-1, dense.shape[2]).index_put_(
        (dn.band_sub_rows, dn.band_sub_cols), vals_new.to(dense.dtype))
    if lv0.dvec is not None and dn.dvec_rows is not None:
        lv0.dvec.index_put_((dn.dvec_rows,),
                            dn.dvec_static + contrib[dn.dvec_rank])
    if lv0.oob is not None and dn.oob_upd_pos is not None:
        lv0.oob.vals.index_put_((dn.oob_upd_pos,),
                                dn.oob_static + contrib[dn.oob_upd_rank])
