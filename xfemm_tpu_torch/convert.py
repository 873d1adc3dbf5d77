"""Carry the JAX package's band-engine and domain-decomposition state
into the port.

Each function takes the JAX package's object (or any object with the
same fields) whose arrays convert with ``np.asarray``, and returns the
port's counterpart with its tensors on ``device``. Nothing here imports
the JAX package: its objects are read by field name. The tests use
these to feed the SAME band and factor to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.band import BandAMG, BandLevel, BandMatrix, FineLayout, Sidecar
from .ops.blocktri import BTCoarse, BTDeviceMaps, BTFactor
from .ops.newton import DeviceHeat
from .parallel.band_dd import BandDDState
from .parallel.comm import STACKED
from .parallel.partition import PartitionedSystem


def tensor(a, device="cpu") -> torch.Tensor:
    """A numpy-convertible array as a tensor on ``device``; bfloat16
    arrays (which numpy holds as the ml_dtypes type) keep their bits."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(arr), device=device)


def band_matrix(bm, device="cpu") -> BandMatrix:
    """BandMatrix (dense band + shift0/cchunk/ncols)."""
    return BandMatrix(dense=tensor(bm.dense, device), shift0=int(bm.shift0),
                      cchunk=int(bm.cchunk), ncols=int(bm.ncols))


def fine_layout(lay) -> FineLayout:
    """FineLayout (host slot maps; plain numpy on both sides)."""
    return FineLayout(*[np.asarray(f) if isinstance(f, np.ndarray) else f
                        for f in lay])


def _opt(f, obj, device):
    return None if obj is None else f(obj, device)


def band_level(lv, device="cpu") -> BandLevel:
    """A BandLevel's band and inverse diagonal, and its coarse
    block-tridiagonal smoother ``bts`` where it has one."""
    return BandLevel(A=band_matrix(lv.A, device),
                     invd=tensor(lv.invd, device).float(),
                     bts=_opt(bt_factor, getattr(lv, "bts", None), device))


def bt_factor(f, device="cpu") -> BTFactor:
    """BTFactor (Sinv, G, s)."""
    return BTFactor(Sinv=tensor(f.Sinv, device), G=tensor(f.G, device),
                    s=tensor(f.s, device).float())


def sidecar(sc, device="cpu") -> Sidecar:
    """Sidecar (COO rows, cols as int64; values f32)."""
    return Sidecar(rows=tensor(sc.rows, device).long(),
                   cols=tensor(sc.cols, device).long(),
                   vals=tensor(sc.vals, device).float())


def band_amg(amg, device="cpu") -> BandAMG:
    """A whole band hierarchy: every level's band, smoothing copy,
    prolongator, triu diagonal, sidecars and inter-level permutation,
    and the bottom solve (dense inverse or block-tridiagonal BTCoarse)."""
    levels = []
    for lv in amg.levels:
        out = band_level(lv, device)
        out.omega = tensor(lv.omega, device).float()
        out.P = _opt(band_matrix, lv.P, device)
        out.Abf = _opt(band_matrix, lv.Abf, device)
        out.dvec = _opt(tensor, lv.dvec, device)
        out.oob = _opt(sidecar, lv.oob, device)
        out.P_oob = _opt(sidecar, lv.P_oob, device)
        if lv.cperm is not None:
            out.cperm = tensor(lv.cperm, device).long()
            out.ciperm = tensor(lv.ciperm, device).long()
        levels.append(out)
    bc = amg.bt_coarse
    return BandAMG(
        levels=tuple(levels), n=int(amg.n),
        coarse_inv=(None if bc is not None
                    else tensor(amg.coarse_inv, device).float()),
        bt_coarse=None if bc is None else BTCoarse(
            bt_factor(bc.factor, device), n=int(bc.n),
            perm=None if bc.perm is None else tensor(bc.perm, device).long(),
            iperm=None if bc.iperm is None
            else tensor(bc.iperm, device).long()))


def cband_entry(ent, device="cpu") -> dict:
    """A JAX complex (AC) band-engine entry (``solver._CBAND_CACHE``
    value) as the port's: the shifted-real hierarchy ``amg``, the
    operator bands ``Aop`` (real part) and ``Ai`` (imaginary part), the
    factor ``bt`` (or None), and the RCM order ``perm`` / ``iperm``."""
    return {"amg": band_amg(ent["amg"], device),
            "Aop": band_matrix(ent["Aop"], device),
            "Ai": band_matrix(ent["Ai"], device),
            "bt": _opt(bt_factor, ent.get("bt"), device),
            "perm": np.asarray(ent["perm"]),
            "iperm": np.asarray(ent["iperm"])}


def device_heat(dh, device="cpu") -> DeviceHeat:
    """A JAX ``DeviceHeat`` (the heat loop's device data) as the port's
    ``newton.DeviceHeat``: every field the port carries, read by name,
    integer maps as int64 and values as f32 (None stays None; the JAX
    tuple's whole-CSR maps, which its loop never reads, are left
    out)."""
    def field(a):
        if a is None:
            return None
        t = tensor(a, device)
        return t.float() if t.is_floating_point() else t.long()

    return DeviceHeat(**{name: field(getattr(dh, name))
                         for name in DeviceHeat._fields})


def partitioned_system(ps) -> PartitionedSystem:
    """A JAX ``PartitionedSystem`` (host numpy on both sides) as the
    port's, every array copied."""
    return PartitionedSystem(
        ndev=int(ps.ndev), nmax=int(ps.nmax), hmax=int(ps.hmax),
        nreduced=int(ps.nreduced), counts=np.array(ps.counts),
        blocks=[tuple(np.array(a) for a in blk) for blk in ps.blocks],
        fixed_mask=np.array(ps.fixed_mask),
        fixed_vals=np.array(ps.fixed_vals), valid=np.array(ps.valid),
        dof_dev=np.array(ps.dof_dev), dof_slot=np.array(ps.dof_slot))


def bt_device_maps(maps, device="cpu") -> BTDeviceMaps:
    """BTDeviceMaps (index maps as int64, ``is_L`` as bool)."""
    return BTDeviceMaps(**{
        name: (tensor(getattr(maps, name), device).bool() if name == "is_L"
               else tensor(getattr(maps, name), device).long())
        for name in BTDeviceMaps._fields})


def band_dd_state(st, device="cpu") -> BandDDState:
    """A JAX ``BandDDState`` (the sharded band engine's structure) as the
    port's: host maps copied, index maps as int64 tensors on ``device``,
    the per-part factor maps converted, the permuted pattern shared."""
    def idx(a):
        return tensor(a, device).long()

    return BandDDState(
        ndev=int(st.ndev), n=int(st.n), nloc=int(st.nloc),
        perm=np.array(st.perm), iperm=np.array(st.iperm),
        part_of=np.array(st.part_of), loc_of=np.array(st.loc_of),
        shift0=int(st.shift0), W=int(st.W), NT=int(st.NT),
        fill_pos=idx(st.fill_pos), fill_sel=idx(st.fill_sel),
        pad_pos=idx(st.pad_pos), oob_rows=idx(st.oob_rows),
        oob_cols=idx(st.oob_cols), oob_sel=idx(st.oob_sel),
        oob_w=tensor(st.oob_w, device).float(), b=int(st.b),
        NB=int(st.NB),
        bt_maps=[bt_device_maps(m, device) for m in st.bt_maps],
        bt_lsel=[np.array(a) for a in st.bt_lsel], data_map=st.data_map,
        Ap_pattern=st.Ap_pattern, lo=0, nl=int(st.ndev), comm=STACKED)
