"""Carry the JAX package's band-engine state into the port.

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
from .ops.blocktri import BTCoarse, BTFactor
from .ops.newton import DeviceHeat


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


def band_level(lv, device="cpu") -> BandLevel:
    """The fine BandLevel: its band and inverse diagonal."""
    return BandLevel(A=band_matrix(lv.A, device),
                     invd=tensor(lv.invd, device).float())


def bt_factor(f, device="cpu") -> BTFactor:
    """BTFactor (Sinv, G, s)."""
    return BTFactor(Sinv=tensor(f.Sinv, device), G=tensor(f.G, device),
                    s=tensor(f.s, device).float())


def _opt(f, obj, device):
    return None if obj is None else f(obj, device)


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
