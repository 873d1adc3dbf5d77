"""Batched finite-element assembly primitives.

The reference assembles one 3x3 element at a time into linked-list sparse
rows (cfemm/fsolver/static2d.cpp:352-816). Here assembly is data-parallel:
shape functions, element matrices, and right-hand sides are computed for
ALL elements at once as (T,3)/(T,3,3) arrays. Formulas follow Allaire's
first-order triangle formulation exactly as coded in the reference
(static2d.cpp:382-457).

Every function takes NumPy arrays or torch tensors (``_xp`` picks the
namespace). The solve assembles on host in float64: the solution
contract (relative residual <= 1e-8..1e-10, spars.cpp:300) needs
full-precision assembly and residuals, while the Krylov iterations run
on the device in f32 against the same operator (ops/solver.py).
The axisymmetric forms (``axi_geometry``, ``axi_curl_matrices``) are
the reference's staticaxi.cpp element of the trial space
c0 + c1 r^2 + c2 z.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class _TorchNS:
    """The few NumPy-style calls these formulas make, on torch tensors."""

    def __getattr__(self, name):
        import torch
        return {"clip": torch.clamp, "take_along_axis": torch.take_along_dim,
                }.get(name) or getattr(torch, name)


def _xp(a):
    return np if isinstance(a, np.ndarray) else _TorchNS()


class TriGeometry(NamedTuple):
    p: "np.ndarray"        # (T, 3) y-differences (Allaire's b)
    q: "np.ndarray"        # (T, 3) x-differences (Allaire's c)
    area: "np.ndarray"     # (T,) signed element area (positive for CCW)
    lengths: "np.ndarray"  # (T, 3) side lengths, side j = (node j, node j+1)


def tri_geometry(xy, tris) -> TriGeometry:
    """Shape parameters for first-order triangles
    (static2d.cpp:388-414)."""
    xp = _xp(xy)
    v = xy[tris]  # (T, 3, 2)
    x = v[:, :, 0]
    y = v[:, :, 1]
    nxt = np.roll(np.arange(3), -1)
    prv = np.roll(np.arange(3), 1)
    p = y[:, nxt] - y[:, prv]          # p[j] = y[j+1] - y[j+2]
    q = x[:, prv] - x[:, nxt]          # q[j] = x[j+2] - x[j+1]
    area = (p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0]) / 2.0
    lengths = xp.sqrt((x[:, nxt] - x) ** 2 + (y[:, nxt] - y) ** 2)
    return TriGeometry(p=p, q=q, area=area, lengths=lengths)


def curl_matrices(geom: TriGeometry):
    """(Mx, My, Mxy) stiffness pieces with the K = -1/(4a) factor folded in
    (static2d.cpp:416-457). Mx couples the p (y-difference) parameters."""
    K = -1.0 / (4.0 * geom.area)
    Mx = K[:, None, None] * geom.p[:, :, None] * geom.p[:, None, :]
    My = K[:, None, None] * geom.q[:, :, None] * geom.q[:, None, :]
    Mxy = K[:, None, None] * (geom.p[:, :, None] * geom.q[:, None, :]
                              + geom.q[:, :, None] * geom.p[:, None, :])
    return Mx, My, Mxy


class AxiGeometry(NamedTuple):
    """Axisymmetric element geometry (staticaxi.cpp:185-260): the trial
    space is c0 + c1 r^2 + c2 z per element, giving r-weighted shape
    parameters and two effective radii (arithmetic R and log-mean
    R_hat)."""

    p: "np.ndarray"        # (T, 3) z-differences
    q: "np.ndarray"        # (T, 3) r-differences
    g: "np.ndarray"        # (T, 3) opposite-midside radii
    rn: "np.ndarray"       # (T, 3) corner radii
    area: "np.ndarray"     # (T,) plane triangle area
    a_hat: "np.ndarray"    # (T,) r^2-weighted area parameter
    R: "np.ndarray"        # (T,) centroid radius
    R_hat: "np.ndarray"    # (T,) log-mean radius
    vol: "np.ndarray"      # (T,) 2*R*a_hat
    lengths: "np.ndarray"  # (T, 3) side lengths


def axi_geometry(xy, tris, axis_tol: float = 1e-6) -> AxiGeometry:
    """Shape parameters for axisymmetric first-order triangles
    (staticaxi.cpp:185-260). ``axis_tol`` is the on-axis radius test."""
    xp = _xp(xy)
    v = xy[tris]
    r = v[:, :, 0]
    z = v[:, :, 1]
    nxt = np.roll(np.arange(3), -1)
    prv = np.roll(np.arange(3), 1)
    p = z[:, nxt] - z[:, prv]
    q = r[:, prv] - r[:, nxt]
    g = (r[:, prv] + r[:, nxt]) / 2.0
    area = (p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0]) / 2.0
    R = r.mean(axis=1)
    a_hat = xp.sum(r * r * p, axis=1) / (4.0 * R)
    vol = 2.0 * R * a_hat
    lengths = xp.sqrt((r[:, nxt] - r) ** 2 + (z[:, nxt] - z) ** 2)

    # R_hat: log-mean radius with three cases by # of on-axis corners
    # (staticaxi.cpp:219-260); safe log arguments where unused.
    on_axis = r < axis_tol
    n_axis = on_axis.sum(axis=1)
    rs = xp.where(on_axis, 1.0, r)         # guard log(0)
    logr = xp.log(rs)

    # case 1: exactly one corner on axis j -- pair is the other two
    # corners (j+1, j+2)
    r1 = xp.take_along_axis(rs, ((xp.argmax(on_axis, axis=1) + 1) % 3)[:, None], 1)[:, 0]
    r2 = xp.take_along_axis(rs, ((xp.argmax(on_axis, axis=1) + 2) % 3)[:, None], 1)[:, 0]
    near = xp.abs(r1 - r2) < axis_tol
    safe_ratio = xp.where(near, 2.0, r1 / r2)   # keep log != 0 when unused
    case1 = xp.where(near, r2 / 2.0,
                     (r1 - r2) / (2.0 * xp.log(safe_ratio)))

    # case 0: no corner on axis. If some q_j ~ 0 (side parallel to axis):
    # R_hat = q_k^2 / (2(-q_k + rn_j ln(rn_j/rn_{j2}))) per the branch
    # table; general: -q0 q1 q2 / (2 sum q_j rn_j ln rn_j)
    denom = 2.0 * xp.sum(q * rs * logr, axis=1)
    denom = xp.where(denom == 0.0, 1.0, denom)
    gen = -(q[:, 0] * q[:, 1] * q[:, 2]) / denom
    case0 = gen
    for j, (kq, kr, kr2) in enumerate([(1, 0, 2), (2, 1, 0), (0, 2, 1)]):
        qz = xp.abs(q[:, j]) < axis_tol
        d = -q[:, kq] + rs[:, kr] * xp.log(
            xp.where(qz, rs[:, kr] / rs[:, kr2], 1.0))
        d = xp.where(d == 0.0, 1.0, d)
        case0 = xp.where(qz, q[:, kq] * q[:, kq] / (2.0 * d), case0)

    R_hat = xp.where(n_axis == 2, R, xp.where(n_axis == 1, case1, case0))
    return AxiGeometry(p=p, q=q, g=g, rn=r, area=area, a_hat=a_hat, R=R,
                       R_hat=R_hat, vol=vol, lengths=lengths)


def axi_curl_matrices(geom: AxiGeometry, axis_tol: float = 1e-6):
    """(Mr, Mz, Mrz) axisymmetric stiffness pieces (staticaxi.cpp:262-300).

    Mr couples p_j rn_j terms with K=-1/(2 a_hat R); on-axis corner
    diagonals get the matrix trace added for conditioning (the DOF is
    pinned to zero later). Mz couples (q_j rn_j g_j/R) with
    K=-1/(2 a_hat R_hat)."""
    xp = _xp(geom.p)
    prn = geom.p * geom.rn
    Kx = -1.0 / (2.0 * geom.a_hat * geom.R)
    Mx = Kx[:, None, None] * prn[:, :, None] * prn[:, None, :]
    tr = Mx[:, 0, 0] + Mx[:, 1, 1] + Mx[:, 2, 2]
    on_axis = geom.rn < axis_tol
    eye = np.eye(3)
    Mx = Mx + (on_axis * tr[:, None])[:, :, None] * eye[None]

    qg = geom.q * geom.rn * geom.g / geom.R[:, None]
    Kz = -1.0 / (2.0 * geom.a_hat * geom.R_hat)
    My = Kz[:, None, None] * qg[:, :, None] * qg[:, None, :]
    Mxy = Kz[:, None, None] * (qg[:, :, None] * prn[:, None, :]
                               + prn[:, :, None] * qg[:, None, :])
    return Mx, My, Mxy


def hermite_vdv(B, knots_B, knots_H, knots_S):
    """Batched reluctivity lookup: (v, dv) = (H/B, d(H/B)/dB^2) on padded
    cubic-Hermite B-H tables.

    ``knots_*`` are (T, K) per-element gathered rows (already padded with a
    final linear-extension knot so out-of-range lookups extrapolate with
    the last slope exactly like CMaterialProp.cpp:1030-1037). ``B`` is (T,).
    """
    xp = _xp(B)
    b = xp.abs(B)
    K = knots_B.shape[1]
    # interval index: number of knots strictly below b, minus 1
    idx = xp.clip(xp.sum(knots_B < b[:, None], axis=1) - 1, 0, K - 2)
    take = lambda arr, i: xp.take_along_axis(arr, i[:, None], axis=1)[:, 0]
    B0 = take(knots_B, idx)
    B1 = take(knots_B, idx + 1)
    H0 = take(knots_H, idx)
    H1 = take(knots_H, idx + 1)
    s0 = take(knots_S, idx)
    s1 = take(knots_S, idx + 1)
    l = B1 - B0
    z = (b - B0) / l
    z2 = z * z
    h = ((1.0 - 3.0 * z2 + 2.0 * z2 * z) * H0
         + z * (1.0 - 2.0 * z + z2) * l * s0
         + z2 * (3.0 - 2.0 * z) * H1
         + z2 * (z - 1.0) * l * s1)
    dh = (6.0 * z * (z - 1.0) * H0 / l
          + (1.0 - 4.0 * z + 3.0 * z2) * s0
          + 6.0 * z * (1.0 - z) * H1 / l
          + z * (3.0 * z - 2.0) * s1)
    bsafe = xp.where(b == 0.0, 1.0, b)
    v = xp.where(b == 0.0, knots_S[:, 0], h / bsafe)
    dv = xp.where(b == 0.0, 0.0,
                  0.5 * (dh / (bsafe * bsafe) - h / bsafe ** 3))
    return v, dv
