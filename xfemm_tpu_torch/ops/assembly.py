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
The axisymmetric forms come with the axisymmetric slice of the port.
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
