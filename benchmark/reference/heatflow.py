"""Plain reference of planar steady heat flow with temperature-dependent
conductivity (hsolver's semantics) on first-order triangles.

The nodal temperature T solves

    integral k_e(T) grad T . grad phi = integral qv phi,

with fixed temperatures on Dirichlet nodes, where an element's
conductivity is that of a linear material (kx, ky) or, for a material
with a K(T) table, the mean over its three nodes of the table linearly
interpolated at the node's temperature and held at its end values past
the table (hsolver's successive substitution converges to this fixed
point). Newton's method with the exact Jacobian

    k_e S + (S T_e) (k'(T_nodes) / 3)^T

and a backtracking step solves it; ``gap`` judges a given nodal T by one
Newton correction from it, as ``magnetostatic.gap`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import fem


@dataclass
class HeatFlow:
    xy: np.ndarray            # (N, 2) node coordinates, m
    tris: np.ndarray          # (T, 3) counter-clockwise elements
    kx: np.ndarray            # (T,) conductivity of linear elements, W/(m K)
    ky: np.ndarray
    table: np.ndarray         # (T,) index into ``tables``, -1 where linear
    qv: np.ndarray            # (T,) volume heat source, W/m^3
    fixed: np.ndarray         # (N,) bool: fixed-temperature nodes
    fixed_vals: np.ndarray    # (N,) their temperature
    depth: float = 1.0        # m
    tables: list = field(default_factory=list)   # (T points, k points)


class _Prepared:
    def __init__(self, p: HeatFlow, dtype):
        self.p = p
        self.dtype = dtype
        b, c, area = fem.gradients(p.xy, p.tris, np.float64)
        if (area <= 0).any():
            raise ValueError("elements must be counter-clockwise")
        d = p.depth / (4.0 * area)
        self.Sx = (d[:, None, None] * b[:, :, None] * b[:, None, :]
                   ).astype(dtype)
        self.Sy = (d[:, None, None] * c[:, :, None] * c[:, None, :]
                   ).astype(dtype)
        n = len(p.xy)
        self.n = n
        self.f = fem.scatter_vector(
            p.tris, np.repeat((p.depth * p.qv * area / 3.0)[:, None], 3, 1),
            np.arange(n), np.ones(n), n, dtype)
        self.tab = np.asarray(p.table)
        self.free = np.nonzero(~np.asarray(p.fixed))[0]

    def conductivity(self, T):
        """(kx, ky, dk/dT at the nodes / 3) of every element."""
        p, dt = self.p, self.dtype
        kx = np.asarray(p.kx, np.float64).copy()
        ky = np.asarray(p.ky, np.float64).copy()
        dk3 = np.zeros((len(p.tris), 3))
        Te = np.asarray(T, np.float64)[p.tris]
        for k, (tp, kp) in enumerate(p.tables):
            sel = self.tab == k
            if not sel.any():
                continue
            tp = np.asarray(tp, np.float64)
            kp = np.asarray(kp, np.float64)
            kav = np.interp(Te[sel], tp, kp).mean(axis=1)
            kx[sel] = kav
            ky[sel] = kav
            seg = np.clip(np.searchsorted(tp, Te[sel], side="right") - 1, 0,
                          len(tp) - 2)
            slope = (kp[seg + 1] - kp[seg]) / (tp[seg + 1] - tp[seg])
            inside = (Te[sel] > tp[0]) & (Te[sel] < tp[-1])
            dk3[sel] = np.where(inside, slope, 0.0) / 3.0
        return kx.astype(dt), ky.astype(dt), dk3.astype(dt)

    def residual(self, T, jacobian: bool):
        p, dt = self.p, self.dtype
        T = np.asarray(T, dt)
        kx, ky, dk3 = self.conductivity(T)
        Ke = kx[:, None, None] * self.Sx + ky[:, None, None] * self.Sy
        Te = T[p.tris]
        u = np.einsum("tij,tj->ti", Ke, Te)
        R = np.zeros(self.n, dt)
        np.add.at(R, p.tris.ravel(), u.ravel())
        R -= self.f
        if not jacobian:
            return R, None
        Su = np.einsum("tij,tj->ti", self.Sx + self.Sy, Te)
        mats = Ke + Su[:, :, None] * dk3[:, None, :]
        ones = np.ones(self.n)
        return R, fem.scatter_matrix(p.tris, mats, np.arange(self.n), ones,
                                     self.n, dt)


def _start(p: HeatFlow, dtype):
    T = np.full(len(p.xy), float(np.mean(np.asarray(p.fixed_vals)[p.fixed])))
    T[p.fixed] = np.asarray(p.fixed_vals)[p.fixed]
    return T.astype(dtype)


def solve(p: HeatFlow, dtype=np.float64, tol: float = 1e-12,
          max_iter: int = 60):
    """Newton's method in ``dtype`` throughout, from the mean fixed
    temperature; stops as ``magnetostatic.solve`` does. Returns (nodal T
    as float64, Newton steps)."""
    pr = _Prepared(p, dtype)
    T = _start(p, dtype)
    free = pr.free
    R, Jm = pr.residual(T, True)
    rn = float(np.abs(R[free]).max())
    steps = 0
    for steps in range(1, max_iter + 1):
        d = np.zeros_like(T)
        d[free] = fem.solve(Jm[free][:, free], -R[free])
        t = 1.0
        while True:
            Tn = T + np.asarray(t, dtype) * d
            Rn, _ = pr.residual(Tn, False)
            rnn = float(np.abs(Rn[free]).max())
            if rnn < rn or t < 1e-3:
                break
            t *= 0.5
        moved = float(np.abs(t * d).max()) / max(float(np.abs(Tn).max()),
                                                 1e-300)
        floor = rnn >= rn
        T = Tn
        if moved < tol or floor:
            break
        R, Jm = pr.residual(T, True)
        rn = float(np.abs(R[free]).max())
    return np.asarray(T, np.float64), steps


def gap(p: HeatFlow, T) -> float:
    """Distance of the nodal ``T`` from the discrete solution (one float64
    Newton correction), or the amount by which ``T`` misses the fixed
    temperatures if larger, relative to the solution's range of
    temperature."""
    pr = _Prepared(p, np.float64)
    T = np.asarray(T, np.float64)
    if T.shape != (pr.n,) or not np.isfinite(T).all():
        return math.inf
    off = float(np.abs(T - np.asarray(p.fixed_vals))[p.fixed].max(
        initial=0.0))
    R, Jm = pr.residual(T, True)
    d = np.zeros_like(T)
    free = pr.free
    d[free] = fem.solve(Jm[free][:, free], -R[free])
    Tr = T + d
    scale = max(float(Tr.max() - Tr.min()), 1e-300)
    return max(float(np.abs(d).max()), off) / scale
