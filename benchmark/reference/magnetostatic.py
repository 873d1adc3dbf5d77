"""Plain reference of planar nonlinear magnetostatics (FEMM's Static2D
semantics) on first-order triangles, in SI units.

The nodal vector potential A (Wb/m) solves

    integral nu(|grad A|) grad A . grad phi
        = integral J phi + integral Hc m . curl phi,

with the reluctivity nu of linear elements 1 / (mu0 mu_r) and of
nonlinear ones H(B)/B from the fitted B-H curve (``bh.Curve``),
Dirichlet values on fixed nodes and (anti)periodic node pairs folded
together. Newton's method with the exact Jacobian

    nu S + (2 dnu/dB^2 / area) (S A)(S A)^T        (S: element Laplacian)

and a backtracking step solves it. ``gap`` judges a given nodal A by
one Newton correction from it: the correction is the distance to the
discrete solution, to second order in that distance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import bh, fem

MU0 = 4e-7 * math.pi


@dataclass
class Magnetostatic:
    xy: np.ndarray            # (N, 2) node coordinates, m
    tris: np.ndarray          # (T, 3) counter-clockwise elements
    mu_r: np.ndarray          # (T,) relative permeability of linear elements
    curve: np.ndarray         # (T,) index into ``curves``, -1 where linear
    J: np.ndarray             # (T,) source current density, A/m^2
    Hc: np.ndarray            # (T,) coercivity, A/m
    magdir: np.ndarray        # (T,) magnetization direction, degrees
    fixed: np.ndarray         # (N,) bool: Dirichlet nodes
    fixed_vals: np.ndarray    # (N,) their A, Wb/m
    curves: list = field(default_factory=list)   # bh.Curve
    pairs: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.int64))


class _Prepared:
    """The A-independent pieces of a problem, in one precision."""

    def __init__(self, p: Magnetostatic, dtype):
        self.p = p
        self.dtype = dtype
        n = len(p.xy)
        self.dof, self.sgn, self.m = fem.fold(n, p.pairs)
        b, c, area = fem.gradients(p.xy, p.tris, np.float64)
        if (area <= 0).any():
            raise ValueError("elements must be counter-clockwise")
        self.area = area.astype(dtype)
        self.S = fem.stiffness(b, c, area).astype(dtype)
        th = np.radians(p.magdir)
        mag = (p.Hc / 2.0)[:, None] * (np.cos(th)[:, None] * c
                                        - np.sin(th)[:, None] * b)
        f_el = (p.J * area / 3.0)[:, None] + mag
        self.f = fem.scatter_vector(p.tris, f_el, self.dof, self.sgn, self.m,
                                    dtype)
        self.nl = np.asarray(p.curve) >= 0
        self.nu_lin = (1.0 / (MU0 * np.asarray(p.mu_r, np.float64))) \
            .astype(dtype)
        fixed_dof = np.zeros(self.m, bool)
        fixed_dof[self.dof[p.fixed]] = True
        self.fixed_dof = fixed_dof
        self.free = np.nonzero(~fixed_dof)[0]
        g = np.zeros(self.m)
        g[self.dof[p.fixed]] = (self.sgn[p.fixed]
                                * np.asarray(p.fixed_vals)[p.fixed])
        self.g = g.astype(dtype)

    def nodal(self, u):
        return (self.sgn * u[self.dof]).astype(u.dtype)

    def reduce(self, A):
        """DOF values of nodal A, and the largest amount by which A breaks
        the folding and the Dirichlet values."""
        A = np.asarray(A, np.float64)
        if A.shape != (len(self.dof),):
            raise ValueError(f"{A.shape[0]} values for {len(self.dof)} nodes")
        u = np.zeros(self.m)
        u[self.dof] = self.sgn * A
        off = np.abs(self.nodal(u) - A)
        off_fixed = np.abs(u - self.g)[self.fixed_dof]
        broken = max(off.max(initial=0.0), off_fixed.max(initial=0.0))
        return u.astype(self.dtype), broken

    def residual(self, u, jacobian: bool):
        """R(u) = K(nu(u)) u - f on every DOF, and the Jacobian."""
        p, dt = self.p, self.dtype
        Ae = self.nodal(u)[p.tris].astype(dt)
        Su = np.einsum("tij,tj->ti", self.S, Ae)
        nu = self.nu_lin.copy()
        dnu = np.zeros_like(nu)
        if self.nl.any():
            B2 = np.einsum("ti,ti->t", Ae, Su) / self.area
            B = np.sqrt(np.maximum(B2, 0.0))
            for k, cv in enumerate(p.curves):
                sel = np.asarray(p.curve) == k
                if sel.any():
                    nu[sel], dnu[sel] = cv.nu(B[sel].astype(dt))
        R = fem.scatter_vector(p.tris, nu[:, None] * Su, self.dof, self.sgn,
                               self.m, dt) - self.f
        if not jacobian:
            return R, None
        mats = nu[:, None, None] * self.S + (
            2.0 * dnu / self.area)[:, None, None] * Su[:, :, None] \
            * Su[:, None, :]
        Jm = fem.scatter_matrix(p.tris, mats, self.dof, self.sgn, self.m, dt)
        return R, Jm


def _norm(R, free):
    return float(np.abs(R[free]).max(initial=0.0))


def solve(p: Magnetostatic, dtype=np.float64, tol: float = 1e-12,
          max_iter: int = 60):
    """Newton's method from A = 0 (the Dirichlet values on fixed nodes)
    in ``dtype`` throughout: assembly, residual, Jacobian and the sparse
    LU. Stops when a step moves A by less than ``tol`` of max|A|, or when
    the residual stops falling (the precision's floor). Returns
    (nodal A as float64, Newton steps)."""
    pr = _Prepared(p, dtype)
    u = pr.g.copy()
    free = pr.free
    R, Jm = pr.residual(u, True)
    rn = _norm(R, free)
    steps = 0
    for steps in range(1, max_iter + 1):
        d = np.zeros_like(u)
        d[free] = fem.solve(Jm[free][:, free], -R[free])
        t = 1.0
        while True:
            un = u + np.asarray(t, dtype) * d
            Rn, _ = pr.residual(un, False)
            rnn = _norm(Rn, free)
            if rnn < rn or t < 1e-3:
                break
            t *= 0.5
        moved = float(np.abs(t * d).max()) / max(float(np.abs(un).max()),
                                                 1e-300)
        floor = rnn >= rn
        u = un
        if moved < tol or floor:
            break
        R, Jm = pr.residual(u, True)
        rn = _norm(R, free)
    return pr.nodal(u).astype(np.float64), steps


def gap(p: Magnetostatic, A) -> float:
    """Distance of the nodal ``A`` from the discrete solution, relative
    to the solution's largest magnitude: one float64 Newton correction
    from ``A``, max|d| / max|A + d|, or the amount by which ``A`` breaks
    the Dirichlet values or the folding, if larger (relative alike)."""
    pr = _Prepared(p, np.float64)
    if np.shape(A) != (len(p.xy),):
        return math.inf
    u, broken = pr.reduce(A)
    if not np.isfinite(u).all():
        return math.inf
    R, Jm = pr.residual(u, True)
    d = np.zeros_like(u)
    free = pr.free
    d[free] = fem.solve(Jm[free][:, free], -R[free])
    scale = max(float(np.abs(u + d).max()), 1e-300)
    return max(float(np.abs(d).max()), broken) / scale
