"""Plain reference of axisymmetric nonlinear magnetostatics (upstream
xfemm's StaticAxisymmetric semantics, ``cfemm/fsolver``) on first-order
triangles in the (r, z) half plane, in SI units.

The azimuthal vector potential A (Wb/m) at the nodes is the unknown.
On each element the flux function psi = r A lies in the trial space
c0 + c1 r^2 + c2 z (linear in s = r^2 and z), interpolated from the
corners' r_j A_j, so that

    B_z = (1/r) d psi/dr = 2 c1,    B_r = -(1/r) d psi/dz = -c2 / r.

The element's area a_hat = A_s / (2 R), with A_s the area of the
triangle of its corners (r_j^2, z_j) and R the arithmetic mean radius
of its corners, stands for its area in the r-weighted integrals: the
B_z^2 term is taken at the arithmetic radius (integral of r dA as
a_hat R) and the B_r^2 term at the log-mean radius R_hat (integral of
dA / r as a_hat / R_hat, where area / R_hat is the exact integral of
dA / r over the element). The magnetic energy is

    W(A) = 2 pi sum_e a_hat_e R_e w_e(|B_e|)  -  sum_j f_j A_j,

with w the co-energy density of the element's material (nu B^2 / 2 for
linear ones, nu = 1 / (mu0 mu_r); the integral of H dB of the fitted
B-H curve, ``bh.Curve``, for nonlinear ones) and |B_e|^2 the element's
energy quadratic form over its r-weighted volume:

    |B|^2 = (B_z^2 a_hat R + c2^2 a_hat / R_hat) / (a_hat R).

The source J (A/m^2) carries the loop factor 2 pi r at the element's
mean radius: corner j of an element gets f_j = 2 pi R J area / 3. Nodes
on the axis (r = 0) are pinned to A = 0, and so are the given Dirichlet
nodes. Newton's method with the exact Jacobian

    2 pi [nu S + (2 dnu/dB^2 / (a_hat R)) (S A)(S A)^T]

(S: the element's quadratic form in A, |B|^2 = A^T S A / (a_hat R))
and a backtracking step solves it. The output is the flux 2 pi r A
(Wb) at every node, what fsolver writes. ``gap`` judges a given nodal
flux by one float64 Newton correction from it, in the same units.

Departures: the element arithmetic is plain PyTorch on the CPU (float64,
or float32 for the control; TF32 never applies there), but the one
sparse direct solve of a Newton correction goes through ``fem.solve``
(SciPy's SuperLU), because PyTorch has no sparse direct solver on the
CPU; ``bh.Curve`` gives nu and its derivative in NumPy. Only what the
benchmark's axisymmetric problem uses: isotropic materials with no
lamination, coercivity or conductivity, no circuits, point currents,
(anti)periodic pairs, Robin boundaries or external (Kelvin) regions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from . import fem

MU0 = 4e-7 * math.pi
TWO_PI = 2.0 * math.pi
#: a node lies on the axis when its r is below this share of the
#: largest r
AXIS_TOL = 1e-9
#: torch's type of each NumPy precision
TORCH = {np.dtype(np.float64): torch.float64,
         np.dtype(np.float32): torch.float32}


@dataclass
class Axisymmetric:
    rz: np.ndarray            # (N, 2) node coordinates (r, z), m, r >= 0
    tris: np.ndarray          # (T, 3) counter-clockwise elements
    mu_r: np.ndarray          # (T,) relative permeability of linear elements
    curve: np.ndarray         # (T,) index into ``curves``, -1 where linear
    J: np.ndarray             # (T,) azimuthal source current density, A/m^2
    fixed: np.ndarray         # (N,) bool: Dirichlet nodes (A = 0)
    curves: list = field(default_factory=list)   # bh.Curve


def _mean_log(a, b):
    """The mean of ln r along a straight edge from r = a to r = b,
    integral_0^1 ln(a + t (b - a)) dt, elementwise (-inf where a = b =
    0). Near a = b the closed form cancels, so a series in h = (b - a) /
    (b + a) takes its place: ln m - sum_k h^2k / (2k (2k + 1))."""
    m = 0.5 * (a + b)
    h = (b - a) / torch.where(m > 0, 2.0 * m, torch.ones_like(m))
    h2 = h * h
    series = torch.log(m) - h2 * (1.0 / 6.0 + h2 * (1.0 / 20.0
                                                    + h2 / 42.0))

    def xlogx(x):
        return torch.where(x > 0, x * torch.log(torch.where(
            x > 0, x, torch.ones_like(x))), torch.zeros_like(x))

    d = torch.where(b == a, torch.ones_like(a), b - a)
    closed = (xlogx(b) - xlogx(a)) / d - 1.0
    return torch.where(h.abs() < 1e-2, series, closed)


def inverse_r_integral(r, z):
    """The integral of dA / r over each counter-clockwise triangle with
    corners (r_j, z_j), r and z (T, 3): by the divergence theorem it is
    the integral of ln r dz around the boundary. Infinite for an element
    with an edge on the axis."""
    total = torch.zeros_like(r[:, 0])
    for j in range(3):
        k = (j + 1) % 3
        dz = z[:, k] - z[:, j]
        edge = _mean_log(r[:, j], r[:, k])
        total = total + torch.where(dz == 0, torch.zeros_like(dz),
                                    dz * edge)
    return total


class _Prepared:
    """The A-independent pieces of a problem, in one precision."""

    def __init__(self, p: Axisymmetric, dtype):
        self.p = p
        self.dtype = np.dtype(dtype)
        tdt = TORCH[self.dtype]
        rz = torch.as_tensor(np.asarray(p.rz, np.float64))
        tris = torch.as_tensor(np.asarray(p.tris, np.int64))
        self.tris = tris
        n = rz.shape[0]
        r, z = rz[tris, 0], rz[tris, 1]              # (T, 3), float64
        nxt, prv = [1, 2, 0], [2, 0, 1]
        b = z[:, nxt] - z[:, prv]                    # d/dr coefficients
        c = r[:, prv] - r[:, nxt]
        area = (b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0]) / 2.0
        if (area <= 0).any():
            raise ValueError("elements must be counter-clockwise")
        s = r * r
        cs = s[:, prv] - s[:, nxt]                   # d/dz coefficients
        a_s = 0.5 * (s * b).sum(1)                   # area in (r^2, z)
        R = r.mean(1)
        a_hat = a_s / (2.0 * R)
        on_axis_r = r <= AXIS_TOL * float(rz[:, 0].max())
        inv = inverse_r_integral(torch.where(on_axis_r, 0.0, r), z)
        edge_on_axis = on_axis_r.sum(1) >= 2
        # an edge on the axis: psi = 0 along it, so c2 = 0 and R_hat
        # multiplies nothing
        R_hat = torch.where(edge_on_axis, R,
                            area / torch.where(edge_on_axis, 1.0, inv))
        vol = a_hat * R                              # r-weighted volume
        # |B|^2 vol = psi^T G psi; in A: S = diag(r) G diag(r)
        G = (b[:, :, None] * b[:, None, :] / (4.0 * vol)[:, None, None]
             + cs[:, :, None] * cs[:, None, :]
             / (16.0 * a_hat * R * R * R_hat)[:, None, None])
        S = r[:, :, None] * G * r[:, None, :]
        self.S = S.to(tdt)
        self.vol = vol.to(tdt)
        f_el = (TWO_PI * R * torch.as_tensor(np.asarray(p.J, np.float64))
                * area / 3.0)[:, None].expand(-1, 3)
        self.f = torch.zeros(n, dtype=tdt).index_add_(
            0, tris.reshape(-1), f_el.reshape(-1).to(tdt))
        self.nl = np.asarray(p.curve) >= 0
        self.nu_lin = (1.0 / (MU0 * torch.as_tensor(
            np.asarray(p.mu_r, np.float64)))).to(tdt)
        self.r = rz[:, 0]
        self.on_axis = (self.r <= AXIS_TOL * float(self.r.max())).numpy()
        self.pinned = np.asarray(p.fixed, bool) | self.on_axis
        self.free = np.nonzero(~self.pinned)[0]

    def flux(self, u):
        """Nodal flux 2 pi r A of nodal A (float64 NumPy)."""
        return TWO_PI * self.r.numpy() * np.asarray(u, np.float64)

    def reduce(self, flux):
        """Nodal A of a nodal flux, and the largest flux on a pinned node
        (what the flux breaks of A = 0 there)."""
        flux = np.asarray(flux, np.float64)
        if flux.shape != (len(self.r),):
            raise ValueError(f"{flux.shape[0]} values for {len(self.r)} "
                             "nodes")
        r = self.r.numpy()
        u = np.where(self.on_axis, 0.0,
                     flux / np.where(self.on_axis, 1.0, TWO_PI * r))
        broken = float(np.abs(flux[self.pinned]).max(initial=0.0))
        u[self.pinned] = 0.0
        return u.astype(self.dtype), broken

    def residual(self, u, jacobian: bool):
        """R(u) = dW/dA on every node, and the Jacobian (SciPy CSR)."""
        p, tdt = self.p, TORCH[self.dtype]
        Ae = torch.as_tensor(np.asarray(u)).to(tdt)[self.tris]
        Su = torch.einsum("tij,tj->ti", self.S, Ae)
        nu = self.nu_lin.clone()
        dnu = torch.zeros_like(nu)
        if self.nl.any():
            B2 = torch.einsum("ti,ti->t", Ae, Su) / self.vol
            B = torch.sqrt(torch.clamp(B2, min=0.0)).numpy()
            for k, cv in enumerate(p.curves):
                sel = np.asarray(p.curve) == k
                if sel.any():
                    v, dv = cv.nu(B[sel])
                    idx = torch.as_tensor(np.nonzero(sel)[0])
                    nu[idx] = torch.as_tensor(v).to(tdt)
                    dnu[idx] = torch.as_tensor(dv).to(tdt)
        vec = TWO_PI * nu[:, None] * Su
        R = torch.zeros_like(self.f).index_add_(
            0, self.tris.reshape(-1), vec.reshape(-1)) - self.f
        if not jacobian:
            return R.numpy(), None
        mats = TWO_PI * (nu[:, None, None] * self.S
                         + (2.0 * dnu / self.vol)[:, None, None]
                         * Su[:, :, None] * Su[:, None, :])
        n = len(self.r)
        rows = self.tris[:, :, None].expand(-1, 3, 3).reshape(-1)
        cols = self.tris[:, None, :].expand(-1, 3, 3).reshape(-1)
        Jm = sp.csr_matrix((mats.reshape(-1).numpy(),
                            (rows.numpy(), cols.numpy())), shape=(n, n))
        return R.numpy(), Jm


def _norm(R, free):
    return float(np.abs(R[free]).max(initial=0.0))


def solve(p: Axisymmetric, dtype=np.float64, tol: float = 1e-12,
          max_iter: int = 60):
    """Newton's method from A = 0 in ``dtype`` throughout: element
    arithmetic, residual, Jacobian and the sparse LU. Stops when a step
    moves A by less than ``tol`` of max|A|, or when the residual stops
    falling (the precision's floor). Returns (nodal flux 2 pi r A as
    float64, Newton steps)."""
    pr = _Prepared(p, dtype)
    u = np.zeros(len(pr.r), pr.dtype)
    free = pr.free
    R, Jm = pr.residual(u, True)
    rn = _norm(R, free)
    steps = 0
    for steps in range(1, max_iter + 1):
        d = np.zeros_like(u)
        d[free] = fem.solve(Jm[free][:, free], -R[free])
        t = 1.0
        while True:
            un = u + np.asarray(t, pr.dtype) * d
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
    return pr.flux(u), steps


def gap(p: Axisymmetric, flux) -> float:
    """Distance of the nodal ``flux`` (2 pi r A, Wb) from the discrete
    solution, relative to the solution's largest magnitude: one float64
    Newton correction d from it, in flux, max|d| / max|flux + d|, or
    the largest flux on a pinned node (the axis and the Dirichlet
    nodes), if larger (relative alike)."""
    pr = _Prepared(p, np.float64)
    if np.shape(flux) != (len(pr.r),):
        return math.inf
    u, broken = pr.reduce(flux)
    if not np.isfinite(u).all():
        return math.inf
    R, Jm = pr.residual(u, True)
    d = np.zeros_like(u)
    free = pr.free
    d[free] = fem.solve(Jm[free][:, free], -R[free])
    dflux = pr.flux(d)
    scale = max(float(np.abs(pr.flux(u) + dflux).max()), 1e-300)
    return max(float(np.abs(dflux).max()), broken) / scale
