"""Plain reference of planar time-harmonic magnetics with eddy currents
(upstream xfemm's Harmonic2D semantics, ``cfemm/fsolver``) on
first-order triangles, in SI units.

The complex nodal vector potential A (Wb/m) solves

    integral nu grad A . grad phi + j omega sigma integral A phi
        = integral J phi,

with nu = 1 / (mu0 mu_r) (mu_r complex in a wound region), omega =
2 pi f (f in Hz), sigma in S/m, J the source current density in A/m^2,
the consistent element mass (area / 12)(1 + delta_ij), and the fixed
nodes' values (A = 0 on the box edge). One sparse direct solve (SuperLU) gives it. ``gap`` judges a
given nodal A by max|A_ref - A| / max|A_ref|: for a linear problem this
is what the one Newton correction of the other references becomes.

A wound region (a coil of round magnet wire in a series circuit) is
Harmonic2D's: it carries the circuit's turns times its current spread
evenly over its area, has no eddy term (sigma = 0), and takes the
homogenised permeability of the winding, ``wound_mu_r`` (the proximity
effect of its strands).

Departures: NumPy and SciPy, not PyTorch, because the judgement needs a
complex sparse direct solve, which PyTorch lacks. Only what the
benchmark's problems use: linear isotropic materials with no B-H curve,
hysteresis lag or lamination, round magnet wire the only winding, no
solid conductor in a circuit (no voltage-gradient unknown), no
(anti)periodic pairs. A conductor outside a circuit carries its eddy
current with no constraint on its net current (Harmonic2D's block
outside any circuit).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import fem

MU0 = 4e-7 * math.pi

#: the complex type of each real precision
COMPLEX = {np.dtype(np.float64): np.complex128,
           np.dtype(np.float32): np.complex64}


@dataclass
class Harmonic:
    xy: np.ndarray            # (N, 2) node coordinates, m
    tris: np.ndarray          # (T, 3) counter-clockwise elements
    mu_r: np.ndarray          # (T,) relative permeability (complex)
    sigma: np.ndarray         # (T,) conductivity, S/m
    J: np.ndarray             # (T,) source current density, A/m^2
    freq: float               # Hz
    fixed: np.ndarray         # (N,) bool: Dirichlet nodes
    fixed_vals: np.ndarray    # (N,) their A, Wb/m (complex)


def wound_mu_r(freq: float, sigma: float, wire_d: float, strands: int,
               turns: int, area: float) -> complex:
    """Relative permeability of a region wound with ``turns`` turns of
    ``strands`` round magnet wires of diameter ``wire_d`` (m) and
    conductivity ``sigma`` (S/m) over ``area`` (m^2), at ``freq`` Hz:
    FEMM's fitted continuum model of the strands' proximity-effect
    eddy currents (``GetFillFactor`` of ``cfemm/fsolver``), with the
    fill factor of the copper in the region."""
    if freq == 0.0 or sigma == 0.0 or area == 0.0:
        return 1.0 + 0.0j
    R = wire_d / 2.0
    fill = abs(math.pi * R * R * strands * turns / area)
    W = 2.0 * math.pi * freq * sigma * MU0 * R * R / 2.0
    c1 = 0.7756067409818643 + fill * (0.6873854335408803 + fill * (
        0.06841584481674128 - 0.07143732702512284 * fill))
    c2 = 1.5 * fill / c1
    q = np.sqrt(c1 * 1j * W)
    return complex(c2 * np.tanh(q) / q + (1.0 - c2))


def solve(p: Harmonic, dtype=np.float64):
    """The nodal A by one sparse LU of the Dirichlet-eliminated system,
    assembled and solved in the complex type of ``dtype`` (complex128
    for float64, complex64 for float32). Returns (nodal A as complex128,
    1 solve)."""
    ct = COMPLEX[np.dtype(dtype)]
    n = len(p.xy)
    b, c, area = fem.gradients(p.xy, p.tris, np.float64)
    if (area <= 0).any():
        raise ValueError("elements must be counter-clockwise")
    nu = 1.0 / (MU0 * np.asarray(p.mu_r, np.complex128))
    mass = (np.ones((3, 3)) + np.eye(3)) / 12.0
    omega = 2.0 * math.pi * p.freq
    mats = (nu[:, None, None] * fem.stiffness(b, c, area)
            + 1j * omega * (np.asarray(p.sigma, np.float64)
                            * area)[:, None, None] * mass)
    dof, sgn = np.arange(n), np.ones(n)
    K = fem.scatter_matrix(p.tris, mats.astype(ct), dof, sgn, n, ct)
    f = fem.scatter_vector(p.tris, np.repeat(
        (np.asarray(p.J, np.complex128) * area / 3.0)[:, None], 3, 1),
        dof, sgn, n, ct)
    g = np.where(p.fixed, np.asarray(p.fixed_vals, np.complex128),
                 0.0).astype(ct)
    free = np.nonzero(~np.asarray(p.fixed, bool))[0]
    rhs = f - K @ g
    A = g.copy()
    A[free] = fem.solve(K[free][:, free], rhs[free])
    return A.astype(np.complex128), 1


def gap(p: Harmonic, A) -> float:
    """Distance of the nodal ``A`` from the complex128 solution,
    relative to the solution's largest magnitude: max|A_ref - A| /
    max|A_ref| (inf for a wrong shape or a value that is not finite).
    The fixed nodes count like the others."""
    if np.shape(A) != (len(p.xy),):
        return math.inf
    A = np.asarray(A, np.complex128)
    if not np.isfinite(A).all():
        return math.inf
    ref, _ = solve(p)
    scale = max(float(np.abs(ref).max()), 1e-300)
    return float(np.abs(ref - A).max()) / scale
