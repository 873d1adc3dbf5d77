"""B-H curve arithmetic of the plain reference: a frozen copy of FEMM's
cubic-Hermite H(B) fit (CMaterialProp.cpp:127-338, GetSlopes, real
magnetostatic branch) and its reluctivity lookup (CMaterialProp.cpp
GetBHProps, with the linear extension past the last knot,
CMaterialProp.cpp:1030-1037).

Kept here so that the reference shares no code with the program it
judges; a change to the program's curve arithmetic does not move the
reference."""

from __future__ import annotations

import math

import numpy as np


def _tridiag_solve(lower, diag, upper, rhs):
    """Thomas algorithm for a tridiagonal system (lists of floats)."""
    n = len(diag)
    d = list(diag)
    b = list(rhs)
    for k in range(n - 1):
        c = lower[k] / d[k]
        d[k + 1] -= upper[k] * c
        b[k + 1] -= b[k] * c
    x = [0.0] * n
    x[n - 1] = b[n - 1] / d[n - 1]
    for k in range(n - 2, -1, -1):
        x[k] = (b[k] - upper[k] * x[k + 1]) / d[k]
    return x


def _non_monotone(B, H, slopes) -> bool:
    """True when some Hermite segment's derivative has a root inside
    the segment (CMaterialProp.cpp:237-273)."""
    for i in range(1, len(B)):
        d0, d1 = slopes[i - 1], slopes[i]
        u0, u1 = H[i - 1], H[i]
        L = B[i] - B[i - 1]
        c0 = d0
        c1 = -(2.0 * (2.0 * d0 * L + d1 * L + 3.0 * u0 - 3.0 * u1)) / (L * L)
        c2 = (3.0 * (d0 * L + d1 * L + 2.0 * u0 - 2.0 * u1)) / (L ** 3)
        X0 = X1 = -1.0
        disc = c1 * c1 - 4.0 * c0 * c2
        if c2 == 0.0:
            if c1 != 0.0:
                X0 = -c0 / c1
        elif disc > 0.0:
            rt = math.sqrt(disc)
            X0 = -(c1 + rt) / (2.0 * c2)
            X1 = (-c1 + rt) / (2.0 * c2)
        if (0.0 <= X0 <= L) or (0.0 <= X1 <= L):
            return True
    return False


class Curve:
    """A fitted B-H curve: knots ``B`` (T), ``H`` (A/m) and the Hermite
    slopes dH/dB at the knots."""

    def __init__(self, bdata, hdata):
        B = [float(b) for b in bdata]
        H = [float(h) for h in hdata]
        n = len(B)
        if n < 2:
            raise ValueError("a B-H curve needs at least two points")
        while True:
            # natural-end spline system (CMaterialProp.cpp:204-231)
            lo = [0.0] * (n - 1)
            di = [0.0] * n
            up = [0.0] * (n - 1)
            rhs = [0.0] * n
            l1 = B[1] - B[0]
            di[0] = 4.0 / l1
            up[0] = 2.0 / l1
            rhs[0] = 6.0 * (H[1] - H[0]) / (l1 * l1)
            l1 = B[n - 1] - B[n - 2]
            di[n - 1] = 4.0 / l1
            lo[n - 2] = 2.0 / l1
            rhs[n - 1] = 6.0 * (H[n - 1] - H[n - 2]) / (l1 * l1)
            for i in range(1, n - 1):
                l1 = B[i] - B[i - 1]
                l2 = B[i + 1] - B[i]
                lo[i - 1] = 2.0 / l1
                di[i] = 4.0 * (l1 + l2) / (l1 * l2)
                up[i] = 2.0 / l2
                rhs[i] = (6.0 * (H[i] - H[i - 1]) / (l1 * l1)
                          + 6.0 * (H[i + 1] - H[i]) / (l2 * l2))
            slopes = _tridiag_solve(lo, di, up, rhs)
            if not _non_monotone(B, H, slopes):
                break
            # 3-point moving-average repair (CMaterialProp.cpp:280-289)
            bn, hn = B[:], H[:]
            for i in range(1, n - 1):
                bn[i] = (B[i - 1] + B[i] + B[i + 1]) / 3.0
                hn[i] = (H[i - 1] + H[i] + H[i + 1]) / 3.0
            B, H = bn, hn
        self.B = np.asarray(B)
        self.H = np.asarray(H)
        self.S = np.asarray(slopes)

    def nu(self, b):
        """(v, dv): reluctivity H/B (m/H) and its derivative with respect
        to B^2, at flux densities ``b`` (T)."""
        Bk, Hk, Sk = self.B, self.H, self.S
        dtype = np.asarray(b).dtype
        b = np.abs(np.asarray(b, np.float64))
        n = len(Bk)
        i = np.clip(np.searchsorted(Bk, b, side="right") - 1, 0, n - 2)
        B0, B1, H0, H1 = Bk[i], Bk[i + 1], Hk[i], Hk[i + 1]
        s0, s1 = Sk[i], Sk[i + 1]
        L = B1 - B0
        z = (b - B0) / L
        z2 = z * z
        h = ((1.0 - 3.0 * z2 + 2.0 * z2 * z) * H0
             + z * (1.0 - 2.0 * z + z2) * L * s0
             + z2 * (3.0 - 2.0 * z) * H1
             + z2 * (z - 1.0) * L * s1)
        dh = (6.0 * z * (z - 1.0) * H0 / L
              + (1.0 - 4.0 * z + 3.0 * z2) * s0
              + 6.0 * z * (1.0 - z) * H1 / L
              + z * (3.0 * z - 2.0) * s1)
        over = b > Bk[-1]
        h = np.where(over, Hk[-1] + Sk[-1] * (b - Bk[-1]), h)
        dh = np.where(over, Sk[-1], dh)
        bs = np.where(b == 0.0, 1.0, b)
        v = np.where(b == 0.0, Sk[0], h / bs)
        dv = np.where(b == 0.0, 0.0, 0.5 * (dh / (bs * bs) - h / bs ** 3))
        return v.astype(dtype, copy=False), dv.astype(dtype, copy=False)
