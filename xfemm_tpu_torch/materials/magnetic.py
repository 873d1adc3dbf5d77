"""Magnetic material model with nonlinear B-H curves.

Re-implements the constitutive behaviour of the reference's material class
(cfemm/libfemm/CMaterialProp.h:77, cfemm/libfemm/CMaterialProp.cpp) with the
same numerical contracts:

* cubic-Hermite spline fit of the H(B) curve via a tridiagonal solve with
  natural boundary conditions and a monotonicity-repair loop using a 3-point
  moving average (CMaterialProp.cpp:127-348 ``GetSlopes``),
* harmonic "doctoring" of the curve by sine convolution plus the O'Kelly
  complex-permeability hysteresis approximation (CMaterialProp.cpp:156-196),
* a nested 1-D nonlinear finite-element sub-solve across the lamination
  thickness for AC laminated materials (CMaterialProp.cpp:351 ``LaminatedBH``),
* spline evaluation ``GetH``/``GetdHdB``/``GetBHProps``/``Get_dvB2``
  (CMaterialProp.cpp:461-534, 990-1060) and energy/coenergy integrals
  (CMaterialProp.cpp:537-697).

The spline *evaluation* also has a vectorized NumPy form (`bh_props_vec`)
evaluated as a branch-free gathered Hermite interpolation so an entire
mesh's worth of lookups runs as one batched op.
"""

from __future__ import annotations

import cmath
import math
from dataclasses import dataclass, field

import numpy as np

from ..constants import DEG, MU0, PI

#: Elements per skin depth for the laminated-BH sub-solve
#: (cfemm/libfemm/CMaterialProp.h ``ElementsPerSkinDepth``).
ELEMENTS_PER_SKIN_DEPTH = 10


def _tridiag_solve(lower, diag, upper, rhs):
    """Thomas algorithm for a (complex) tridiagonal system."""
    n = len(diag)
    d = list(diag)
    b = list(rhs)
    for k in range(n - 1):
        c = lower[k] / d[k]
        d[k + 1] -= upper[k] * c
        b[k + 1] -= b[k] * c
    x = [0j] * n
    x[n - 1] = b[n - 1] / d[n - 1]
    for k in range(n - 2, -1, -1):
        x[k] = (b[k] - upper[k] * x[k + 1]) / d[k]
    return x


@dataclass
class MagneticMaterial:
    """Material (block) property for magnetics problems.

    Field names track the ``<BeginBlock>`` record of the .fem format
    (cfemm/libfemm/CMaterialProp.cpp fromStream)."""

    name: str = "New Material"
    mu_x: float = 1.0
    mu_y: float = 1.0
    H_c: float = 0.0
    J: complex = 0.0          # applied current density [MA/m^2]
    Cduct: float = 0.0        # conductivity [MS/m]
    Lam_d: float = 0.0        # lamination thickness [mm]
    Theta_hn: float = 0.0     # hysteresis lag angle [deg]
    Theta_hx: float = 0.0
    Theta_hy: float = 0.0
    LamType: int = 0
    LamFill: float = 1.0
    NStrands: int = 0
    WireD: float = 0.0
    Bdata: list[float] = field(default_factory=list)
    Hdata: list[complex] = field(default_factory=list)

    # computed state (GetSlopes):
    slope: list[complex] = field(default_factory=list)
    MuMax: float = 0.0
    # frequency-dependent effective permeabilities for linear AC materials
    # (set by the harmonic solver, cfemm/fsolver/harmonic2d.cpp:176-215)
    mu_fdx: complex = 0.0
    mu_fdy: complex = 0.0
    # magnetostatic stored-energy offset for PM B-H curves (fpproc Nrg)
    Nrg: float = 0.0

    @property
    def BHpoints(self) -> int:
        return len(self.Bdata)

    # ------------------------------------------------------------------ #
    # slope fitting                                                      #
    # ------------------------------------------------------------------ #
    def get_slopes(self, omega: float = 0.0) -> None:
        """Fit cubic-Hermite slopes of H(B); doctor the curve for AC.

        Mirrors CMMaterialProp::GetSlopes (CMaterialProp.cpp:127): natural
        boundary conditions, monotonicity test on each Hermite segment via
        the quadratic-root check, and a 3-point moving-average smoothing
        pass when a segment is non-monotone.
        """
        if self.BHpoints == 0 or self.slope:
            return

        B = [float(b) for b in self.Bdata]
        H = [complex(h) for h in self.Hdata]
        n = len(B)

        # info for the first nonlinear iteration (CMaterialProp.cpp:149)
        self.mu_x = B[1] / (MU0 * abs(H[1]))
        self.mu_y = self.mu_x
        self.Theta_hx = self.Theta_hn
        self.Theta_hy = self.Theta_hn

        if omega != 0.0:
            # Effective sinusoidal-drive B-H curve (CMaterialProp.cpp:164-175)
            bn = [0.0] * n
            for i in range(1, n):
                hi = H[i].real
                acc = 0.0
                for k in range(1, i + 1):
                    hk, hk1 = H[k].real, H[k - 1].real
                    bk, bk1 = B[k], B[k - 1]
                    acc += (
                        4.0 * (hk * bk1 - hk1 * bk)
                        * (-math.cos(hk1 * PI / (2.0 * hi))
                           + math.cos(hk * PI / (2.0 * hi)))
                        + (bk - bk1) * ((hk1 - hk) * PI
                                        + hi * (-math.sin(hk1 * PI / hi)
                                                + math.sin(hk * PI / hi)))
                    ) / ((hk1 - hk) * PI)
                bn[i] = acc
            mumax = 0.0
            for i in range(1, n):
                B[i] = bn[i]
                munow = B[i] / H[i].real
                mumax = max(mumax, munow)
            # O'Kelly complex-permeability hysteresis kludge
            # (CMaterialProp.cpp:191-195)
            for i in range(1, n):
                H[i] *= cmath.exp(1j * B[i] * self.Theta_hn * DEG
                                  / (H[i].real * mumax))
            self.MuMax = mumax / MU0

        curve_ok = False
        processed_lams = False
        while not curve_ok:
            # natural-BC tridiagonal spline system (CMaterialProp.cpp:204-231)
            lo = [0j] * (n - 1)
            di = [0j] * n
            up = [0j] * (n - 1)
            rhs = [0j] * n
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

            # monotonicity check on the real part (CMaterialProp.cpp:237-273)
            curve_ok = True
            for i in range(1, n):
                d0, d1 = slopes[i - 1].real, slopes[i].real
                u0, u1 = H[i - 1].real, H[i].real
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
                    curve_ok = False

            if not curve_ok:
                # 3-point moving-average repair (CMaterialProp.cpp:280-289)
                bn = B[:]
                hn = H[:]
                for i in range(1, n - 1):
                    bn[i] = (B[i - 1] + B[i] + B[i + 1]) / 3.0
                    hn[i] = (H[i - 1] + H[i] + H[i + 1]) / 3.0
                B[1:n - 1] = bn[1:n - 1]
                H[1:n - 1] = hn[1:n - 1]
                continue

            if curve_ok and not processed_lams:
                self.Bdata = B
                self.Hdata = H
                self.slope = list(slopes)
                if omega > 0.0 and self.Lam_d != 0.0 and self.Cduct != 0.0:
                    # apparent curve from the 1-D lamination sub-solve
                    # (CMaterialProp.cpp:300-321)
                    for i in range(1, n):
                        mu = self.laminated_bh(omega, i)
                        bnew = abs(mu * H[i])
                        B[i] = bnew
                        H[i] = bnew / mu
                    curve_ok = False
                if self.LamType == 0 and self.LamFill != 1.0:
                    # fill-factor-adjusted apparent curve
                    # (CMaterialProp.cpp:324-338)
                    for i in range(1, n):
                        mu = self.LamFill * B[i] / H[i] + (1.0 - self.LamFill) * MU0
                        B[i] = abs(mu * H[i])
                        H[i] = B[i] / mu
                    curve_ok = False
                processed_lams = True
                if not curve_ok:
                    self.slope = []
                    continue

        self.Bdata = B
        self.Hdata = H
        self.slope = list(slopes)

    # ------------------------------------------------------------------ #
    # lamination sub-solve                                               #
    # ------------------------------------------------------------------ #
    def laminated_bh(self, w: float, i: int) -> complex:
        """Effective permeability of a lamination at B-H knot ``i``.

        Nested 1-D nonlinear FE solve across half the lamination thickness,
        discretized by skin depth (CMaterialProp.cpp:351-459)."""
        mu = self.Bdata[i] / self.Hdata[i]
        o = self.Cduct * 1e06
        d = (self.Lam_d * 0.001) / 2.0
        ds = math.sqrt(2.0 / (w * o * abs(mu)))
        n = ELEMENTS_PER_SKIN_DEPTH * int(math.ceil(d / ds))
        L = d / n

        x = np.zeros(n + 1, dtype=complex)
        iteration = 0
        relax = 1.0
        res = 0.0
        while True:
            m0 = np.zeros(n + 1, dtype=complex)
            m1 = np.zeros(n + 1, dtype=complex)
            b = np.zeros(n + 1, dtype=complex)
            for k in range(n):
                if iteration != 0:
                    Bk = abs(x[k + 1] - x[k]) / L
                    vi = self.get_dHdB(Bk)
                    vo = self.get_H(Bk) / Bk if Bk != 0 else vi
                else:
                    vo = 1.0 / mu
                    vi = 1.0 / mu
                Md = (vi + vo) / (2.0 * L) + 1j * w * o * L / 4.0
                Mo = -(vi + vo) / (2.0 * L) + 1j * w * o * L / 4.0
                m0[k] += Md
                m1[k] += Mo
                m0[k + 1] += Md
                Md2 = (vi - vo) / (2.0 * L)
                Mo2 = -(vi - vo) / (2.0 * L)
                b[k] += Md2 * x[k] + Mo2 * x[k + 1]
                b[k + 1] += Mo2 * x[k] + Md2 * x[k + 1]

            m1[0] = 0.0
            b[0] = 0.0
            b[n] += self.Hdata[i]

            # tridiagonal forward elimination / back substitution
            for k in range(n):
                c = m1[k] / m0[k]
                m0[k + 1] -= m1[k] * c
                b[k + 1] -= b[k] * c
            b[n] /= m0[n]
            for k in range(n - 1, -1, -1):
                b[k] = (b[k] - m1[k] * b[k + 1]) / m0[k]

            iteration += 1
            lastres = res
            res = abs(b[n] - x[n]) / d
            if res < 1e-08:
                x = b
                break
            if iteration > 5:
                if res > lastres and relax > 0.1:
                    relax /= 2.0
                else:
                    relax += 0.1 * (1.0 - relax)
            x = relax * b + (1.0 - relax) * x

        return x[n] / (self.Hdata[i] * d)

    # ------------------------------------------------------------------ #
    # spline evaluation                                                  #
    # ------------------------------------------------------------------ #
    def get_H(self, B) -> complex:
        """Hermite-interpolated H(|B|); see CMSolverMaterialProp::GetH
        (CMaterialProp.cpp:966-988 -- the solver flavor, which does not
        rescale by the direction of a complex argument)."""
        b = abs(B)
        if self.BHpoints == 0:
            return b / (self.mu_x * MU0)
        Bd, Hd, sl = self.Bdata, self.Hdata, self.slope
        if b > Bd[-1]:
            return Hd[-1] + sl[-1] * (b - Bd[-1])
        for i in range(self.BHpoints - 1):
            if Bd[i] <= b <= Bd[i + 1]:
                l = Bd[i + 1] - Bd[i]
                z = (b - Bd[i]) / l
                z2 = z * z
                return ((1.0 - 3.0 * z2 + 2.0 * z2 * z) * Hd[i]
                        + z * (1.0 - 2.0 * z + z2) * l * sl[i]
                        + z2 * (3.0 - 2.0 * z) * Hd[i + 1]
                        + z2 * (z - 1.0) * l * sl[i + 1])
        return 0.0

    def get_dHdB(self, B: float) -> complex:
        """dH/dB at |B| (CMaterialProp.cpp:461-486)."""
        b = abs(B)
        if self.BHpoints == 0:
            return b / (self.mu_x * MU0)
        Bd, Hd, sl = self.Bdata, self.Hdata, self.slope
        if b > Bd[-1]:
            return sl[-1]
        for i in range(self.BHpoints - 1):
            if Bd[i] <= b <= Bd[i + 1]:
                l = Bd[i + 1] - Bd[i]
                z = (b - Bd[i]) / l
                return (6.0 * z * (z - 1.0) * Hd[i] / l
                        + (1.0 - 4.0 * z + 3.0 * z * z) * sl[i]
                        + 6.0 * z * (1.0 - z) * Hd[i + 1] / l
                        + z * (3.0 * z - 2.0) * sl[i + 1])
        return 0.0

    def get_B(self, hc: float) -> float:
        """Invert the curve: B such that H(B)=hc (CMaterialProp.cpp:521)."""
        if self.BHpoints == 0:
            return MU0 * self.mu_x * hc
        b = 0.0
        while True:
            bo = b
            b = bo + (hc - self.get_H(bo).real) / self.get_dHdB(bo).real
            if abs(b - bo) <= 1e-08:
                return b

    def get_bh_props(self, B: float) -> tuple[complex, complex]:
        """Return (v, dv) = (H/B, d(H/B)/d(B^2)) used by the Newton loop
        (CMSolverMaterialProp::GetBHProps, CMaterialProp.cpp:1008-1060)."""
        b = abs(B)
        if self.BHpoints == 0:
            return complex(self.mu_x), 0.0
        if b == 0.0:
            return self.slope[0], 0.0
        h = self.get_H(b)
        dh = self.get_dHdB(b)
        v = h / b
        dv = 0.5 * (dh / (b * b) - h / (b ** 3))
        return v, dv

    def get_v(self, B: float) -> complex:
        if B == 0:
            return self.slope[0]
        return self.get_H(B) / B

    # ------------------------------------------------------------------ #
    # energy integrals                                                   #
    # ------------------------------------------------------------------ #
    def get_energy(self, x: float) -> float:
        """Magnetostatic energy density integral of H dB
        (CMaterialProp.cpp:537-588)."""
        b = abs(x)
        if self.BHpoints == 0:
            return 0.0
        nrg = 0.0
        Bd = self.Bdata
        for i in range(self.BHpoints - 1):
            b0, b1 = Bd[i], Bd[i + 1]
            h0, h1 = self.Hdata[i].real, self.Hdata[i + 1].real
            dh0, dh1 = self.slope[i].real, self.slope[i + 1].real
            if b0 <= b <= b1:
                l = b1 - b0
                z = (b - b0) / l
                z2 = z * z
                nrg += ((dh0 * l * l * (6.0 + z * (-8.0 + 3.0 * z)) * z2) / 12.0
                        + (h0 * l * z * (2.0 + (-2.0 + z) * z2)) / 2.0
                        - (h1 * l * (-2.0 + z) * z2 * z) / 2.0
                        + (dh1 * l * l * (-4.0 + 3.0 * z) * z2 * z) / 12.0)
                return nrg
            nrg += ((b0 - b1) * ((b0 - b1) * (dh0 - dh1) - 6.0 * (h0 + h1))) / 12.0
        h0 = self.Hdata[-1].real
        dh0 = self.slope[-1].real
        b0 = Bd[-1]
        nrg += ((b - b0) * (b * dh0 - b0 * dh0 + 2.0 * h0)) / 2.0
        return nrg

    def get_coenergy(self, b: float) -> float:
        return abs(b) * self.get_H(b).real - self.get_energy(b)

    # vectorized knot arrays for the device path -------------------------- #
    # incremental / frozen permeability (AC or DC about a DC offset) --- #
    def prepare_incremental(self, omega: float, prev_type: int) -> None:
        """Slope setup for previous-solution problems
        (fsolver.cpp:248-272): a first GetSlopes pass on the AC curve
        only to harvest MuMax, then the plain DC curve."""
        if self.BHpoints == 0 or self.slope:
            return
        saveB = list(self.Bdata)
        saveH = list(self.Hdata)
        self.get_slopes(omega)
        self.Bdata = saveB
        self.Hdata = saveH
        self.slope = []
        if prev_type == 1 and omega == 0.0:
            self.MuMax = 1.0
        self.get_slopes(0.0)

    def incremental_permeability_dc(self, B: float):
        """(muinc, murel) with lamination fill applied
        (CMaterialProp.cpp:916 IncrementalPermeability)."""
        muinc = 1.0 / (MU0 * self.get_dHdB(B).real)
        murel = 1.0 / (MU0 * self.get_v(B).real)
        if self.Lam_d == 0 or self.LamFill == 0:
            return muinc, murel
        return (muinc * self.LamFill + (1.0 - self.LamFill),
                murel * self.LamFill + (1.0 - self.LamFill))

    def incremental_permeability_ac(self, B: float, w: float):
        """Complex (mu1, mu2) about a DC offset for AC problems
        (CMaterialProp.cpp:853 incrementalPermeability)."""
        muinc = 1.0 / (MU0 * self.get_dHdB(B).real)
        murel = 1.0 / (MU0 * self.get_v(B).real)
        lag = self.Theta_hn * DEG
        if self.Lam_d == 0 or self.LamFill == 0:
            return (muinc * cmath.exp(-1j * lag * muinc / self.MuMax),
                    murel * cmath.exp(-1j * lag * murel / self.MuMax))
        f = self.LamFill
        out = []
        for mubase in (muinc, murel):
            mu = (mubase - (1.0 - f)) / f
            if self.Cduct != 0:
                half = cmath.exp(-1j * lag * mu / (2.0 * self.MuMax))
                ds = math.sqrt(2.0 / (0.4 * PI * w * self.Cduct * mu))
                K = half * (1 + 1j) * self.Lam_d * 0.001 / (2.0 * ds)
                out.append(f * mu * cmath.tanh(K) / K + (1.0 - f))
            else:
                out.append(mu * cmath.exp(-1j * lag * mu / self.MuMax) * f
                           + (1.0 - f))
        return tuple(out)

    def knot_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(Bdata, Re Hdata, Re slope) as float64 arrays for batched eval."""
        return (np.asarray(self.Bdata, dtype=np.float64),
                np.asarray([h.real for h in self.Hdata], dtype=np.float64),
                np.asarray([s.real for s in self.slope], dtype=np.float64))

    def knot_arrays_complex(self):
        """(Bdata, Hdata, slope) with complex H for the harmonic
        (doctored B-H curve) path."""
        return (np.asarray(self.Bdata, dtype=np.float64),
                np.asarray(self.Hdata, dtype=np.complex128),
                np.asarray(self.slope, dtype=np.complex128))


def bh_props_vec(B, Bdata, Hdata, slope):
    """Vectorized (v, dv) lookup over an array of |B| values.

    Branch-free batched form of ``MagneticMaterial.get_bh_props`` used by
    the host Newton loop (NumPy arrays).
    ``Bdata/Hdata/slope`` are the knot arrays of ONE material; mixing
    materials is handled by the caller via per-element gathers.
    """
    xp = np

    b = xp.abs(B)
    npts = Bdata.shape[0]
    idx = xp.clip(xp.searchsorted(Bdata, b, side="right") - 1, 0, npts - 2)
    B0 = Bdata[idx]
    B1 = Bdata[idx + 1]
    H0 = Hdata[idx]
    H1 = Hdata[idx + 1]
    s0 = slope[idx]
    s1 = slope[idx + 1]
    l = B1 - B0
    z = (b - B0) / l
    z2 = z * z
    h_in = ((1.0 - 3.0 * z2 + 2.0 * z2 * z) * H0
            + z * (1.0 - 2.0 * z + z2) * l * s0
            + z2 * (3.0 - 2.0 * z) * H1
            + z2 * (z - 1.0) * l * s1)
    dh_in = (6.0 * z * (z - 1.0) * H0 / l
             + (1.0 - 4.0 * z + 3.0 * z2) * s0
             + 6.0 * z * (1.0 - z) * H1 / l
             + z * (3.0 * z - 2.0) * s1)
    # extrapolation beyond the last knot
    h_ex = Hdata[npts - 1] + slope[npts - 1] * (b - Bdata[npts - 1])
    dh_ex = xp.full_like(b, slope[npts - 1])
    over = b > Bdata[npts - 1]
    h = xp.where(over, h_ex, h_in)
    dh = xp.where(over, dh_ex, dh_in)
    bsafe = xp.where(b == 0.0, 1.0, b)
    v = xp.where(b == 0.0, slope[0], h / bsafe)
    dv = xp.where(b == 0.0, 0.0,
                  0.5 * (dh / (bsafe * bsafe) - h / (bsafe ** 3)))
    return v, dv
