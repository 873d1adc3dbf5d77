"""Magnetics postprocessor (the reference FPProc re-built on arrays).

Computes element flux densities, air-gap-element harmonic decompositions
and gap force/torque integrals, block integrals (energy, losses, Lorentz
and weighted-stress-tensor forces), and point values. Reference anchors:

* element B: cfemm/fpproc/fpproc.cpp:2970 ``GetElementB``
* AGE harmonics: fpproc.cpp:1391-1615 (10-node quad B_r/B_t + sine/cosine
  convolution into brc/brs/btc/bts)
* gap integrals: fpproc.cpp:5418-5700
* block integrals: fpproc.cpp:3642 ``BlockIntegral`` (31 types)
* weighted stress tensor: the Henrotte mask field (makemask.cpp:48) is a
  Laplace solve on the same PCG stack, then forces integrate
  grad-mask-weighted stress over all elements (fpproc.cpp:3984-4074)

Everything runs as vectorized numpy reductions on the host; the one
device step is the mask's Laplace solve (``ops/solver.solve`` without
DOF coordinates: element-block Jacobi CG), on CUDA unless the
postprocessor is given another ``device``.
"""

from __future__ import annotations

import cmath
import math
from dataclasses import dataclass, field

import numpy as np

from ..constants import (FileType, LENGTH_TO_METERS, MU0, PI, ProblemType)
from ..geometry.problem import Problem
from ..materials.magnetic import MagneticMaterial
from ..mesh.meshdata import AirGapElement, MeshData
from ..models.magnetostatics import _eval_magdirs


@dataclass
class AgeHarmonics:
    nh: np.ndarray      # harmonic numbers
    brc: np.ndarray     # cosine/sine amplitudes of B_r, B_t (complex)
    brs: np.ndarray
    btc: np.ndarray
    bts: np.ndarray
    br: np.ndarray      # per-gap-element field samples
    bt: np.ndarray
    aco: complex        # mean A in the gap (periodic only)


class MagPostProcessor:
    """Postprocessor over an in-memory solution.

    ``A`` is the nodal potential in .ans units (Wb/m for planar problems);
    mesh coordinates are in problem units. ``label_case`` carries the
    per-label circuit results echoed into the solution file.
    """

    def __init__(self, problem: Problem, mesh: MeshData, A: np.ndarray,
                 label_case: np.ndarray | None = None,
                 Aprev: np.ndarray | None = None, device=None):
        from ..mesh.meshdata import resolve_default_labels
        resolve_default_labels(problem, mesh)
        self.problem = problem
        self.mesh = mesh
        self.A = np.asarray(A)
        self.Aprev = Aprev
        #: device of the mask solve (make_mask): CUDA when None
        self.device = device
        self.lc = LENGTH_TO_METERS[problem.LengthUnits]
        self.depth = 1.0 if problem.Depth == -1 else problem.Depth * self.lc
        self.frequency = problem.Frequency
        self.labels = [l for l in problem.labellist if not l.is_hole()]
        self.mats: list[MagneticMaterial] = problem.blockproplist
        for m in self.mats:
            if m.BHpoints > 0 and not m.slope:
                m.get_slopes(problem.Frequency * 2.0 * PI)
        if label_case is None:
            label_case = np.tile([1.0, 0.0], (len(self.labels), 1))
        self.label_case = label_case
        self.magdir = _eval_magdirs(problem, mesh, 1.0)

        self._geom()
        self.age = [self._age_harmonics(a) for a in mesh.airgaps]
        self._mask: np.ndarray | None = None
        self.smoothing = True    # mo_smooth toggle (fpproc Smooth flag)

    # ------------------------------------------------------------------ #
    def _geom(self):
        xy = self.mesh.nodes
        tris = self.mesh.elements
        v = xy[tris]
        x = v[:, :, 0]
        y = v[:, :, 1]
        nxt = np.roll(np.arange(3), -1)
        prv = np.roll(np.arange(3), 1)
        self.b = y[:, nxt] - y[:, prv]      # (T,3)
        self.c = x[:, prv] - x[:, nxt]
        self.da = (self.b[:, 0] * self.c[:, 1] - self.b[:, 1] * self.c[:, 0])
        self.ctr = v.mean(axis=1)           # problem units
        self.area_m2 = 0.5 * np.abs(self.da) * self.lc ** 2
        self.blk = np.array([self.labels[i].BlockType
                             for i in self.mesh.element_labels], np.int64)
        self._element_B()

    def _element_B(self):
        """GetElementB (planar + axisymmetric), fpproc.cpp:2970."""
        A = self.A[self.mesh.elements]      # (T,3)
        lc = self.lc
        if self.problem.ProblemType == ProblemType.PLANAR:
            self.B1 = (A * self.c).sum(axis=1) / (self.da * lc)
            self.B2 = -(A * self.b).sum(axis=1) / (self.da * lc)
            return
        # axisymmetric: construct mid-side values weighted by radius
        xy = self.mesh.nodes[self.mesh.elements]
        R = xy[:, :, 0]
        r = R.mean(axis=1)
        v0, v2, v4 = A[:, 0], A[:, 1], A[:, 2]

        def mid(Ra, Rb, va, vb):
            deg = (Ra < 1e-06) & (Rb < 1e-06)
            safe = np.where(deg, 1.0, 4.0 * (Ra + Rb))
            out = (Rb * (3.0 * va + vb) + Ra * (va + 3.0 * vb)) / safe
            return np.where(deg, (va + vb) / 2.0, out)

        v1 = mid(R[:, 0], R[:, 1], v0, v2)
        v3 = mid(R[:, 1], R[:, 2], v2, v4)
        v5 = mid(R[:, 2], R[:, 0], v4, v0)
        dp = (-v0 + v2 + 4.0 * v3 - 4.0 * v5) / 3.0
        dq = (-v0 - 4.0 * v1 + 4.0 * v3 + v4) / 3.0
        da = self.da * 2.0 * PI * r * lc * lc
        self.B1 = -(self.c[:, 1] * dp + self.c[:, 2] * dq) / da
        self.B2 = (self.b[:, 1] * dp + self.b[:, 2] * dq) / da

    # ------------------------------------------------------------------ #
    # air gap harmonics (fpproc.cpp:1391-1615)                            #
    # ------------------------------------------------------------------ #
    def _age_gather(self, age: AirGapElement):
        n = age.totalArcElements
        qn, qw = age.quad_nodes, age.quad_weights
        nn = np.zeros((n, 10), np.int64)
        ww = np.zeros((n, 10))
        for k in range(n):
            km1 = k - 1 if k - 1 >= 0 else n - 1
            kp2 = 1 if (k + 2) > n else k + 2
            nn[k] = [qn[km1][0], qn[k][0], qn[k][1], qn[k + 1][1],
                     qn[kp2][1], qn[km1][2], qn[k][2], qn[k][3],
                     qn[k + 1][3], qn[kp2][3]]
            ww[k] = [qw[km1][0], qw[k][0], qw[k][1], qw[k + 1][1],
                     qw[kp2][1], qw[km1][2], qw[k][2], qw[k][3],
                     qw[k + 1][3], qw[kp2][3]]
            if k == 0 and age.BdryFormat == 1:
                ww[k][0] = -ww[k][0]
                ww[k][5] = -ww[k][5]
            if k + 1 == n and age.BdryFormat == 1:
                ww[k][4] = -ww[k][4]
                ww[k][9] = -ww[k][9]
        return nn, ww

    def _age_harmonics(self, age: AirGapElement) -> AgeHarmonics:
        n = age.totalArcElements
        R = (age.ri + age.ro) / 2.0
        dr = age.ro - age.ri
        dt = (PI / 180.0) * age.totalArcLength / n
        ci = age.InnerShift
        co = age.OuterShift

        nn, ww = self._age_gather(age)
        a = self.A[nn] * ww                      # (n, 10)
        a0, a1, a2, a3, a4, a5, a6, a7, a8, a9 = [a[:, i] for i in range(10)]

        br = (-(ci * a1) - 2 * a2 + 2 * a3 + ci * (a2 + a3 - a4)
              - ci ** 3 * (a0 - 4 * a1 + 6 * a2 - 4 * a3 + a4)
              + ci ** 2 * (a0 - 5 * a1 + 9 * a2 - 7 * a3 + 2 * a4)
              - 2 * a7 + 2 * a8 + co * (-a6 + a7 + a8 - a9)
              - co ** 3 * (a5 - 4 * a6 + 6 * a7 - 4 * a8 + a9)
              + co ** 2 * (a5 - 5 * a6 + 9 * a7 - 7 * a8 + 2 * a9)) \
            / (4 * dt * R)
        bt = (ci * a1 + 2 * a2 + 2 * a3
              - ci ** 2 * (a0 - 3 * a1 + a2 + 3 * a3 - 2 * a4)
              + ci * (a2 - a3 - a4)
              + ci ** 3 * (a0 - 2 * a1 + 2 * a3 - a4)
              - co * a6 + (-2 + co) * (1 + co) * a7 - 2 * a8
              + co * (a8 + co * (a5 - 3 * a6 + 3 * a8 - 2 * a9) + a9
                      + co ** 2 * (-a5 + 2 * a6 - 2 * a8 + a9))) / (4 * dr)

        if age.BdryFormat == 0:
            nn_count = n // 2 + 1
            m = int(round(360.0 / age.totalArcLength))
            nh = m * np.arange(nn_count)
            ac = (2 * a2 + 2 * a3 + 2 * a7 + 2 * a8 + a1 * ci
                  + (a2 - a3 - a4) * ci
                  - (a0 - 3 * a1 + a2 + 3 * a3 - 2 * a4) * ci ** 2
                  + (a0 - 2 * a1 + 2 * a3 - a4) * ci ** 3
                  + (a6 + a7 - a8 - a9) * co
                  - (a5 - 3 * a6 + a7 + 3 * a8 - 2 * a9) * co ** 2
                  + (a5 - 2 * a6 + 2 * a8 - a9) * co ** 3) / 8.0
            aco = complex(ac.mean())
        else:
            nn_count = (n + 1) // 2
            m = int(round(180.0 / age.totalArcLength))
            nh = m * (2 * np.arange(nn_count) + 1)
            aco = 0.0

        tta = (np.arange(n) + 0.5) * dt          # (n,)
        angles = nh[:, None] * tta[None, :]      # (H, n)
        cos_m = np.cos(angles)
        sin_m = np.sin(angles)
        brc = cos_m @ br
        brs = sin_m @ br
        btc = cos_m @ bt
        bts = sin_m @ bt
        norm = np.full(nn_count, n / 2.0)
        for j in range(nn_count):
            if nh[j] == 0 or (j == nn_count - 1 and age.BdryFormat == 0
                              and n % 2 == 0):
                norm[j] = n
        brc /= norm
        brs /= norm
        btc /= norm
        bts /= norm
        return AgeHarmonics(nh=nh, brc=brc, brs=brs, btc=btc, bts=bts,
                            br=br, bt=bt, aco=aco)

    def _age_index(self, name: str) -> int:
        for i, a in enumerate(self.mesh.airgaps):
            if a.name == name:
                return i
        raise KeyError(f"no air gap boundary named {name!r}")

    # gap integrals (fpproc.cpp:5418-5700) ----------------------------- #
    def gap_dc_torque(self, name: str) -> float:
        i = self._age_index(name)
        h = self.age[i]
        R = (self.mesh.airgaps[i].ri + self.mesh.airgaps[i].ro) / 2.0
        tq = float(np.sum(np.real(h.brc * np.conj(h.btc)
                                  + h.brs * np.conj(h.bts))))
        tq *= PI * R * R * self.depth / MU0
        if self.frequency != 0:
            tq /= 2.0
        return tq

    def gap_2x_torque(self, name: str) -> complex:
        i = self._age_index(name)
        h = self.age[i]
        R = (self.mesh.airgaps[i].ri + self.mesh.airgaps[i].ro) / 2.0
        if self.frequency == 0:
            return 0.0
        tq = np.sum(h.brc * h.btc + h.brs * h.bts)
        return complex(tq * PI * R * R * self.depth / (2.0 * MU0))

    def gap_dc_force(self, name: str) -> tuple[float, float]:
        i = self._age_index(name)
        age = self.mesh.airgaps[i]
        h = self.age[i]
        R = (age.ri + age.ro) / 2.0
        fx = fy = 0.0
        if round(age.totalArcLength) == 360:
            for k in range(1, len(h.nh)):
                dfx = ((h.brs[k] + h.btc[k]) * np.conj(h.brs[k - 1] - h.btc[k - 1])
                       + (h.brs[k - 1] - h.btc[k - 1]) * np.conj(h.brs[k] + h.btc[k])
                       + (h.brc[k] - h.bts[k]) * np.conj(h.brc[k - 1] + h.bts[k - 1])
                       + (h.brc[k - 1] + h.bts[k - 1]) * np.conj(h.brc[k] - h.bts[k]))
                dfy = ((-h.brc[k] + h.bts[k]) * np.conj(h.brs[k - 1] - h.btc[k - 1])
                       + (h.brc[k - 1] + h.bts[k - 1]) * np.conj(h.brs[k] + h.btc[k])
                       + (h.brs[k] + h.btc[k]) * np.conj(h.brc[k - 1] + h.bts[k - 1])
                       + (-h.brs[k - 1] + h.btc[k - 1]) * np.conj(h.brc[k] - h.bts[k]))
                fx += dfx.real
                fy += dfy.real
            fx *= self.depth * PI * R / (4.0 * MU0)
            fy *= self.depth * PI * R / (4.0 * MU0)
            if self.frequency != 0:
                fx /= 2.0
                fy /= 2.0
        return fx, fy

    def gap_2x_force(self, name: str) -> tuple[complex, complex]:
        """Double-frequency force components (fpproc.cpp
        gap2XForceIntegral:5533)."""
        i = self._age_index(name)
        age = self.mesh.airgaps[i]
        h = self.age[i]
        R = (age.ri + age.ro) / 2.0
        fx = fy = 0.0 + 0j
        if round(age.totalArcLength) == 360 and self.frequency != 0:
            for k in range(1, len(h.nh)):
                fx += ((h.brs[k - 1] - h.btc[k - 1])
                       * (h.brs[k] + h.btc[k])
                       + (h.brc[k - 1] + h.bts[k - 1])
                       * (h.brc[k] - h.bts[k]))
                fy += ((h.brs[k] + h.btc[k])
                       * (h.brc[k - 1] + h.bts[k - 1])
                       - (h.brs[k - 1] - h.btc[k - 1])
                       * (h.brc[k] - h.bts[k]))
            fx *= self.depth * PI * R / (4.0 * MU0)
            fy *= self.depth * PI * R / (4.0 * MU0)
        return fx, fy

    def _age_prev(self, i: int) -> "AgeHarmonics":
        """Harmonics of the previous (DC offset) solution for the
        incremental gap integrals (fpproc.cpp:1559-1605 brcPrev...)."""
        if self.Aprev is None:
            raise ValueError("incremental gap integral needs a previous "
                             "solution (problem.PrevSoln)")
        if not hasattr(self, "_age_prev_cache"):
            saved = self.A
            self.A = np.asarray(self.Aprev)
            try:
                self._age_prev_cache = [self._age_harmonics(a)
                                        for a in self.mesh.airgaps]
            finally:
                self.A = saved
        return self._age_prev_cache[i]

    def gap_incremental_torque(self, name: str) -> complex:
        """fpproc.cpp gapIncrementalTorqueIntegral:5577 -- cross terms
        between the incremental AC harmonics and the frozen DC ones."""
        i = self._age_index(name)
        age = self.mesh.airgaps[i]
        h = self.age[i]
        hp = self._age_prev(i)
        R = (age.ri + age.ro) / 2.0
        tq = np.sum(hp.btc * h.brc + hp.brc * h.btc
                    + hp.bts * h.brs + hp.brs * h.bts)
        return complex(tq * PI * R * R * self.depth / MU0)

    def gap_incremental_force(self, name: str) -> tuple[complex, complex]:
        """fpproc.cpp gapIncrementalForceIntegral:5608."""
        i = self._age_index(name)
        age = self.mesh.airgaps[i]
        h = self.age[i]
        hp = self._age_prev(i)
        R = (age.ri + age.ro) / 2.0
        fx = fy = 0.0 + 0j
        if round(age.totalArcLength) == 360 and self.frequency != 0:
            for k in range(1, len(h.nh)):
                fx += ((h.brs[k] + h.btc[k])
                       * (hp.brs[k - 1] - hp.btc[k - 1])
                       + (h.brs[k - 1] - h.btc[k - 1])
                       * (hp.brs[k] + hp.btc[k])
                       + (h.brc[k] - h.bts[k])
                       * (hp.brc[k - 1] + hp.bts[k - 1])
                       + (h.brc[k - 1] + h.bts[k - 1])
                       * (hp.brc[k] - hp.bts[k]))
                fy += ((hp.brs[k] + hp.btc[k])
                       * (h.brc[k - 1] + h.bts[k - 1])
                       - (hp.brs[k - 1] - hp.btc[k - 1])
                       * (h.brc[k] - h.bts[k])
                       + (h.brs[k] + h.btc[k])
                       * (hp.brc[k - 1] + hp.bts[k - 1])
                       - (h.brs[k - 1] - h.btc[k - 1])
                       * (hp.brc[k] - hp.bts[k]))
            fx *= self.depth * PI * R / (2.0 * MU0)
            fy *= self.depth * PI * R / (2.0 * MU0)
        return fx, fy

    def gap_time_avg_stored_energy(self, name: str) -> float:
        """fpproc.cpp gapTimeAvgStoredEnergyIntegral:5652 -- note the
        n=0 harmonic contributes only 2*btc^2 (the mean radial field is
        excluded) and the products are NOT conjugated (b*b, Re at the
        end), matching the reference bit for bit."""
        i = self._age_index(name)
        age = self.mesh.airgaps[i]
        h = self.age[i]
        R = (age.ri + age.ro) / 2.0
        dr = age.ro - age.ri
        w = 0.0 + 0j
        for k in range(len(h.nh)):
            if h.nh[k] != 0:
                w += (h.brs[k] * h.brs[k] + h.brc[k] * h.brc[k]
                      + h.bts[k] * h.bts[k] + h.btc[k] * h.btc[k]) * dr
            else:
                w += 2.0 * dr * h.btc[k] * h.btc[k]
        e = w.real * PI * R * self.depth / (2.0 * MU0)
        if self.frequency != 0:
            e /= 2.0
        return e

    def gap_integral(self, name: str, inttype: int):
        """mo_gapintegral dispatch (LuaMagneticsCommands.cpp
        luaGapIntegral:964): 0 DC torque, 1 DC force (fx, fy), 2
        time-average stored energy, 3 2x torque, 4 2x force, 5
        incremental torque, 6 incremental force."""
        if inttype == 0:
            return self.gap_dc_torque(name)
        if inttype == 1:
            return self.gap_dc_force(name)
        if inttype == 2:
            return self.gap_time_avg_stored_energy(name)
        if inttype == 3:
            return self.gap_2x_torque(name)
        if inttype == 4:
            return self.gap_2x_force(name)
        if inttype == 5:
            return self.gap_incremental_torque(name)
        if inttype == 6:
            return self.gap_incremental_force(name)
        raise ValueError(f"invalid gap integral type {inttype}")

    # ------------------------------------------------------------------ #
    # current density (GetJA, fpproc.cpp)                                #
    # ------------------------------------------------------------------ #
    def element_JA(self):
        """Per-element nodal J (MA/m^2) and A arrays, (T,3) each
        (cached)."""
        if getattr(self, "_ja", None) is not None:
            return self._ja
        T = self.mesh.num_elements
        tris = self.mesh.elements
        if self.problem.ProblemType == ProblemType.PLANAR:
            Aface = self.A[tris].astype(complex)
        else:
            rn = self.mesh.nodes[tris][:, :, 0] * self.lc
            with np.errstate(divide="ignore", invalid="ignore"):
                Aface = np.where(np.abs(rn / self.lc) < 1e-06, 0.0,
                                 self.A[tris] / (2.0 * PI * rn))
        J = np.zeros((T, 3), complex)
        Javg = np.zeros(T, complex)
        lbl = self.mesh.element_labels
        planar = self.problem.ProblemType == ProblemType.PLANAR
        if not planar:
            rnod = self.mesh.nodes[tris][:, :, 0] * self.lc   # (T,3) m
            rctr = self.ctr[:, 0] * self.lc                   # (T,) m
        for t in range(T):
            mat = self.mats[self.blk[t]]
            Jt = mat.J
            c = mat.Cduct
            if mat.Lam_d != 0 and mat.LamType == 0:
                c = 0.0
            lab = self.labels[lbl[t]]
            if abs(lab.Turns) > 1 or mat.LamType > 2:
                c = 0.0
            row = np.full(3, Jt, complex)
            avg = complex(Jt)
            if self.frequency != 0:
                eddy = 1j * self.frequency * 2.0 * PI * c * Aface[t]
                row = row - eddy
                avg = avg - eddy.sum() / 3.0
            case, value = self.label_case[lbl[t]]
            if lab.InCircuit >= 0:
                if case == 0:
                    if planar:
                        row = row - c * value
                        avg = avg - c * value
                    else:
                        # axisymmetric: dV divides by the node radius
                        # (on-axis nodes take the centroid radius) and
                        # the average by the centroid radius
                        # (GetJA, fpproc.cpp:1852-1866)
                        rn = np.where(np.abs(rnod[t] / self.lc) < 1e-06,
                                      rctr[t], rnod[t])
                        row = row - c * value / rn
                        avg = avg - c * value / rctr[t]
                else:
                    row = row + value
                    avg = avg + value
            J[t] = row
            Javg[t] = avg
        self._ja = (J, Aface)
        self._javg = Javg
        return J, Aface

    # ------------------------------------------------------------------ #
    # weighted stress tensor mask (makemask.cpp:48)                      #
    # ------------------------------------------------------------------ #
    def make_mask(self, selected_labels: set[int]) -> np.ndarray:
        """Solve the Laplace 'mask' problem: 1 on nodes of the selected
        region(s), 0 on nodes attached only to far air, harmonic in
        between; used by the Henrotte weighted-stress-tensor force. The
        solve runs on ``self.device`` (CUDA when None)."""
        from ..ops import assembly as dev_assembly
        from ..ops import solver as dev_solver

        mesh = self.mesh
        N = mesh.num_nodes
        fixed, vals = self._mask_bcs(selected_labels)
        tris = np.asarray(mesh.elements)
        geom = dev_assembly.tri_geometry(np.asarray(mesh.nodes), tris)
        Mx, My, _ = dev_assembly.curl_matrices(geom)
        Me = Mx + My
        blocks = [dev_solver.ElementBlock(
            idx=tris, sign=np.ones(tris.shape), mat=-Me)]
        x, _, _ = dev_solver.solve(blocks, np.zeros(N), fixed, vals, 1e-08,
                                   device=self.device)
        return np.asarray(x)

    def _mask_bcs(self, selected_labels):
        """The mask's Dirichlet set (makemask.cpp:48-140): nodes on
        selected blocks are 1; nodes on non-air, non-selected blocks
        ("collars") and on the exterior boundary are 0 unless already 1;
        air nodes float. The JAX package's per-element loops, vectorised
        (same sets, same values)."""
        mesh = self.mesh
        N = mesh.num_nodes
        tris = np.asarray(mesh.elements)
        lab = np.asarray(mesh.element_labels)
        is_air = np.array([
            self.mats[l.BlockType].isAir() if hasattr(self.mats[l.BlockType], "isAir")
            else _mat_is_air(self.mats[l.BlockType])
            for l in self.labels], bool)
        sel = np.zeros(len(self.labels), bool)
        for k in selected_labels:
            sel[k] = True
        fixed = np.zeros(N, bool)
        vals = np.zeros(N)
        fixed[tris[sel[lab]].ravel()] = True
        vals[fixed] = 1.0
        one = fixed.copy()
        collar = tris[~sel[lab] & ~is_air[lab]].ravel()
        # exterior boundary: edges on one element only, each edge keyed
        # by (low node) * N + (high node)
        a = np.concatenate([tris[:, 0], tris[:, 1], tris[:, 2]]).astype(
            np.int64)
        b = np.concatenate([tris[:, 1], tris[:, 2], tris[:, 0]]).astype(
            np.int64)
        key = np.minimum(a, b) * N + np.maximum(a, b)
        uniq, cnt = np.unique(key, return_counts=True)
        outer = uniq[cnt == 1]
        zero = np.concatenate([collar, outer // N, outer % N])
        fixed[zero[~one[zero]]] = True
        return fixed, vals

    def _henrotte_vector(self, mask: np.ndarray):
        """grad of the mask per element (fpproc.cpp:3614)."""
        msk = mask[self.mesh.elements]
        gx = -(msk * self.b).sum(axis=1) / (self.da * self.lc)
        gy = -(msk * self.c).sum(axis=1) / (self.da * self.lc)
        return gx, gy

    # ------------------------------------------------------------------ #
    # block integrals (fpproc.cpp:3642)                                  #
    # ------------------------------------------------------------------ #
    def block_integral(self, inttype: int, selected_labels: set[int]):
        sel_el = np.isin(self.mesh.element_labels, list(selected_labels))
        a = self.area_m2
        B1, B2 = self.B1.astype(complex), self.B2.astype(complex)
        planar = self.problem.ProblemType == ProblemType.PLANAR
        depth = self.depth
        if planar:
            Rc = None
            vol = a * depth
        else:
            r3 = self.mesh.nodes[self.mesh.elements][:, :, 0] * self.lc
            Rm = r3.mean(axis=1)
            vol = a * 2.0 * PI * Rm

        if inttype == 6:
            return (self.block_integral(3, selected_labels)
                    + self.block_integral(4, selected_labels))

        if inttype == 5:   # cross-section area
            return complex(a[sel_el].sum())
        if inttype == 10:  # volume
            return complex(vol[sel_el].sum())
        if inttype == 8:
            return complex((vol[sel_el] * B1[sel_el]).sum())
        if inttype == 9:
            return complex((vol[sel_el] * B2[sel_el]).sum())
        if inttype == 25:  # centroid
            asum = a[sel_el].sum()
            cx = (self.ctr[sel_el, 0] * a[sel_el]).sum() / asum
            cy = (self.ctr[sel_el, 1] * a[sel_el]).sum() / asum
            return complex(cx, cy)
        if inttype == 24:  # moment of inertia about z (or r=0)
            if planar:
                U = self.mesh.nodes[self.mesh.elements][:, :, 0] * self.lc
                V = self.mesh.nodes[self.mesh.elements][:, :, 1] * self.lc
                y = (U ** 2).sum(axis=1) + U[:, 0] * U[:, 1] \
                    + U[:, 0] * U[:, 2] + U[:, 1] * U[:, 2]
                y = y + (V ** 2).sum(axis=1) + V[:, 0] * V[:, 1] \
                    + V[:, 0] * V[:, 2] + V[:, 1] * V[:, 2]
                return complex((y[sel_el] * a[sel_el] * depth / 6.0).sum())
            # axisymmetric: moment of inertia about r=0 (fpproc.cpp:3928)
            r24 = self.mesh.nodes[self.mesh.elements][:, :, 0] * self.lc
            y = self._axi_int(a, r24.astype(complex), r24.astype(complex),
                              r24)
            return complex(y[sel_el].sum())

        J, Aface = self.element_JA()
        Javg = self._javg  # GetJA's average (axi dV uses centroid r)

        r3m = self.mesh.nodes[self.mesh.elements][:, :, 0] * self.lc
        if inttype == 0:   # A.J (J in A/m^2 per GetJA, hence the 1e6)
            return self._aj_integral(sel_el)
        if inttype == 1:   # integral of A
            if planar:
                y = a * depth * Aface.mean(axis=1)
            else:
                y = self._axi_int(a, Aface, np.ones_like(Aface), r3m)
            return complex(y[sel_el].sum())
        if inttype == 3:   # hysteresis + laminated eddy losses (AC)
            if self.frequency == 0:
                return 0.0 + 0j
            total = 0.0 + 0j
            for t in np.nonzero(sel_el)[0]:
                mu1, mu2 = self._get_mu_complex(t)
                H1 = B1[t] / (mu1 * MU0)
                H2 = B2[t] / (mu2 * MU0)
                total += vol[t] * PI * self.frequency * (
                    H1 * np.conj(B1[t]) + H2 * np.conj(B2[t])).imag
            return complex(total)
        if inttype == 7:   # total current (Javg MA/m^2 -> A/m^2)
            return complex((a[sel_el] * Javg[sel_el]).sum()) * 1e6
        if inttype == 2 or inttype == 17:  # stored energy / coenergy
            total = 0.0
            idx = np.where(sel_el)[0]
            for t in idx:
                mat = self.mats[self.blk[t]]
                b1 = self.B1[t]
                b2 = self.B2[t]
                af = vol[t]
                if self.frequency == 0:
                    if inttype == 17:
                        y = _do_coenergy(mat, b1.real, b2.real)
                    elif mat.H_c != 0:
                        y = _energy_pm(mat, b1.real, b2.real,
                                       self.magdir[t])
                    else:
                        y = _do_energy(mat, b1.real, b2.real)
                    if mat.LamType > 2:
                        # DC local stored energy of a wound winding:
                        # Im(o) stores the turn-distribution inductance
                        # factor (fpproc.cpp:3813-3818/3906-3911)
                        u = self._label_o(
                            self.mesh.element_labels[t]).imag
                        Jv = Javg[t] * 1e6     # GetJA returns A/m^2
                        y += (Jv * Jv).real * u / 2.0
                elif mat.LamType > 2:
                    # wound region subject to prox and skin effects
                    # (fpproc.cpp:3770-3778): field energy against the
                    # label's effective complex mu plus the local term
                    # from the apparent conductivity
                    lbl_t = self.mesh.element_labels[t]
                    mu1c, _ = self._get_mu_complex(t)
                    mu = MU0 * mu1c * self._aecf(t)   # label-level mu
                    u = (1.0 / self._label_o(lbl_t)).imag \
                        / (2.0e6 * PI * self.frequency)
                    Jv = Javg[t] * 1e6         # GetJA returns A/m^2
                    y = ((b1 * np.conj(b1) + b2 * np.conj(b2)).real
                         * (1.0 / mu).real / 4.0
                         + (Jv * np.conj(Jv)).real * u / 4.0)
                else:
                    # complex DoEnergy (CMaterialProp.cpp:680-691):
                    # Re(h1 conj(b1) + h2 conj(b2))/4 with complex mu
                    # (energy == coenergy in the AC case).
                    # material-level mu (undo the AECF division that
                    # _get_mu_complex applies; BlockIntegral applies
                    # AECF exactly once, below)
                    aecf = self._aecf(t)
                    mu1, mu2 = self._get_mu_complex(t)
                    h1 = b1 / (mu1 * aecf * MU0)
                    h2 = b2 / (mu2 * aecf * MU0)
                    y = (h1 * np.conj(b1) + h2 * np.conj(b2)).real / 4.0
                total += af * y * self._aecf(t)
            return complex(total)
        if inttype == 4:   # resistive losses
            total = 0.0
            idx = np.where(sel_el)[0]
            for t in idx:
                mat = self.mats[self.blk[t]]
                if mat.Cduct == 0 or (mat.Lam_d != 0 and mat.LamType == 0):
                    continue
                # sig = 1e6 / Re(1/o) with the label's apparent
                # conductivity (fpproc.cpp:3842): wound regions see the
                # proximity/skin-corrected value, plain regions reduce
                # to Cduct * 1e6
                o_lbl = self._label_o(self.mesh.element_labels[t])
                re_inv = (1.0 / o_lbl).real
                if re_inv == 0.0:
                    continue
                sig = 1e06 / re_inv
                if planar:
                    V = np.conj(J[t]) / sig
                    z0 = 2 * J[t][0] + J[t][1] + J[t][2]
                    z1 = J[t][0] + 2 * J[t][1] + J[t][2]
                    z2 = J[t][0] + J[t][1] + 2 * J[t][2]
                    y = a[t] * (V[0] * z0 + V[1] * z1 + V[2] * z2) / 12.0 \
                        * depth * 1e12
                else:
                    # axisymmetric: J constant over the element
                    Rm = r3m[t].mean()
                    y = 2.0 * PI * Rm * a[t] \
                        * Javg[t] * np.conj(Javg[t]) / sig * 1e12
                if self.frequency != 0:
                    y /= 2.0
                total += y.real
            return complex(total)
        if inttype in (11, 12, 15):  # Lorentz force / torque (SS)
            # J in MA/m^2 -> 1e6 factor folds into the integral
            total = 0.0
            idx = np.where(sel_el)[0]
            for t in idx:
                if inttype == 11:
                    y = -(B2[t].real * Javg[t].real
                          + B2[t].imag * Javg[t].imag)
                    if not planar:
                        y = 0.0
                    else:
                        y *= depth
                    if self.frequency != 0:
                        y *= 0.5
                    total += a[t] * y * 1e06
                elif inttype == 12:
                    U = np.ones((1, 3))
                    V = np.real(B1[t] * np.conj(J[t]))
                    z0 = 2 * U[0][0] + U[0][1] + U[0][2]
                    y = a[t] * (V * np.array([4.0, 4.0, 4.0])).sum() / 12.0
                    y *= depth
                    if self.frequency != 0:
                        y *= 0.5
                    total += y * 1e06
                else:  # 15 torque
                    cx, cy = self.ctr[t] * self.lc
                    y = cy * (B2[t].real * Javg[t].real
                              + B2[t].imag * Javg[t].imag) \
                        + cx * (B1[t].real * Javg[t].real
                                + B1[t].imag * Javg[t].imag)
                    if self.frequency != 0:
                        y *= 0.5
                    total += a[t] * y * depth * 1e06
            return complex(total)
        if inttype in (13, 14, 16):
            # 2x (double-frequency) Lorentz force/torque components
            # (fpproc.cpp case 13/14/16); J in MA/m^2 -> 1e6
            if self.frequency == 0:
                return 0.0 + 0j
            total = 0.0 + 0j
            for t in np.nonzero(sel_el)[0]:
                Jc = Javg[t]
                if inttype == 13 and planar:
                    y = -(B2[t].real * Jc.real - B2[t].imag * Jc.imag) \
                        - 1j * (B2[t].real * Jc.imag + B2[t].imag * Jc.real)
                    total += 0.5 * a[t] * y * depth * 1e6
                elif inttype == 14:
                    y = (B1[t].real * Jc.real - B1[t].imag * Jc.imag) \
                        + 1j * (B1[t].real * Jc.imag + B1[t].imag * Jc.real)
                    if not planar:
                        Rm = r3m[t].mean()
                        y = -y * 2.0 * PI * Rm
                    else:
                        y = y * depth
                    total += 0.5 * a[t] * y * 1e6
                elif inttype == 16 and planar:
                    cx, cy = self.ctr[t] * self.lc
                    yx = (B1[t].real * Jc.real - B1[t].imag * Jc.imag) \
                        + 1j * (B1[t].real * Jc.imag + B1[t].imag * Jc.real)
                    yy = (B2[t].real * Jc.real - B2[t].imag * Jc.imag) \
                        + 1j * (B2[t].real * Jc.imag + B2[t].imag * Jc.real)
                    total += 0.5 * a[t] * (cx * yx + cy * yy) * depth * 1e6
            return complex(total)
        if inttype in (20, 21, 23):
            # 2x weighted-stress-tensor (Henrotte) components, planar
            if self._mask is None:
                self._mask = self.make_mask(selected_labels)
            gx, gy = self._henrotte_vector(self._mask)
            aecf = np.array([self._aecf(t)
                             for t in range(self.mesh.num_elements)])
            F1 = ((B1 * B1 - B2 * B2) * gx
                  + 2.0 * B1 * B2 * gy) / (4.0 * MU0)
            F2 = ((B2 * B2 - B1 * B1) * gy
                  + 2.0 * B1 * B2 * gx) / (4.0 * MU0)
            w = vol * aecf
            if inttype == 20:
                return complex((w * F1).sum())
            if inttype == 21:
                return complex((w * F2).sum())
            cx = self.ctr[:, 0] * self.lc
            cy = self.ctr[:, 1] * self.lc
            return complex((w * (cx * F2 - cy * F1)).sum())
        if inttype in (18, 19, 22):
            # Henrotte (weighted stress tensor) force/torque, SS part --
            # integrates over ALL elements; requires make_mask() first
            if self._mask is None:
                self._mask = self.make_mask(selected_labels)
            gx, gy = self._henrotte_vector(self._mask)
            F1 = ((B1 * np.conj(B1) - B2 * np.conj(B2)).real * gx
                  + 2.0 * np.real(B1 * np.conj(B2)) * gy) / (2.0 * MU0)
            F2 = ((B2 * np.conj(B2) - B1 * np.conj(B1)).real * gy
                  + 2.0 * np.real(B1 * np.conj(B2)) * gx) / (2.0 * MU0)
            aecf = np.array([self._aecf(t)
                             for t in range(self.mesh.num_elements)])
            w = vol * aecf
            if self.frequency != 0:
                w = w / 2.0
            if inttype == 18:
                return complex((w * F1).sum())
            if inttype == 19:
                return complex((w * F2).sum())
            cx = self.ctr[:, 0] * self.lc
            cy = self.ctr[:, 1] * self.lc
            return complex((w * (cx * F2 - cy * F1)).sum())
        raise NotImplementedError(f"block integral {inttype}")

    def _label_o(self, lbl: int) -> complex:
        """Apparent (effective) complex conductivity of a label in MS/m
        (FPProc::GetFillFactor, fpproc.cpp:4746-4891). Non-wound labels
        return the material Cduct; wound (LamType>2) labels get the
        frequency-dependent proximity/skin fit, whose imaginary part
        carries the winding's local stored energy (at DC the imaginary
        part stores the energy factor directly)."""
        cache = getattr(self, "_lblo", None)
        if cache is None:
            cache = self._lblo = {}
        if lbl in cache:
            return cache[lbl]
        lab = self.labels[lbl]
        mat = self.mats[lab.BlockType]
        out = complex(mat.Cduct)
        f = self.frequency
        if mat.LamType >= 3:
            sel = self.mesh.element_labels == lbl
            atot = self.area_m2[sel].sum()
            if atot > 0:
                wiretype = mat.LamType - 3
                if wiretype == 3:            # rectangular wire
                    W = 2.0 * PI * f
                    d = mat.WireD * 0.001
                    ff = abs(d * d * lab.Turns / atot)
                    dd = d / math.sqrt(ff)   # foil pitch
                    fill = d / dd
                    o = mat.Cduct * (d / dd) * 1e6
                    if f == 0:
                        out = mat.Cduct * ff + 1j * (dd - d) * dd * MU0 / 6.0
                    elif o != 0:
                        k = cmath.sqrt(1j * W * o * MU0) * d / 2.0
                        ufd = MU0 * cmath.tanh(k) / k
                        ueff = fill * ufd + (1.0 - fill) * MU0
                        out = 1e-6 / (MU0 / (fill * o * ufd)
                                      + 1j * dd * dd * (1.0 - fill)
                                      * MU0 * W / 4.0
                                      - 1j * dd * dd * ueff * W / 12.0)
                    else:
                        # non-physical zero-conductivity winding: an
                        # imaginary conductivity holding the locally
                        # stored energy of the turn distribution
                        out = 6.0 / (1j * W * (dd - d) * dd * MU0)
                else:                        # round wires
                    if wiretype == 1:
                        R = mat.WireD * 0.0005 * math.sqrt(mat.NStrands)
                        awire = PI * R * R * lab.Turns
                    else:
                        R = mat.WireD * 0.0005
                        awire = PI * R * R * mat.NStrands * lab.Turns
                    fill = abs(awire / atot)
                    w = 2.0 * PI * f
                    o = mat.Cduct * 1e6
                    W = w * o * MU0 * R * R / 2.0
                    dd = 1.6494541661869013 * R / math.sqrt(fill)
                    lg = math.log(1.5299240194394943 / math.sqrt(fill))
                    if f == 0:
                        out = (mat.Cduct * fill
                               + 0.5j * MU0 * R * R * lg / fill
                               - (1j / 12.0) * MU0 * dd * dd)
                    elif mat.Cduct == 0:
                        out = 1.0 / (0.5j * w * MU0 * R * R * lg / fill
                                     - (1j / 12.0) * MU0 * dd * dd)
                    else:
                        c1 = 0.7756067409818643 + fill * (
                            0.6873854335408803 + fill * (
                                0.06841584481674128
                                - 0.07143732702512284 * fill))
                        c2 = 1.5 * fill / c1
                        sq = cmath.sqrt(c1 * 1j * W)
                        ufd = c2 * cmath.tanh(sq) / sq + (1.0 - c2)
                        c3 = 0.8824642871525136 + fill * (
                            -0.008605512994838827 + fill * (
                                0.7223208744682307
                                - 0.2157183942377177 * fill))
                        c4 = lg - c3 / 3.0
                        s3 = cmath.sqrt(1j * c3 * W)
                        ofd = o * fill / (1j * c4 * W
                                          + s3 / cmath.tanh(s3))
                        out = 1e-6 / (1.0 / ofd
                                      - 1j * w * ufd * MU0 * dd * dd
                                      / 12.0)
        cache[lbl] = out
        return out

    def _get_mu_complex(self, t: int):
        """AC relative permeability (CMaterialProp::GetMu complex,
        CMaterialProp.cpp:722; proximity regions take the label's
        effective mu)."""
        from ..models.harmonic import _effective_mu, _proximity_mu
        mat = self.mats[self.blk[t]]
        if mat.LamType > 2:
            lab = self.labels[self.mesh.element_labels[t]]
            atot = self.area_m2[self.mesh.element_labels
                                == self.mesh.element_labels[t]].sum()
            mu = _proximity_mu(self.problem, lab, mat, atot)
            return mu, mu
        if mat.BHpoints == 0:
            mu1, mu2 = _effective_mu(self.problem, mat)
        else:
            biron = np.sqrt(abs(self.B1[t] * np.conj(self.B1[t]))
                            + abs(self.B2[t] * np.conj(self.B2[t])))
            if abs(biron) < 1e-08:
                mu1 = 1.0 / mat.slope[0] / MU0
            else:
                mu1 = biron / mat.get_H(float(biron.real)) / MU0
            mu2 = mu1
        aecf = self._aecf(t)
        return mu1 / aecf, mu2 / aecf

    def _aecf(self, t: int) -> float:
        """Axisymmetric external-region correction (fpproc.cpp AECF)."""
        if self.problem.ProblemType != ProblemType.AXISYMMETRIC:
            return 1.0
        lab = self.labels[self.mesh.element_labels[t]]
        if not lab.IsExternal:
            return 1.0
        p = self.problem
        cx, cy = self.ctr[t]
        r = math.hypot(cx, cy - p.extZo)
        return (r * r * p.extRi) / (p.extRo ** 3)

    # ------------------------------------------------------------------ #
    # circuit quantities (fpproc.cpp:5069-5330)                           #
    # ------------------------------------------------------------------ #
    def _pln_int(self, a, u, v):
        """Integral of u*v over a triangle from nodal values
        (PlnInt, fpproc.cpp:3580)."""
        z0 = 2 * u[:, 0] + u[:, 1] + u[:, 2]
        z1 = u[:, 0] + 2 * u[:, 1] + u[:, 2]
        z2 = u[:, 0] + u[:, 1] + 2 * u[:, 2]
        return a * (v[:, 0] * z0 + v[:, 1] * z1 + v[:, 2] * z2) / 12.0

    def _axi_int(self, a, u, v, r):
        """Axisymmetric r-weighted triangle integral (AxiInt,
        fpproc.cpp:3551-3578); r is (T,3) node radii in meters."""
        M = np.empty(u.shape[:1] + (3, 3), complex)
        M[:, 0, 0] = 6 * r[:, 0] + 2 * r[:, 1] + 2 * r[:, 2]
        M[:, 0, 1] = 2 * r[:, 0] + 2 * r[:, 1] + 1 * r[:, 2]
        M[:, 0, 2] = 2 * r[:, 0] + 1 * r[:, 1] + 2 * r[:, 2]
        M[:, 1, 1] = 2 * r[:, 0] + 6 * r[:, 1] + 2 * r[:, 2]
        M[:, 1, 2] = 1 * r[:, 0] + 2 * r[:, 1] + 2 * r[:, 2]
        M[:, 2, 2] = 2 * r[:, 0] + 2 * r[:, 1] + 6 * r[:, 2]
        M[:, 1, 0] = M[:, 0, 1]
        M[:, 2, 0] = M[:, 0, 2]
        M[:, 2, 1] = M[:, 1, 2]
        z = np.einsum("tij,tj->ti", M, u)
        return PI * a * np.einsum("ti,ti->t", v, z) / 30.0

    def _aj_integral(self, sel_el, conj_J=True):
        """Integral of A.(conj J) over selected elements."""
        J, Aface = self.element_JA()
        a = self.area_m2
        Jv = np.conj(J) if conj_J else J
        if self.problem.ProblemType == ProblemType.PLANAR:
            y = self._pln_int(a, Aface, Jv) * self.depth
        else:
            r = self.mesh.nodes[self.mesh.elements][:, :, 0] * self.lc
            y = self._axi_int(a, Aface, Jv, r)
        return complex((y * sel_el).sum()) * 1e6   # J in MA/m^2

    def circuit_properties(self, name: str):
        """(current, voltage drop, flux linkage) for a circuit
        (mo_getcircuitproperties -> GetVoltageDrop/GetFluxLinkage,
        fpproc.cpp:5069-5225)."""
        circs = self.problem.circproplist
        ci = next(i for i, c in enumerate(circs) if c.name == name)
        circ = circs[ci]
        amps = complex(circ.Amps)
        lbl_in = np.array([l.InCircuit == ci for l in self.labels])
        sel_el = lbl_in[self.mesh.element_labels]
        planar = self.problem.ProblemType == ProblemType.PLANAR

        # voltage drop: solid labels use the solved dV; stranded labels
        # integrate 2 pi f A + rho J (GetStrandedVoltageDrop)
        volts = 0.0 + 0j
        for k, lab in enumerate(self.labels):
            if lab.InCircuit != ci:
                continue
            case, value = self.label_case[k]
            if int(abs(case)) == 0:
                dv = complex(value)
                volts -= (self.depth if planar else 2.0 * PI) * dv \
                    * (lab.Turns if circ.CircType == 1 else 1.0)
            else:
                volts += self._stranded_voltage_drop(k)
            if circ.CircType == 0:
                break
        if amps != 0:
            flux = self._aj_integral(sel_el) / np.conj(amps)
        elif self.frequency != 0:
            flux = volts / (2.0 * PI * self.frequency)
        else:
            flux = 0.0 + 0j
        return amps, volts, flux

    def _stranded_voltage_drop(self, lbl: int) -> complex:
        """GetStrandedVoltageDrop (fpproc.cpp:5021-5066)."""
        sel = self.mesh.element_labels == lbl
        if not sel.any():
            return 0.0
        mat = self.mats[self.labels[lbl].BlockType]
        sigma = mat.Cduct * 1e6
        rho = 1.0 / sigma if sigma != 0 else 0.0
        J, Aface = self.element_JA()
        V = 2.0 * PI * 1j * self.frequency * Aface + rho * J * 1e6
        U = np.ones_like(V)
        a = self.area_m2
        if self.problem.ProblemType == ProblemType.PLANAR:
            y = self._pln_int(a, V, U) * self.depth
        else:
            r = self.mesh.nodes[self.mesh.elements][:, :, 0] * self.lc
            y = self._axi_int(a, V, U, r)
        atot = a[sel].sum()
        return complex((y * sel).sum()) * self.labels[lbl].Turns / atot

    # ------------------------------------------------------------------ #
    # smoothed nodal B (GetNodalB, fpproc.cpp:2704-2966)                  #
    # ------------------------------------------------------------------ #
    def _conlist(self):
        if hasattr(self, "_con"):
            return self._con
        tris = self.mesh.elements
        T = len(tris)
        pairs_n = tris.reshape(-1)
        pairs_e = np.repeat(np.arange(T), 3)
        order = np.argsort(pairs_n, kind="stable")
        self._con = (pairs_n[order], pairs_e[order],
                     np.searchsorted(pairs_n[order],
                                     np.arange(self.mesh.num_nodes + 1)))
        return self._con

    def _group_key(self):
        """Element material-compatibility key for smoothing
        (fpproc.cpp:2816-2836): elements in different labels still smooth
        across the boundary when their material constants match."""
        keys = {}
        out = np.zeros(self.mesh.num_elements, np.int64)
        for t in range(self.mesh.num_elements):
            m = self.mats[self.blk[t]]
            if self.frequency == 0:
                k = (m.mu_x, m.mu_y, m.H_c, round(self.magdir[t], 9))
            else:
                k = (self.blk[t],)
            out[t] = keys.setdefault(k, len(keys))
        return out

    def nodal_B(self):
        """Per-(element, corner) smoothed flux density (T,3) complex
        pair, lazily computed. Interior corners: inverse-centroid-
        distance weighted average over the node's element patch;
        corners on material interfaces: the reference's interface-pair
        reconstruction (tangential B from the element, normal B from
        dA/dt along the interface)."""
        if hasattr(self, "_nb"):
            return self._nb
        tris = self.mesh.elements
        T = self.mesh.num_elements
        N = self.mesh.num_nodes
        group = self._group_key()
        con_n, con_e, con_ptr = self._conlist()

        # a node is "uniform" if every adjacent element shares one group
        ngroups = np.full(N, -1, np.int64)
        uniform = np.ones(N, bool)
        first = con_ptr[:-1] < con_ptr[1:]
        ngroups[con_n[con_ptr[:-1][first]]] = group[con_e[con_ptr[:-1][first]]]
        mismatch = group[con_e] != ngroups[con_n]
        uniform[con_n[mismatch]] = False

        # vectorized inverse-distance patch average for uniform nodes
        ctr = self.ctr
        pn = self.mesh.nodes[con_n]
        z = 1.0 / np.maximum(np.hypot(*(pn - ctr[con_e]).T), 1e-30)
        wB1 = np.zeros(N, complex)
        wB2 = np.zeros(N, complex)
        wZ = np.zeros(N)
        np.add.at(wB1, con_n, z * self.B1[con_e])
        np.add.at(wB2, con_n, z * self.B2[con_e])
        np.add.at(wZ, con_n, z)
        nb1_node = wB1 / np.maximum(wZ, 1e-300)
        nb2_node = wB2 / np.maximum(wZ, 1e-300)

        b1 = nb1_node[tris].astype(complex)
        b2 = nb2_node[tris].astype(complex)

        # interface corners: reference scan per (element, corner)
        lc = self.lc
        A = self.A
        axi = self.problem.ProblemType == ProblemType.AXISYMMETRIC
        lbl_of = self.mesh.element_labels
        nonuni = ~uniform
        for t in range(T):
            for i in range(3):
                k = tris[t, i]
                if uniform[k]:
                    continue
                b1[t, i], b2[t, i] = self._interface_nodal_b(
                    t, i, k, con_n, con_e, con_ptr, lbl_of, lc, axi)
        # on-axis nodes: Br = 0 (fpproc.cpp:2963-2965)
        if axi:
            on_axis = np.abs(self.mesh.nodes[tris][:, :, 0]) < 1e-06
            b1 = np.where(on_axis, 0.0, b1)
        self._nb = (b1, b2)
        return self._nb

    def _interface_nodal_b(self, t, i, k, con_n, con_e, con_ptr, lbl_of,
                           lc, axi):
        """CCW+CW interface scan around node k starting from element t
        (fpproc.cpp:2760-2890)."""
        tris = self.mesh.elements
        adj = con_e[con_ptr[k]:con_ptr[k + 1]]
        lbl0 = lbl_of[t]

        def scan(direction):
            """Walk same-label elements around node k; returns
            (interface far node, element on OUR side of the interface)
            or (None, e) on a hull punt (fpproc.cpp:2768-2830 -- note
            the tangential-B 'kludge' reads the element ADJACENT to the
            interface side, e, not the containing element)."""
            e = t
            for _ in range(len(adj) + 1):
                tri = tris[e]
                j = int(np.nonzero(tri == k)[0][0])
                pt = tri[(j - 1) % 3] if direction == 0 else tri[(j + 1) % 3]
                nxt = -1
                for cand in adj:
                    if cand != e and pt in tris[cand]:
                        nxt = int(cand)
                        break
                if nxt < 0:
                    return None, e       # hull: special-case punt
                if lbl_of[nxt] != lbl0:
                    return int(pt), e    # interface side found
                e = nxt
            return None, e

        total1 = 0.0 + 0j
        total2 = 0.0 + 0j
        R = 0.0
        vs = []
        for direction in (0, 1):
            pt, e = scan(direction)
            if pt is None:
                return self.B1[e], self.B2[e]
            p0 = self.mesh.nodes[k]
            p1 = self.mesh.nodes[pt]
            tn = p1 - p0
            tlen = np.hypot(*tn)
            r = (p1[0] + p0[0]) * lc / 2.0
            bn = (self.A[pt] - self.A[k]) / (tlen * lc)
            if axi:
                bn /= (-2.0 * PI * r) if r != 0 else 1.0
            z = 0.5 / tlen
            tn = tn / tlen
            bt = self.B1[e] * tn[0] + self.B2[e] * tn[1]
            R += z
            total1 += z * (tn[0] * bt + tn[1] * bn)
            total2 += z * (tn[1] * bt - tn[0] * bn)
            vs.append(tn)
        b1 = total1 / R
        b2 = total2 / R
        # sharp-corner sanity check (fpproc.cpp:2893-2944)
        ok = (-vs[0][0] * vs[1][0] - vs[0][1] * vs[1][1]) > 0.985
        if not ok:
            # punt: scale element B to the max |B| in the same label
            bmax_re = bmax_im = 0.0
            for cand in con_e[con_ptr[k]:con_ptr[k + 1]]:
                if lbl_of[cand] == lbl0:
                    br = np.hypot(self.B1[cand].real, self.B2[cand].real)
                    bi = np.hypot(self.B1[cand].imag, self.B2[cand].imag)
                    bmax_re = max(bmax_re, br)
                    bmax_im = max(bmax_im, bi)
            Rr = np.hypot(self.B1[t].real, self.B2[t].real)
            Ri = np.hypot(self.B1[t].imag, self.B2[t].imag)
            b1 = complex(bmax_re / Rr * self.B1[t].real if Rr else 0.0,
                         bmax_im / Ri * self.B1[t].imag if Ri else 0.0)
            b2 = complex(bmax_re / Rr * self.B2[t].real if Rr else 0.0,
                         bmax_im / Ri * self.B2[t].imag if Ri else 0.0)
        return b1, b2

    def point_B(self, x, y, t, smooth=True):
        """B at a point of element t: barycentric interpolation of the
        smoothed nodal values (GetPointB, fpproc.cpp:2669)."""
        if not smooth:
            return self.B1[t], self.B2[t]
        b1n, b2n = self.nodal_B()
        tri = self.mesh.elements[t]
        xy = self.mesh.nodes[tri]
        d1 = xy[1] - xy[0]
        d2 = xy[2] - xy[0]
        det = d1[0] * d2[1] - d1[1] * d2[0]
        s = ((x - xy[0][0]) * d2[1] - (y - xy[0][1]) * d2[0]) / det
        u = ((y - xy[0][1]) * d1[0] - (x - xy[0][0]) * d1[1]) / det
        w = np.array([1 - s - u, s, u])
        return (b1n[t] * w).sum(), (b2n[t] * w).sum()

    # ------------------------------------------------------------------ #
    # line integrals (LineIntegral, fpproc.cpp:4094-4350)                 #
    # ------------------------------------------------------------------ #
    def line_integral(self, inttype: int, contour, npoints: int = 100):
        """Contour integrals over a polyline [(x, y), ...] in problem
        units. Types: 0 B.n (total, avg), 1 H.t (total, avg), 2 length
        (length, surface area), 3 Maxwell stress force (Fx, Fy [+2x]),
        4 Maxwell stress torque (T [+2x]), 5 (B.n)^2 (total, avg)."""
        pts = [complex(x, y) for x, y in contour]
        lc = self.lc
        axi = self.problem.ProblemType == ProblemType.AXISYMMETRIC
        if inttype == 0:
            a0 = self.get_point_values(pts[0].real, pts[0].imag)["A"]
            a1 = self.get_point_values(pts[-1].real, pts[-1].imag)["A"]
            if not axi:
                L = sum(abs(pts[i + 1] - pts[i])
                        for i in range(len(pts) - 1)) * lc
                tot = (a0 - a1) * self.depth
                return tot, (tot / (L * self.depth) if L else 0.0)
            S = sum(PI * (pts[i].real + pts[i + 1].real)
                    * abs(pts[i + 1] - pts[i])
                    for i in range(len(pts) - 1)) * lc * lc
            tot = a1 - a0
            return tot, (tot / S if S else 0.0)
        if inttype == 2:
            L = sum(abs(pts[i + 1] - pts[i])
                    for i in range(len(pts) - 1)) * lc
            if axi:
                S = sum(PI * (pts[i].real + pts[i + 1].real)
                        * abs(pts[i + 1] - pts[i])
                        for i in range(len(pts) - 1)) * lc * lc
            else:
                S = L * self.depth
            return L, S

        z = [0.0 + 0j] * 4
        total_len = sum(abs(pts[i + 1] - pts[i])
                        for i in range(len(pts) - 1)) * lc
        for kseg in range(1, len(pts)):
            seg = pts[kseg] - pts[kseg - 1]
            dz = abs(seg) / npoints
            tvec = seg / abs(seg)
            nvec = 1j * tvec
            for ii in range(npoints):
                u = (ii + 0.5) / npoints
                pt = pts[kseg - 1] + u * seg + nvec * 1e-06
                t = self.find_element(pt.real, pt.imag)
                if t < 0:
                    continue
                v = self.get_point_values(pt.real, pt.imag, element=t)
                B1, B2 = v["B1"], v["B2"]
                H1, H2 = v["H1"], v["H2"]
                if inttype == 1:
                    z[0] += (tvec.real * H1 + tvec.imag * H2) * dz * lc
                elif inttype == 5:
                    Bn = nvec.real * B1 + nvec.imag * B2
                    z[0] += abs(Bn) ** 2 * dz * lc
                elif inttype in (3, 4):
                    Hn = nvec.real * H1 + nvec.imag * H2
                    Bn = nvec.real * B1 + nvec.imag * B2
                    BH = B1 * H1 + B2 * H2
                    dF1 = H1 * Bn + B1 * Hn - nvec.real * BH
                    dF2 = H2 * Bn + B2 * Hn - nvec.imag * BH
                    if inttype == 3:
                        dza = dz * lc
                        if axi:
                            dza *= 2.0 * PI * pt.real * lc
                            dF1 = 0.0
                        else:
                            dza *= self.depth
                        scale = 0.5 if self.frequency == 0 else 0.25
                        z[0] += dF1 * dza * scale
                        z[1] += dF2 * dza * scale
                        if self.frequency != 0:
                            BHc = B1 * np.conj(H1) + B2 * np.conj(H2)
                            dF1c = H1 * np.conj(Bn) + B1 * np.conj(Hn) \
                                - nvec.real * BHc
                            dF2c = H2 * np.conj(Bn) + B2 * np.conj(Hn) \
                                - nvec.imag * BHc
                            if axi:
                                dF1c = 0.0
                            z[2] += dF1c * dza * 0.25
                            z[3] += dF2c * dza * 0.25
                    else:
                        dT = pt.real * dF2 - dF1 * pt.imag
                        dza = dz * lc * lc * self.depth
                        scale = 0.5 if self.frequency == 0 else 0.25
                        z[0] += dT * dza * scale
                        if self.frequency != 0:
                            BHc = B1 * np.conj(H1) + B2 * np.conj(H2)
                            dF1c = H1 * np.conj(Bn) + B1 * np.conj(Hn) \
                                - nvec.real * BHc
                            dF2c = H2 * np.conj(Bn) + B2 * np.conj(Hn) \
                                - nvec.imag * BHc
                            dTc = pt.real * dF2c - dF1c * pt.imag
                            z[1] += dTc * dza * 0.25
        if inttype in (1, 5):
            return z[0], (z[0] / total_len if total_len else 0.0)
        if inttype == 3:
            return tuple(z)
        return z[0], z[1]

    # ------------------------------------------------------------------ #
    # point values                                                       #
    # ------------------------------------------------------------------ #
    def find_element(self, x: float, y: float) -> int:
        """Triangle containing (x, y) in problem units (linear scan with
        barycentric test; callers needing speed should batch)."""
        xy = self.mesh.nodes[self.mesh.elements]
        v0 = xy[:, 0]
        d1 = xy[:, 1] - v0
        d2 = xy[:, 2] - v0
        det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
        px = x - v0[:, 0]
        py = y - v0[:, 1]
        s = (px * d2[:, 1] - py * d2[:, 0]) / det
        t = (py * d1[:, 0] - px * d1[:, 1]) / det
        ok = (s >= -1e-12) & (t >= -1e-12) & (s + t <= 1 + 1e-12)
        idx = np.where(ok)[0]
        if len(idx) == 0:
            return -1
        return int(idx[0])

    def get_magnetization(self, t: int):
        """Piece-wise constant magnetization (M1, M2) of element t
        (FPProc::GetMagnetization, fpproc.cpp:5259)."""
        mat = self.mats[self.blk[t]]
        b1, b2 = self.B1[t], self.B2[t]
        if self.frequency == 0:
            mu1, mu2 = _get_mu(mat, b1.real, b2.real)
            hc = mat.H_c * cmath.exp(1j * PI * self.magdir[t] / 180.0)
        else:
            mu1, mu2 = self._get_mu_complex(t)
            hc = 0.0
        M1 = b1 * (mu1 - 1) / (mu1 * MU0) + complex(hc).real
        M2 = b2 * (mu2 - 1) / (mu2 * MU0) + complex(hc).imag
        return M1, M2

    def get_point_values(self, x: float, y: float, element: int = -1,
                         smooth: bool | None = None) -> dict:
        """A, B, H, mu, J at a point (subset of CMPointVals,
        fpproc.cpp:2257 GetPointValues). ``smooth`` uses the patch-
        smoothed nodal B (the reference's default); None defers to the
        mo_smooth session toggle."""
        if smooth is None:
            smooth = self.smoothing
        t = element if element >= 0 else self.find_element(x, y)
        if t < 0:
            return {}
        tris = self.mesh.elements[t]
        xy = self.mesh.nodes[tris]
        # barycentric interpolation of A
        d1 = xy[1] - xy[0]
        d2 = xy[2] - xy[0]
        det = d1[0] * d2[1] - d1[1] * d2[0]
        s = ((x - xy[0][0]) * d2[1] - (y - xy[0][1]) * d2[0]) / det
        u = ((y - xy[0][1]) * d1[0] - (x - xy[0][0]) * d1[1]) / det
        A = (1 - s - u) * self.A[tris[0]] + s * self.A[tris[1]] \
            + u * self.A[tris[2]]
        mat = self.mats[self.blk[t]]
        b1, b2 = self.point_B(x, y, t, smooth=smooth)
        mu1, mu2 = _get_mu(mat, b1, b2)
        aecf = self._aecf(t)
        mu1 /= aecf
        mu2 /= aecf
        J, _ = self.element_JA()
        # H from B through the (hysteresis-lagged) permeability plus the
        # permanent-magnet offset (GetPointValues, fpproc.cpp:2300-2340)
        H1 = b1 / (mu1 * MU0)
        H2 = b2 / (mu2 * MU0)
        if self.frequency == 0 and mat.H_c != 0:
            hc = mat.H_c * cmath.exp(1j * PI * self.magdir[t] / 180.0)
            H1 = H1 - hc.real
            H2 = H2 - hc.imag
        return {
            "A": A,
            "B1": b1, "B2": b2,
            "mu1": mu1, "mu2": mu2,
            "H1": H1, "H2": H2,
            "Je": complex(J[t].mean()),
        }


def _mat_is_air(mat: MagneticMaterial) -> bool:
    """CMMaterialProp::isAir (CMaterialProp.cpp:698)."""
    return (mat.mu_x == 1 and mat.mu_y == 1 and mat.BHpoints == 0
            and mat.LamType == 0 and mat.H_c == 0 and mat.J == 0
            and mat.Cduct == 0 and mat.Theta_hn == 0 and mat.Theta_hx == 0
            and mat.Theta_hy == 0)


def _do_energy(mat: MagneticMaterial, b1: float, b2: float) -> float:
    """CMMaterialProp::DoEnergy, DC (CMaterialProp.cpp:595)."""
    if mat.BHpoints == 0:
        if mat.LamType == 0:
            h1 = b1 / ((1 + mat.LamFill * (mat.mu_x - 1)) * MU0)
            h2 = b2 / ((1 + mat.LamFill * (mat.mu_y - 1)) * MU0)
        elif mat.LamType == 1:
            h1 = b1 / ((1 + mat.LamFill * (mat.mu_x - 1)) * MU0)
            h2 = b1 * (mat.LamFill / (mat.mu_y * MU0)
                       + (1 - mat.LamFill) / MU0)
        elif mat.LamType == 2:
            h2 = b1 / ((1 + mat.LamFill * (mat.mu_y - 1)) * MU0)
            h1 = b1 * (mat.LamFill / (mat.mu_x * MU0)
                       + (1 - mat.LamFill) / MU0)
        else:
            h1 = b1 / MU0
            h2 = b2 / MU0
        return (h1 * b1 + h2 * b2) / 2.0
    f = mat.LamFill
    if mat.LamType == 0:
        return mat.get_energy(math.hypot(b1, b2))
    if mat.LamType == 1:
        biron = math.hypot(b1 / f, b2)
        return f * mat.get_energy(biron) + (1 - f) * b2 * b2 / (2 * MU0)
    if mat.LamType == 2:
        biron = math.hypot(b2 / f, b1)
        return f * mat.get_energy(biron) + (1 - f) * b1 * b1 / (2 * MU0)
    return 0.0


def _do_coenergy(mat: MagneticMaterial, b1: float, b2: float) -> float:
    if mat.BHpoints == 0:
        return _do_energy(mat, b1, b2)
    f = mat.LamFill
    if mat.LamType == 0:
        return mat.get_coenergy(math.hypot(b1, b2))
    if mat.LamType == 1:
        biron = math.hypot(b1 / f, b2)
        return f * mat.get_coenergy(biron) + (1 - f) * b2 * b2 / (2 * MU0)
    if mat.LamType == 2:
        biron = math.hypot(b2 / f, b1)
        return f * mat.get_coenergy(biron) + (1 - f) * b1 * b1 / (2 * MU0)
    return 0.0


def _energy_pm(mat: MagneticMaterial, b1: float, b2: float,
               magdir: float) -> float:
    """Stored-energy correction for permanent magnets
    (fpproc.cpp:3783-3809)."""
    if mat.BHpoints == 0:
        mu1 = mat.mu_x
        mu2 = mat.mu_y
        hc = mat.H_c * cmath.exp(1j * PI * magdir / 180.0)
        h1 = b1 / (mu1 * MU0) - hc.real
        h2 = b2 / (mu2 * MU0) - hc.imag
        return 0.5 * MU0 * (mu1 * h1 * h1 + mu2 * h2 * h2)
    y = _do_energy(mat, b1, b2)
    y += mat.Nrg - mat.H_c * (complex(b1, b2)
                              / cmath.exp(1j * PI * magdir / 180.0)).real
    return y


def _get_mu(mat: MagneticMaterial, b1, b2):
    """DC GetMu (CMaterialProp.cpp:775), relative permeabilities."""
    if mat.BHpoints == 0:
        if mat.LamType == 0:
            return (1 + mat.LamFill * (mat.mu_x - 1),
                    1 + mat.LamFill * (mat.mu_y - 1))
        if mat.LamType == 1:
            return (mat.LamFill * mat.mu_x + 1 - mat.LamFill,
                    mat.mu_x / (mat.LamFill + mat.mu_x * (1 - mat.LamFill)))
        if mat.LamType == 2:
            return (mat.mu_y / (mat.LamFill + mat.mu_y * (1 - mat.LamFill)),
                    mat.LamFill * mat.mu_y + 1 - mat.LamFill)
        return 1.0, 1.0
    b = abs(math.hypot(abs(b1), abs(b2)))
    if b < 1e-08:
        mu = 1.0 / mat.slope[0].real
    else:
        mu = b / mat.get_H(b).real
    return mu / MU0, mu / MU0
