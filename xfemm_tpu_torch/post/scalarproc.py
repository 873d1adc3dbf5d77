"""Heat-flow and electrostatics postprocessors (HPProc / EPProc rebuilt
on arrays).

Element fields, point values, block integrals and contour line integrals
for the two scalar problem classes. Reference anchors:

* element flux density: cfemm/hpproc/hpproc.cpp:368 ``getElementD``
  (D = K grad T / AECF), cfemm/epproc/epproc.cpp GetElementD
* point values: hpproc.cpp:330 ``getPointValues`` (T/F/K/G),
  epproc CSPointVals (V/D/E)
* block integrals: hpproc.cpp:584 (avg T, area, volume, avg F, avg G),
  epproc.cpp:270 (energy, area, volume, D, E, weighted-stress force /
  torque 5/6)
* line integrals: hpproc.cpp:648 (G.t = dT, F.n flux, length, avg T),
  epproc lineIntegral (E.t = dV, D.n charge, length, avg V)
* axisymmetric external-region correction:
  cfemm/libfemm/PostProcessor.cpp AECF = r^2/(extRo*extRi)

Everything is vectorized over elements; contour integrals sample 100
points per segment like the reference (``d_LineIntegralPoints``).
"""

from __future__ import annotations

import cmath as _cmath

import numpy as np

from ..constants import LENGTH_TO_METERS, PI, ProblemType
from ..geometry.problem import Problem
from ..mesh.meshdata import MeshData
from .fpproc import _mat_is_air  # noqa: F401 (same module family)

EPS0 = 8.85418781762e-12
LINE_INTEGRAL_POINTS = 100


class ScalarPostProcessor:
    """Shared machinery; ``mode`` is 'heat' or 'electro'."""

    def __init__(self, problem: Problem, mesh: MeshData, V: np.ndarray,
                 mode: str, node_bc: np.ndarray | None = None):
        from ..mesh.meshdata import resolve_default_labels
        resolve_default_labels(problem, mesh)
        self.problem = problem
        self.mesh = mesh
        self.V = np.asarray(V, float)
        self.node_bc = node_bc    # True where the node carries a fixed
                                  # conductor/point BC (getNodalD punts)
        self.smoothing = True     # setSmoothing(): nodal-patch smoothed
                                  # D/F at point queries (reference
                                  # default, PostProcessor.cpp:77)
        self.mode = mode
        self.lc = LENGTH_TO_METERS[problem.LengthUnits]
        self.axi = problem.ProblemType == ProblemType.AXISYMMETRIC
        self.depth = problem.Depth * self.lc
        self.labels = [l for l in problem.labellist if not l.is_hole()]
        self.mats = problem.blockproplist
        self.blk = np.array([self.labels[i].BlockType
                             for i in mesh.element_labels], np.int64)
        self._geom()
        self._element_fields()
        self._conlist = None      # node -> adjacent elements (lazy)
        self._matcls = None       # block -> material-equivalence class
        self._nodal_cache: dict = {}

    # ------------------------------------------------------------------ #
    def _geom(self):
        xy = self.mesh.nodes
        v = xy[self.mesh.elements]
        self.b = v[:, [1, 2, 0], 1] - v[:, [2, 0, 1], 1]
        self.c = v[:, [2, 0, 1], 0] - v[:, [1, 2, 0], 0]
        self.da = self.b[:, 0] * self.c[:, 1] - self.b[:, 1] * self.c[:, 0]
        self.ctr = v.mean(axis=1)
        self.area_m2 = 0.5 * np.abs(self.da) * self.lc ** 2

    def _aecf(self, pts=None):
        """Axisymmetric external-region correction per element
        (PostProcessor.cpp AECF)."""
        T = self.mesh.num_elements
        out = np.ones(T)
        if not self.axi:
            return out
        is_ext = np.array([self.labels[i].IsExternal
                           for i in self.mesh.element_labels], bool)
        if not is_ext.any():
            return out
        p = self.ctr if pts is None else pts
        r2 = p[:, 0] ** 2 + (p[:, 1] - self.problem.extZo) ** 2
        corr = r2 / (self.problem.extRo * self.problem.extRi)
        return np.where(is_ext, corr, 1.0)

    def _element_k(self):
        """(kx, ky) per element: K(T) 3-node average for heat
        (hsolver-style), eps0*ex/ey for electrostatics."""
        T = self.mesh.num_elements
        kx = np.zeros(T)
        ky = np.zeros(T)
        if self.mode == "electro":
            for bi in set(self.blk.tolist()):
                sel = self.blk == bi
                kx[sel] = EPS0 * self.mats[bi].ex
                ky[sel] = EPS0 * self.mats[bi].ey
            return kx, ky
        Tn = self.V[self.mesh.elements]
        for bi in set(self.blk.tolist()):
            sel = self.blk == bi
            mat = self.mats[bi]
            if mat.npts == 0:
                kx[sel] = mat.Kx
                ky[sel] = mat.Ky
            else:
                kv = mat.get_k_array(Tn[sel].mean(axis=1))
                kx[sel] = kv
                ky[sel] = kv
        return kx, ky

    def _element_fields(self):
        """E/G = -grad(V) and D/F = K E / AECF per element."""
        Vn = self.V[self.mesh.elements]
        lc = self.lc
        self.Ex = -(Vn * self.b).sum(axis=1) / (self.da * lc)
        self.Ey = -(Vn * self.c).sum(axis=1) / (self.da * lc)
        kx, ky = self._element_k()
        aecf = self._aecf()
        self.Dx = kx * self.Ex / aecf
        self.Dy = ky * self.Ey / aecf
        self.kx, self.ky = kx, ky

    # ------------------------------------------------------------------ #
    def find_element(self, x: float, y: float) -> int:
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
        idx = np.nonzero(ok)[0]
        return int(idx[0]) if len(idx) else -1

    def _node_elements(self):
        """ConList: adjacent elements per node, sorted ccw by element
        centroid angle around the node (hpproc.cpp:218-236) -- the
        nodal-recovery patch walk depends on this ordering."""
        if self._conlist is None:
            tris = self.mesh.elements
            T = tris.shape[0]
            flat = tris.ravel()
            nodes_rep = flat
            elems_rep = np.repeat(np.arange(T), 3)
            ang = np.arctan2(self.ctr[elems_rep, 1] - self.mesh.nodes[nodes_rep, 1],
                             self.ctr[elems_rep, 0] - self.mesh.nodes[nodes_rep, 0])
            order = np.lexsort((ang, nodes_rep))
            elems = elems_rep[order]
            starts = np.searchsorted(nodes_rep[order],
                                     np.arange(len(self.mesh.nodes) + 1))
            self._conlist = (elems, starts)
        return self._conlist

    def _mat_class(self):
        """Per-block material-equivalence ids implementing the
        reference's isSameMaterialAs (CMaterialProp.cpp:1490 heat /
        :1611 electro): two DIFFERENT block labels with identical
        material parameters count as the same material for the nodal
        patch walk."""
        if self._matcls is None:
            keys = {}
            cls = np.empty(len(self.mats), np.int64)
            for bi, mat in enumerate(self.mats):
                if self.mode == "electro":
                    key = (mat.ex, mat.ey)
                elif mat.npts == 0:
                    key = (mat.Kx, mat.Ky)
                else:
                    key = (tuple(mat.Tdata), tuple(mat.Kdata))
                cls[bi] = keys.setdefault(key, len(keys))
            self._matcls = cls
        return self._matcls

    def _nodal_D(self, t: int) -> np.ndarray:
        """Smoothed flux density at element t's nodes: the reference's
        exact patch recovery (PostProcessor.cpp:894 getNodalD) -- a
        ccw/cw walk from element t around each node collecting ring
        nodes WITH duplicates, breaking at material changes and at
        fixed-BC edges, the reference's punt cases for fixed nodes
        (including the 10-degree corner-angle test), then a plane fit of
        the potential over the collected patch and D = K E."""
        if t in self._nodal_cache:
            return self._nodal_cache[t]
        elems, starts = self._node_elements()
        tris = self.mesh.elements
        matcls = self._mat_class()
        cls_t = matcls[self.blk[t]]
        tri = tris[t]
        xy = self.mesh.nodes
        fixed = self.node_bc
        out = np.zeros((3, 2))
        for i, j in enumerate(tri):
            con = elems[starts[j]:starts[j + 1]]
            nlist = len(con)
            eos = int(np.nonzero(con == t)[0][0])
            j_fixed = fixed is not None and bool(fixed[j])
            q = []
            lf = rt = -1
            # scan ccw: each element contributes the node after j in ccw
            # orientation; stop at a material change or a fixed-BC edge
            # (PostProcessor.cpp:914-945)
            m = eos
            for _ in range(nlist):
                n = con[m]
                if matcls[self.blk[n]] != cls_t:
                    break
                nos = int(np.nonzero(tris[n] == j)[0][0])
                p = int(tris[n][nos - 1])
                if len(q) < 20:
                    q.append(p)
                if j_fixed and fixed[p]:
                    rt = p
                    break
                m += 1
                if m == nlist:
                    m = 0
            # scan cw (PostProcessor.cpp:946-977)
            m = eos
            for _ in range(nlist):
                n = con[m]
                if matcls[self.blk[n]] != cls_t:
                    break
                nos = int(np.nonzero(tris[n] == j)[0][0])
                p = int(tris[n][(nos + 1) % 3])
                if len(q) < 20:
                    q.append(p)
                if j_fixed and fixed[p]:
                    lf = p
                    break
                m -= 1
                if m < 0:
                    m = nlist - 1
            # fixed-node punt cases (PostProcessor.cpp:980-1024): a node
            # at a conductor end or an isolated charge uses the element
            # value; a fixed-boundary node only fits when the boundary
            # bends by less than 10 degrees
            punt = False
            if j_fixed:
                if rt != -1 and (lf == rt or lf == -1):
                    punt = True
                elif lf != -1 and rt == -1:
                    punt = True
                elif lf == -1 and rt == -1:
                    punt = True
                else:
                    ux = complex(xy[lf, 0] - xy[j, 0], xy[lf, 1] - xy[j, 1])
                    uy = complex(xy[j, 0] - xy[rt, 0], xy[j, 1] - xy[rt, 1])
                    ux /= abs(ux)
                    uy /= abs(uy)
                    if abs(_cmath.phase(ux / uy)) > 10.0001 * PI / 180.0:
                        punt = True
            if punt:
                out[i] = (self.Dx[t], self.Dy[t])
                continue
            # plane fit over q (duplicates included) + the node itself
            # (PostProcessor.cpp:1028-1094); dv = V_j - V_k makes the
            # fitted slope E = -grad V directly
            qa = np.array(q + [j], np.int64)
            dx = xy[qa, 0] - xy[j, 0]
            dy = xy[qa, 1] - xy[j, 1]
            dv = self.V[j] - self.V[qa]
            ii = float(len(qa))
            xi, yi = dx.sum(), dy.sum()
            xx, xy_s, yy = (dx * dx).sum(), (dx * dy).sum(), (dy * dy).sum()
            iv, xv, yv = dv.sum(), (dx * dv).sum(), (dy * dv).sum()
            det = (-(ii * xy_s * xy_s) + 2 * xi * xy_s * yi - xx * yi * yi
                   - xi * xi * yy + ii * xx * yy) * self.lc
            if det == 0:
                out[i] = (self.Dx[t], self.Dy[t])
                continue
            Ex = (iv * xy_s * yi - xv * yi * yi - ii * xy_s * yv
                  + xi * yi * yv - iv * xi * yy + ii * xv * yy) / det
            Ey = (iv * xi * xy_s - ii * xv * xy_s + xi * xv * yi
                  - iv * xx * yi - xi * xi * yv + ii * xx * yv) / det
            if self.mode == "heat":
                # K evaluated at the NODE temperature, no AECF here
                # (PostProcessor.cpp:1079-1083)
                knx, kny = self.mats[self.blk[t]].get_k(self.V[j])
                out[i] = (knx * Ex, kny * Ey)
            else:
                # AECF at the NODE's position (PostProcessor.cpp:1071)
                aecf = 1.0
                if self.axi and self.labels[
                        self.mesh.element_labels[t]].IsExternal:
                    aecf = (xy[j, 0] ** 2
                            + (xy[j, 1] - self.problem.extZo) ** 2) \
                        / (self.problem.extRo * self.problem.extRi)
                out[i] = (self.kx[t] * Ex / aecf, self.ky[t] * Ey / aecf)
        self._nodal_cache[t] = out
        return out

    def _point_D(self, x: float, y: float, t: int) -> tuple:
        """Barycentric interpolation of the smoothed nodal D
        (PostProcessor.cpp:1153 getPointD)."""
        d = self._nodal_D(t)
        tri = self.mesh.elements[t]
        xy = self.mesh.nodes[tri]
        d1 = xy[1] - xy[0]
        d2 = xy[2] - xy[0]
        det = d1[0] * d2[1] - d1[1] * d2[0]
        s = ((x - xy[0][0]) * d2[1] - (y - xy[0][1]) * d2[0]) / det
        u = ((y - xy[0][1]) * d1[0] - (x - xy[0][0]) * d1[1]) / det
        w = np.array([1 - s - u, s, u])
        return float(w @ d[:, 0]), float(w @ d[:, 1])

    def get_point_values(self, x: float, y: float) -> dict:
        t = self.find_element(x, y)
        if t < 0:
            return {}
        tri = self.mesh.elements[t]
        xy = self.mesh.nodes[tri]
        d1 = xy[1] - xy[0]
        d2 = xy[2] - xy[0]
        det = d1[0] * d2[1] - d1[1] * d2[0]
        s = ((x - xy[0][0]) * d2[1] - (y - xy[0][1]) * d2[0]) / det
        u = ((y - xy[0][1]) * d1[0] - (x - xy[0][0]) * d1[1]) / det
        V = ((1 - s - u) * self.V[tri[0]] + s * self.V[tri[1]]
             + u * self.V[tri[2]])
        # smoothed D like the reference default (getPointD w/ Smooth);
        # E recovered from the smoothed D through the local material
        if self.smoothing:
            Dx, Dy = self._point_D(x, y, t)
        else:
            Dx, Dy = self.Dx[t], self.Dy[t]
        out = {"V": V, "Dx": Dx, "Dy": Dy,
               "Ex": Dx / self.kx[t], "Ey": Dy / self.ky[t],
               "Kx": self.kx[t], "Ky": self.ky[t]}
        if self.mode == "heat":
            # point K is evaluated at the interpolated temperature and
            # G recomputed as F/K (hpproc.cpp:330-363 getPointValues)
            kx, ky = self.mats[self.blk[t]].get_k(V)
            aecf = self._aecf()[t]
            kx /= aecf
            ky /= aecf
            out.update(T=V, Fx=Dx, Fy=Dy, Kx=kx, Ky=ky,
                       Gx=Dx / kx, Gy=Dy / ky)
        return out

    # ------------------------------------------------------------------ #
    def _vol(self):
        if self.axi:
            R = self.ctr[:, 0] * self.lc
            return self.area_m2 * 2.0 * PI * R
        return self.area_m2 * self.depth

    def block_integral(self, inttype: int, selected_labels) -> float:
        sel = np.isin(self.mesh.element_labels, list(selected_labels))
        vol = self._vol()
        if inttype == 1:
            return float(self.area_m2[sel].sum())
        if inttype == 2:
            return float(vol[sel].sum())
        if self.mode == "heat":
            # 0 avg T, 3 avg F, 4 avg G (complex packs x+iy); averages
            # divide by the selected volume (hpproc.cpp:640-643)
            if inttype == 0:
                Tn = self.V[self.mesh.elements].mean(axis=1)
                return float((vol[sel] * Tn[sel]).sum() / vol[sel].sum())
            if inttype == 3:
                z = (vol[sel] * (self.Dx[sel] + 1j * self.Dy[sel])).sum()
                return complex(z / vol[sel].sum())
            if inttype == 4:
                z = (vol[sel] * (self.Ex[sel] + 1j * self.Ey[sel])).sum()
                return complex(z / vol[sel].sum())
        else:
            # 0 stored energy, 3 D, 4 E (epproc.cpp:289-330)
            if inttype == 0:
                e = self.Dx * self.Ex + self.Dy * self.Ey
                return float((vol[sel] * e[sel]).sum() / 2.0)
            if inttype == 3:
                return complex((vol[sel] * (self.Dx[sel]
                                            + 1j * self.Dy[sel])).sum())
            if inttype == 4:
                return complex((vol[sel] * (self.Ex[sel]
                                            + 1j * self.Ey[sel])).sum())
        raise NotImplementedError(f"block integral {inttype}")

    # ------------------------------------------------------------------ #
    def line_integral(self, inttype: int, contour) -> tuple:
        """Contour integrals over a polyline in problem units
        (hpproc.cpp:648-780). Types: 0 potential drop, 1 normal flux
        (total, average), 2 length (length, surface area), 3 average
        potential."""
        pts = [complex(x, y) for x, y in contour]
        if inttype == 0:
            a = self.get_point_values(pts[0].real, pts[0].imag)
            b = self.get_point_values(pts[-1].real, pts[-1].imag)
            return (a.get("V", 0.0) - b.get("V", 0.0),)
        if inttype == 2:
            L = sum(abs(pts[i + 1] - pts[i]) for i in range(len(pts) - 1))
            L *= self.lc
            if self.axi:
                S = sum(PI * (pts[i].real + pts[i + 1].real)
                        * abs(pts[i + 1] - pts[i])
                        for i in range(len(pts) - 1)) * self.lc ** 2
            else:
                S = L * self.depth
            return (L, S)
        total = 0.0
        weight = 0.0
        for k in range(1, len(pts)):
            seg = pts[k] - pts[k - 1]
            dz = abs(seg) / LINE_INTEGRAL_POINTS
            tvec = seg / abs(seg)
            nvec = 1j * tvec
            for i in range(LINE_INTEGRAL_POINTS):
                u = (i + 0.5) / LINE_INTEGRAL_POINTS
                pt = pts[k - 1] + u * seg
                if inttype == 1:
                    pt += nvec * 1e-06
                vals = self.get_point_values(pt.real, pt.imag)
                if not vals:
                    continue
                if self.axi:
                    d = 2.0 * PI * pt.real * self.lc ** 2
                else:
                    d = self.depth * self.lc
                if inttype == 1:
                    Fn = (vals["Dx"] * nvec.real + vals["Dy"] * nvec.imag)
                    total += Fn * dz * d
                    weight += dz * d
                else:  # 3: average potential
                    total += vals["V"] * dz
                    weight += dz
        if weight == 0:
            return (total, 0.0)
        return (total, total / weight) if inttype == 1 else (total / weight,)


class HeatPostProcessor(ScalarPostProcessor):
    def __init__(self, problem, mesh, T, node_bc=None):
        super().__init__(problem, mesh, T, "heat", node_bc=node_bc)


class ElecPostProcessor(ScalarPostProcessor):
    def __init__(self, problem, mesh, V, node_bc=None):
        super().__init__(problem, mesh, V, "electro", node_bc=node_bc)
