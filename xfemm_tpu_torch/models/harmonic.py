"""Time-harmonic (AC) planar magnetics with eddy currents on PyTorch.

Functional equivalent of the reference's ``FSolver::Harmonic2D``
(cfemm/fsolver/harmonic2d.cpp:38-890): complex-valued vector potential,
frequency-dependent effective permeability for laminations (mu tanh(K)/K
with skin-depth K) and hysteresis lag angles, consistent eddy-current mass
term -j*w*sigma*a*c/12, small-skin-depth impedance boundaries, proximity-
effect permeability for wound regions (fsolver.cpp:1083 GetFillFactor),
air-gap elements, and circuit Case 2: per-circuit voltage-gradient DOFs
appended after the node DOFs, coupled through -j*w*sigma*c terms with a
total-current RHS.

Sign convention: the reference's harmonic global system is the negative
of its DC one; this module negates it back so the element blocks and RHS
scatter reuse the planar DC machinery. The nonlinear path is the
reference's default successive approximation (ACSolver==0) with mu
averaged from the doctored AC B-H curve. Assembly is host f64
(complex128); every linear solve goes to ``solver.solve_complex`` (the
card's f32 (re, im) band GMRES or Jacobi pairs CG). The per-element
circuit loops of the JAX package's model are vectorised here
(``_circuit_cases``, ``_circuit_terms``, ``_label_case``).
"""

from __future__ import annotations

import cmath
import math

import numpy as np

from ..constants import C_APOT, DEG, MU0, PI, ProblemType
from ..geometry.problem import Problem
from ..mesh.meshdata import MeshData
from ..ops import assembly, solver
from ..ops.solver import ElementBlock
from ..parallel import driver as dd_driver
from ..utils.profiling import phase
from .magnetostatics import MagSolution, pack


def _hermite_complex(B, Bd, Hd, Sl):
    """Complex cubic-Hermite H(B) and dH/dB on doctored AC knots
    (CMaterialProp::GetH semantics with complex Hdata/slope)."""
    k = np.searchsorted(Bd, B, side="right") - 1
    k = np.clip(k, 0, len(Bd) - 2)
    B0, B1 = Bd[k], Bd[k + 1]
    H0, H1 = Hd[k], Hd[k + 1]
    s0, s1 = Sl[k], Sl[k + 1]
    l = B1 - B0
    z = (B - B0) / l
    z2 = z * z
    h = ((1 - 3 * z2 + 2 * z2 * z) * H0
         + z * (1 - 2 * z + z2) * l * s0
         + z2 * (3 - 2 * z) * H1
         + z2 * (z - 1) * l * s1)
    dh = (6 * z * (z - 1) * H0 / l
          + (1 - 4 * z + 3 * z2) * s0
          + 6 * z * (1 - z) * H1 / l
          + z * (3 * z - 2) * s1)
    # beyond the last knot: linear extension with the final slope
    out = B > Bd[-1]
    h = np.where(out, Hd[-1] + Sl[-1] * (B - Bd[-1]), h)
    dh = np.where(out, Sl[-1] + 0 * dh, dh)
    return h, dh


def _proximity_mu(problem: Problem, lab, mat, atot: float) -> complex:
    """GetFillFactor's frequency-dependent wound-region permeability
    (fsolver.cpp:1083-1196)."""
    if problem.Frequency == 0 or mat.LamType < 3:
        return 1.0
    if atot == 0 or mat.Cduct == 0:
        return 1.0
    wiretype = mat.LamType - 3
    W = 2.0 * PI * problem.Frequency
    if wiretype == 3:                    # rectangular wire
        d = mat.WireD * 0.001
        fill = abs(d * d * lab.Turns / atot)
        dd = d / math.sqrt(fill)
        fill = d / dd
        o = mat.Cduct * (d / dd) * 1e6
        k = cmath.sqrt(1j * W * o * MU0) * d / 2.0
        ufd = MU0 * cmath.tanh(k) / k
        return (fill * ufd + (1.0 - fill) * MU0) / MU0
    if wiretype == 0:
        R = mat.WireD * 0.0005
        awire = PI * R * R * mat.NStrands * lab.Turns
    elif wiretype == 1:
        R = mat.WireD * 0.0005 * math.sqrt(mat.NStrands)
        awire = PI * R * R * lab.Turns
    elif wiretype == 2:
        R = mat.WireD * 0.0005
        awire = PI * R * R * mat.NStrands * lab.Turns
    else:
        R = mat.WireD * 0.0005
        awire = PI * R * R * mat.NStrands * lab.Turns
    fill = abs(awire / atot)
    o = mat.Cduct * 1e6
    W = 2.0 * PI * problem.Frequency * o * MU0 * R * R / 2.0
    if wiretype in (0, 1, 2):
        c1 = 0.7756067409818643 + fill * (0.6873854335408803 + fill * (
            0.06841584481674128 - 0.07143732702512284 * fill))
        c2 = 1.5 * fill / c1
    elif wiretype == 4:                  # 10% CCA
        c1 = 0.7270741505617485 + 0.8902950067721367 * fill \
            + 0.11894736885885195 * fill ** 2 - 0.12247276254503957 * fill ** 3
        c2 = 0.006784920229549677 + 1.8942880489198526 * fill \
            - 1.3631438759519217 * fill ** 2 + 0.504431701685587 * fill ** 3
    else:                                # 15% CCA
        c1 = 0.7486913529860821 + 0.9042845510838825 * fill \
            + 0.1361040321433224 * fill ** 2 - 0.10652380745682069 * fill ** 3
        c2 = 0.006790468527313965 + 1.8945509985370095 * fill \
            - 1.3643501010185972 * fill ** 2 + 0.5036765577982594 * fill ** 3
    sq = cmath.sqrt(c1 * 1j * W)
    return c2 * (cmath.tanh(sq) / sq) + (1.0 - c2)


def _effective_mu(problem: Problem, mat) -> tuple[complex, complex]:
    """Per-blockprop effective permeability: hysteresis lag + laminated
    skin-depth correction (harmonic2d.cpp:176-215)."""
    w = problem.Frequency * 2.0 * PI
    if mat.LamType != 0:
        return 1.0, 1.0
    mux = mat.mu_x * cmath.exp(-1j * mat.Theta_hx * DEG)
    muy = mat.mu_y * cmath.exp(-1j * mat.Theta_hy * DEG)
    if mat.Lam_d != 0:
        f = mat.LamFill
        if mat.Cduct != 0:
            deg45 = 1 + 1j
            half = cmath.exp(-1j * mat.Theta_hx * DEG / 2.0)
            ds = math.sqrt(2.0 / (0.4 * PI * w * mat.Cduct * mat.mu_x))
            K = half * deg45 * mat.Lam_d * 0.001 / (2.0 * ds)
            mux = (mux * cmath.tanh(K) / K) * f + (1.0 - f)
            half = cmath.exp(-1j * mat.Theta_hy * DEG / 2.0)
            ds = math.sqrt(2.0 / (0.4 * PI * w * mat.Cduct * mat.mu_y))
            K = half * deg45 * mat.Lam_d * 0.001 / (2.0 * ds)
            muy = (muy * cmath.tanh(K) / K) * f + (1.0 - f)
        else:
            mux = mux * f + (1.0 - f)
            muy = muy * f + (1.0 - f)
    return mux, muy


class ACSetup:
    """The material and circuit arrays both AC models share: per-label
    wound flags and proximity permeabilities, per-element conductivity
    and effective permeabilities, and the circuit cases with the
    case-2 DOF slots."""

    def __init__(self, problem: Problem, pk, area, w: float, circ_weight):
        labels = [l for l in problem.labellist if not l.is_hole()]
        mats = problem.blockproplist
        self.labels = labels
        if (np.isin(pk.lam_type, (1, 2))).any():
            raise ValueError("On-edge lamination not supported in AC "
                             "analyses")
        # per-label wound/proximity data (GetFillFactor); element areas
        # in m^2 (coords are cm -> 1e-4)
        atot = np.bincount(pk.lbl, weights=np.abs(area) * 1e-4,
                           minlength=len(labels))
        is_wound = np.array([abs(l.Turns) > 1 or mats[l.BlockType].LamType
                             > 2 for l in labels], bool)
        prox_mu = np.array([_proximity_mu(problem, l, mats[l.BlockType],
                                          atot[k])
                            for k, l in enumerate(labels)], complex)
        el_wound = is_wound[pk.lbl]
        m_cd = np.array([m.Cduct for m in mats])
        m_lamd = np.array([m.Lam_d for m in mats])
        self.sigma_raw = m_cd[pk.blk]
        self.sigma_circ = np.where(el_wound, 0.0, self.sigma_raw)
        self.Jc_block = pk.Jre + 1j * pk.Jim
        # effective permeability per block property; wound LamType>2
        # regions take the proximity value (harmonic2d.cpp:664-668)
        eff = np.array([_effective_mu(problem, m) for m in mats],
                       complex).reshape(len(mats), 2)
        lam_gt2 = pk.lam_type > 2
        self.mu1 = np.where(lam_gt2, prox_mu[pk.lbl], eff[pk.blk, 0])
        self.mu2 = np.where(lam_gt2, prox_mu[pk.lbl], eff[pk.blk, 1])
        # eddy conductivity: zero for wound coils and in-plane laminated
        # blocks (harmonic2d.cpp:481-489)
        lam_inplane = (pk.lam_type == 0) & (m_lamd[pk.blk] > 0)
        self.sigma_eddy = np.where(el_wound | lam_inplane, 0.0,
                                   self.sigma_raw)
        self.case, self.circJ, self.circdV = _circuit_cases(
            pk, area, self.sigma_circ * circ_weight, self.Jc_block)
        self.case2_ids = [k for k in range(len(pk.circuits))
                          if self.case[k] == 2]
        self.case2_slot = np.full(len(pk.circuits), -1, np.int64)
        self.case2_slot[self.case2_ids] = pk.nreduced + np.arange(
            len(self.case2_ids))
        self.ntot = pk.nreduced + len(self.case2_ids)
        # each element's circuit case (-1 outside circuits)
        ci = pk.circuit
        has = ci >= 0
        self.el_case = (np.where(has, self.case[np.where(has, ci, 0)], -1)
                        if len(pk.circuits) else np.full(len(ci), -1))
        self.c2_el = np.nonzero(self.el_case == 2)[0]


def _circuit_cases(pk, area, sigma_w, Jc_block):
    """Circuit case selection (harmonic2d.cpp:95-168 and
    harmonicaxi.cpp:86-160, where ``sigma_w`` carries the geometry's
    conductivity weight): a current-driven circuit with no conducting
    area is Case 1 (a source density J), one with conductors Case 2 (a
    voltage-gradient DOF), a voltage-driven one Case 0. Returns
    (case, circJ, circdV)."""
    nc = len(pk.circuits)
    case = np.zeros(nc, np.int64)
    circJ = np.zeros(nc, complex)
    circdV = np.zeros(nc, complex)
    if not nc:
        return case, circJ, circdV
    has = pk.circuit >= 0
    ci = pk.circuit[has]
    a_s = area[has]
    i1 = np.bincount(ci, weights=a_s, minlength=nc)
    i2 = np.bincount(ci, weights=a_s * sigma_w[has], minlength=nc)
    w3 = Jc_block[has] * a_s * 100.0
    i3 = (np.bincount(ci, weights=w3.real, minlength=nc)
          + 1j * np.bincount(ci, weights=w3.imag, minlength=nc))
    for k, circ in enumerate(pk.circuits):
        if circ.CircType == 0:
            if i2[k] == 0:
                case[k] = 1
                amps = complex(circ.Amps)
                circJ[k] = 0.0 if i1[k] == 0 else \
                    0.01 * (amps - i3[k]) / i1[k]
            else:
                case[k] = 2
        else:
            case[k] = 0
            circdV[k] = complex(circ.dVolts)
    return case, circJ, circdV


def _circuit_source(pk, ac: ACSetup, dv_weight):
    """Element circuit source density Jv: the circuit's J for Case 1,
    -dV sigma times ``dv_weight`` for Case 0 (raw blockprop sigma,
    harmonic2d.cpp:526-533), zero elsewhere."""
    if not len(pk.circuits):
        return np.zeros(len(pk.circuit), complex)
    ci = np.where(pk.circuit >= 0, pk.circuit, 0)
    return np.where(ac.el_case == 1, ac.circJ[ci],
                    np.where(ac.el_case == 0,
                             -ac.circdV[ci] * ac.sigma_raw * dv_weight, 0.0))


def _label_case(pk, ac: ACSetup, first: bool):
    """Per-label circuit results (case, value): (1, J) for Case 1, (0,
    dV) for Cases 0 and 2, (1, 0) for a label outside any circuit. Each
    label takes the circuit of its first element (``first``, the planar
    model's WriteHarmonic2D:969-994) or of its last (the axisymmetric
    model's)."""
    labels = ac.labels
    lbl = pk.lbl if first else pk.lbl[::-1]
    uniq, pos = np.unique(lbl, return_index=True)
    el_of = dict(zip(uniq.tolist(), pos.tolist()))
    circ = pk.circuit if first else pk.circuit[::-1]
    label_case = np.zeros((len(labels), 2), complex)
    for k in range(len(labels)):
        ci = int(circ[el_of[k]]) if k in el_of else -1
        if ci < 0:
            label_case[k] = (1, 0.0)
        elif ac.case[ci] == 1:
            label_case[k] = (1, ac.circJ[ci])
        else:
            label_case[k] = (0, ac.circdV[ci])
    return label_case


def _edge_blocks(pk, c: float, w: float, ssd_scale):
    """Robin and small-skin-depth impedance edges as complex 2x2 blocks
    (pack folded the axisymmetric 2r loop factor into the Robin
    coefficients; ``ssd_scale(a, b)`` is that factor for the impedance
    edges)."""
    blocks = []
    if pk.robin:
        idx = np.array([[pk.ridx[a], pk.ridx[b]] for (a, b), *_ in pk.robin])
        sgn = np.array([[pk.rsign[a], pk.rsign[b]]
                        for (a, b), *_ in pk.robin])
        mb = np.zeros((len(pk.robin), 2, 2), complex)
        for i, (_, length, c0, c1, mult) in enumerate(pk.robin):
            Km = -0.0001 * c * complex(c0) * length / 6.0
            mb[i] = -mult * Km * np.array([[2.0, 1.0], [1.0, 2.0]])
        blocks.append(ElementBlock(idx=idx, sign=sgn, mat=mb))
    if pk.ssd:
        idx = np.array([[pk.ridx[a], pk.ridx[b]] for (a, b), *_ in pk.ssd])
        sgn = np.array([[pk.rsign[a], pk.rsign[b]] for (a, b), *_ in pk.ssd])
        mb = np.zeros((len(pk.ssd), 2, 2), complex)
        for i, ((a, bb), length, Sig, Mu, mult) in enumerate(pk.ssd):
            ds = math.sqrt(2.0 / (0.4 * PI * w * Sig * Mu))
            Km = (1 + 1j) / (-ds * Mu * 100.0) * (ssd_scale(a, bb)
                                                  * length / 6.0)
            mb[i] = -mult * Km * np.array([[2.0, 1.0], [1.0, 2.0]])
        blocks.append(ElementBlock(idx=idx, sign=sgn, mat=mb))
    return blocks


def _c2_blocks(pk, ac: ACSetup, K, Kdiag):
    """Case-2 coupling blocks: each element of a case-2 circuit couples
    its three nodes to the circuit's DOF with K/3 and adds Kdiag to the
    DOF's diagonal (negated reference)."""
    sel = ac.c2_el
    if not sel.size:
        return []
    idx = np.zeros((sel.size, 4), np.int64)
    sgn = np.ones((sel.size, 4))
    matsb = np.zeros((sel.size, 4, 4), complex)
    idx[:, :3] = pk.ridx[pk.tris[sel]]
    sgn[:, :3] = pk.rsign[pk.tris[sel]]
    idx[:, 3] = ac.case2_slot[pk.circuit[sel]]
    matsb[:, :3, 3] = (K[sel] / 3.0)[:, None]
    matsb[:, 3, :3] = (K[sel] / 3.0)[:, None]
    matsb[:, 3, 3] = Kdiag[sel]
    return [ElementBlock(idx=idx, sign=sgn, mat=matsb)]


def _rhs_c(pk, be, b_extra, ntot: int):
    """Scatter -be, the extras and the Robin c1 terms (complex)."""
    b = np.zeros(ntot, complex)
    flat_idx = pk.ridx[pk.tris].reshape(-1)
    flat_sgn = pk.rsign[pk.tris].reshape(-1)
    np.add.at(b, flat_idx, -flat_sgn * be.reshape(-1))
    b = b + b_extra
    for (a, bb), length, c0, c1, mult in pk.robin:
        Kb = (complex(c1) * length / 2.0) * 0.0001 * mult
        b[pk.ridx[a]] += -pk.rsign[a] * Kb
        b[pk.ridx[bb]] += -pk.rsign[bb] * Kb
    return b


def _nonlinear_mu(B, pk, bh, mu1, mu2, Mn, MxMy):
    """Successive-approximation update of the B-H elements: mu averaged
    from the doctored AC curve, K = 2 murel muinc / (murel + muinc),
    and the Newton-like correction matrix (in place on mu1, mu2, Mn)."""
    for bi, (Bd, Hd, Sl) in bh.items():
        elsel = pk.blk == bi
        Bm = B[elsel]
        h, dh = _hermite_complex(Bm, Bd, Hd, Sl)
        Bm_safe = np.where(Bm == 0, 1.0, Bm)
        v = np.where(Bm == 0, Sl[0], h / Bm_safe)
        murel = 1.0 / (MU0 * v)
        muinc = 1.0 / (MU0 * dh)
        K = 2.0 * murel * muinc / (murel + muinc)
        mu1[elsel] = K
        mu2[elsel] = K
        Kn = -(1.0 / murel - 1.0 / K)
        Mn[elsel] = Kn[:, None, None] * MxMy[elsel]


def _displacement(V, V_old, nred: int):
    """(|dV|^2, |V|^2) over the node DOFs: the successive-substitution
    displacement is sqrt of their ratio."""
    num = float(np.sum(np.abs(V[:nred] - V_old[:nred]) ** 2))
    den = float(np.sum(np.abs(V[:nred]) ** 2))
    return num, den


def solve(problem: Problem, mesh: MeshData, max_newton: int = 100,
          Aprev=None, devices: int | None = None, device_mesh=None,
          device=None, hbm_bytes: float | None = None) -> MagSolution:
    """Planar AC solve. ``device`` and ``hbm_bytes`` as for
    ``magnetostatics.solve`` (CUDA when omitted; ``"cpu"`` with an
    explicit ``hbm_bytes`` runs the kernels' plain versions).
    ``Aprev`` (or the problem's ``PrevSoln``) makes the B-H elements
    linear with the incremental or frozen complex permeability about
    the previous solution's field. ``devices=N`` runs the
    complex-symmetric solves as a domain decomposition over N parts
    (``parallel/driver.py``, (re, im) pairs with one halo exchange per
    product) on that device or the one device of ``device_mesh``, or one
    part per rank of a process group ``device_mesh``, unless
    the problem has circuit Case-2 DOFs, whose bordered rows couple every
    part: those keep the single-device path, as in the JAX package."""
    assert problem.ProblemType == ProblemType.PLANAR, \
        "harmonic axisymmetric in models/harmonicaxi.py"
    assert problem.Frequency != 0
    if Aprev is None and problem.PrevSoln:
        from .magnetostatics import load_previous
        Aprev = load_previous(problem, mesh)
    with phase("pack"):
        pk = pack(problem, mesh)
    # the host set-up the frequency, materials and circuits fix, before
    # the first element pass
    with phase("ac static setup"):
        c = C_APOT
        w = problem.Frequency * 2.0 * PI
        geom = assembly.tri_geometry(pk.xy, pk.tris)
        Mx, My, Mxy = assembly.curl_matrices(geom)
        T = pk.tris.shape[0]
        area = np.asarray(geom.area)
        mats = problem.blockproplist

        for m in mats:
            if m.BHpoints > 0 and not m.slope:
                if problem.PrevSoln:
                    m.prepare_incremental(w, problem.PrevType)
                else:
                    m.get_slopes(w)

        ac = ACSetup(problem, pk, area, w, 1.0)
        mu1, mu2 = ac.mu1.copy(), ac.mu2.copy()
        ntot = ac.ntot
        # negated ref (-I..)
        eddy_K = 1j * area * w * ac.sigma_eddy * c / 12.0
        M_eddy = eddy_K[:, None, None] * (np.ones((3, 3)) + np.eye(3))[None]

        # fixed DOFs (complex values), extended with case-2 slots (free)
        fixed_mask = np.zeros(ntot, bool)
        fixed_mask[:pk.nreduced] = pk.fixed_mask
        fixed_vals = np.zeros(ntot, complex)
        fixed_vals[:pk.nreduced] = pk.fixed_vals_c

        # static RHS: sources -(J + Jv) a/3 per corner
        Jv = _circuit_source(pk, ac, 1.0)
        src = -(ac.Jc_block + Jv) * area / 3.0
        be_static = np.tile(src[:, None], (1, 3))

        # rhs extras: point currents (+0.01 J, negated ref), case-2 current
        # constraints and element-source sums
        b_extra = np.zeros(ntot, complex)
        b_extra[:pk.nreduced] = pk.b_extra_c
        for k in ac.case2_ids:
            b_extra[ac.case2_slot[k]] -= 0.01 * complex(pk.circuits[k].Amps)
        sel = ac.c2_el
        np.add.at(b_extra, ac.case2_slot[pk.circuit[sel]],
                  -3.0 * (-(ac.Jc_block[sel]) * area[sel] / 3.0))

        # case-2 coupling: nodes to the circuit DOF with +j w sigma c /3,
        # circuit diagonal +j w sigma c (negated ref)
        Kc2 = 1j * area * w * ac.sigma_raw * c
        c2_blocks = _c2_blocks(pk, ac, Kc2, Kc2)

        nonlinear = bool((np.array([m.BHpoints > 0
                                    for m in mats])[pk.blk]).any())
        Mxy_v12 = 0.0
        if Aprev is not None and nonlinear:
            # AC incremental/frozen permeability about the DC offset
            # (harmonic2d.cpp:566-590): B-H elements become linear with a
            # complex tensor permeability
            from .magnetostatics import prev_element_B
            B1p, B2p = prev_element_B(problem, mesh, Aprev)
            v12 = np.zeros(T, complex)
            frozen = problem.PrevType == 2
            for t in np.nonzero(pk.nonlinear)[0]:
                mat = mats[pk.blk[t]]
                B = math.hypot(B1p[t], B2p[t])
                muinc, murel = mat.incremental_permeability_ac(B, w)
                if B == 0:
                    mu1[t] = mu2[t] = muinc
                elif frozen:
                    mu1[t] = mu2[t] = murel
                else:
                    b1s, b2s = B1p[t] ** 2, B2p[t] ** 2
                    B2 = B * B
                    mu1[t] = B2 * muinc * murel / (b1s * murel + b2s * muinc)
                    mu2[t] = B2 * muinc * murel / (b1s * muinc + b2s * murel)
                    v12[t] = -B1p[t] * B2p[t] * (murel - muinc) \
                        / (B2 * murel * muinc)
            Mxy_v12 = Mxy * v12[:, None, None]
            nonlinear = False
        bh = {int(i): mats[i].knot_arrays_complex()
              for i in np.unique(pk.blk) if mats[i].BHpoints > 0}

        # the edge and air-gap blocks do not change between iterations
        static_blocks = _edge_blocks(pk, c, w, lambda a, b: 1.0)
        for nn, age_m in pk.age:
            static_blocks.append(ElementBlock(idx=pk.ridx[nn],
                                              sign=pk.rsign[nn],
                                              mat=age_m.astype(complex)))
        static_blocks.extend(c2_blocks)

        # devices=N: distributed complex-symmetric solves (Jacobi on (re, im)
        # pairs); circuit Case-2 bordered rows keep the single-device path,
        # as in the JAX package
        dsess = dd_driver.session(None if ac.case2_ids else devices,
                                  device_mesh, device, schwarz=False)
        dof_coords_c = np.zeros((ntot, 2))
        dof_coords_c[pk.ridx] = pk.xy

    V = np.zeros(ntot, complex)
    relax = 1.0
    res = 0.0
    lastres = 0.0
    iters_total = 0
    rel_resid = 0.0
    for it in range(max_newton if nonlinear else 1):
        with phase("ac elements"):
            Mn = np.zeros((T, 3, 3), complex)
            be = be_static.copy()
            if it > 0:
                Vl = (pk.rsign[pk.tris] * V[pk.ridx[pk.tris]]).astype(complex)
                B1 = np.sum(Vl * geom.q, axis=1)
                B2 = np.sum(Vl * geom.p, axis=1)
                B = c * np.sqrt(np.abs(B1 * np.conj(B1))
                                + np.abs(B2 * np.conj(B2))) / (0.02 * area)
                _nonlinear_mu(B, pk, bh, mu1, mu2, Mn, Mx + My)
                be = be + np.einsum("tjk,tk->tj", Mn, Vl)
            # M_eddy subtracts: the blocks carry -Me, and the mass term
            # must stay +j w sigma c/12 in the global matrix
            Me = (Mx / mu2[:, None, None] + My / mu1[:, None, None] - M_eddy
                  + Mxy_v12)
            blocks = [ElementBlock(idx=pk.ridx[pk.tris],
                                   sign=pk.rsign[pk.tris], mat=-Me)]
            blocks.extend(static_blocks)
            b = _rhs_c(pk, be, b_extra, ntot)

        V_old = V
        if dsess is not None:
            with phase("distributed solve"):
                V, rel_resid, cg_iters = dsess.solve_complex(
                    blocks, b, fixed_mask, fixed_vals, problem.Precision,
                    x0=V if it > 0 else None, coords=dof_coords_c)
        else:
            V, rel_resid, cg_iters = solver.solve_complex(
                blocks, b, fixed_mask, fixed_vals, problem.Precision,
                x0=V if it > 0 else None, device=device, hbm=hbm_bytes)
        V = np.asarray(V)
        iters_total += int(cg_iters)

        if not nonlinear:
            break
        num, den = _displacement(V, V_old, pk.nreduced)
        if den == 0:
            break
        lastres = res
        res = math.sqrt(num / den)
        if it > 5:
            if res > lastres and relax > 0.1:
                relax /= 2.0
            else:
                relax += 0.1 * (1.0 - relax)
            V = relax * V + (1.0 - relax) * V_old
        if res < 100.0 * problem.Precision and it > 0:
            break

    # solution: A = c*V (complex); case-2 voltage gradients
    Vfull = V[pk.ridx] * pk.rsign
    A = Vfull * c
    for k in ac.case2_ids:
        ac.circdV[k] = 1j * c * w * V[ac.case2_slot[k]]

    return MagSolution(problem=problem, mesh=mesh, A=A,
                       circuits=pk.circuits,
                       label_case=_label_case(pk, ac, first=True),
                       iterations=iters_total, residual=float(rel_resid),
                       newton_iterations=it + 1)
