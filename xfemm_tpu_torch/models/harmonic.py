"""Time-harmonic (AC) planar magnetics: the two host helpers the
postprocessor needs.

``_proximity_mu`` (the reference's GetFillFactor wound-region
permeability, fsolver.cpp:1083-1196) and ``_effective_mu`` (hysteresis
lag and laminated skin depth, harmonic2d.cpp:176-215) are pure numpy /
cmath; ``post/fpproc.py`` evaluates AC solutions read from ``.ans``
files with them. The AC ``solve`` (the JAX package's
``models/harmonic.py``) comes with ROADMAP item A.3; until then
``models.solve`` raises for AC problems.
"""

from __future__ import annotations

import cmath
import math

from ..constants import DEG, MU0, PI
from ..geometry.problem import Problem


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
