"""Planar AC magnetics with eddy currents: the ACwound test problem of
this repository's fixtures (``tests/fixtures/ACwound.fem``, whose golden
answer the unmodified upstream xfemm fsolver gave; ACtest.fem with its
solid copper bar wound as a coil): a 100-turn coil of 1 mm magnet wire
in a series circuit carrying 10 A, beside a linear steel bar (mu_r
1000, 4 MS/m) and an aluminium bar (35 MS/m) that carries a source
current density of its own, in a 20 cm square air box with A = 0 on
its edge. Lengths in cm, as in the source.

A frozen copy of the source's geometry, materials and circuit. Its
parameters: ``freq`` (Hz), ``precision``, ``min_angle``, and the mesh:
``max_area`` (each label's MaxArea in cm^2, the source's),
``target_nodes``, which raises the mesh density to about that many
nodes by one factor on every label's MaxArea (``SCALE_NODES`` /
``target_nodes``), and ``skin_freq``, which caps each eddy-current
region's MaxArea at the equilateral triangle whose side is half its
skin depth at that frequency.
"""

from __future__ import annotations

import math

import numpy as np

from ..reference.harmonic import MU0, Harmonic, gap, wound_mu_r
from ..reference.harmonic import solve as harmonic_solve

#: block labels in the order of the problem's label list
LABELS = ("air", "coil", "steel", "alum")
#: the source's rectangles (x0, y0, x1, y1), cm, and label points
BOX = 10.0
RECTS = {"coil": (-1.0, -2.0, 1.0, 2.0), "steel": (3.0, -4.0, 4.0, 4.0),
         "alum": (-5.0, -1.0, -4.0, 1.0)}
POINTS = ((8.0, 8.0), (0.0, 0.0), (3.5, 0.0), (-4.5, 0.0))
#: the source's materials, in its order: (name, mu_r, sigma MS/m,
#: J MA/m^2, LamType, NStrands, WireD mm); the label list uses Air,
#: Coil, LinSteel and Alum (the source's Copper is unused)
MATERIALS = (("Air", 1.0, 0.0, 0j, 0, 0, 0.0),
             ("Copper", 1.0, 58.0, 0j, 0, 0, 0.0),
             ("LinSteel", 1000.0, 4.0, 0j, 0, 0, 0.0),
             ("Alum", 1.0, 35.0, 1.0 + 0.5j, 0, 0, 0.0),
             ("Coil", 1.0, 58.0, 0j, 3, 1, 1.0))
BLOCK = {"air": 0, "coil": 4, "steel": 2, "alum": 3}
#: the series circuit's current (A) and the coil's turns
AMPS, TURNS = 10.0, 100
#: elements across a skin depth at ``skin_freq``
SKIN_ELEMENTS = 2.0
#: the node count the source's own MaxAreas give, about (the factor on
#: them is SCALE_NODES / target_nodes)
SCALE_NODES = 6250.0


def skin_depth_cm(freq: float, mu_r: float, sigma: float) -> float:
    """The skin depth sqrt(2 / (omega mu sigma)), cm, of a conductor of
    conductivity ``sigma`` (MS/m) at ``freq`` Hz."""
    w = 2.0 * math.pi * freq
    return 100.0 * math.sqrt(2.0 / (w * MU0 * mu_r * sigma * 1e6))


def label_areas(params: dict) -> list:
    """Each label's MaxArea (cm^2), in LABELS order: the source's times
    SCALE_NODES / target_nodes, an eddy-current region's at most the
    equilateral triangle of side skin depth / SKIN_ELEMENTS at
    skin_freq."""
    scale = SCALE_NODES / max(params["target_nodes"], 100)
    out = []
    for name in LABELS:
        a = params["max_area"][name] * scale
        _n, mu_r, sigma, _j, lam, _s, _d = MATERIALS[BLOCK[name]]
        if sigma > 0 and lam < 3:
            side = skin_depth_cm(params["skin_freq"], mu_r, sigma) \
                / SKIN_ELEMENTS
            a = min(a, math.sqrt(3.0) / 4.0 * side * side)
        out.append(a)
    return out


def max_area(params: dict) -> float:
    """The largest label's MaxArea, cm^2."""
    return max(label_areas(params))


def build(params: dict):
    """The problem document, through the program's geometry classes."""
    from xfemm_tpu_torch.constants import FileType, LengthUnit, ProblemType
    from xfemm_tpu_torch.geometry.problem import (BlockLabel, BoundaryProp,
                                                  Circuit, Problem, Segment)
    from xfemm_tpu_torch.materials.magnetic import MagneticMaterial

    p = Problem(filetype=FileType.MAGNETICS)
    p.Frequency = params["freq"]
    p.Precision = params["precision"]
    p.MinAngle = params["min_angle"]
    p.Depth = 1.0
    p.LengthUnits = LengthUnit.CENTIMETERS
    p.ProblemType = ProblemType.PLANAR
    p.DoSmartMesh = False
    p.blockproplist = [
        MagneticMaterial(name=n, mu_x=mu, mu_y=mu, Cduct=sig, J=j,
                         LamType=lam, NStrands=ns, WireD=wd)
        for n, mu, sig, j, lam, ns, wd in MATERIALS]
    p.lineproplist = [BoundaryProp(name="A0", BdryFormat=0)]
    p.circproplist = [Circuit(name="I1", Amps=complex(AMPS), CircType=1)]
    s = BOX
    rects = [(-s, -s, s, s)] + [RECTS[k] for k in LABELS[1:]]
    for k, (x0, y0, x1, y1) in enumerate(rects):
        c = [p.add_node(x, y) for x, y in ((x0, y0), (x1, y0), (x1, y1),
                                           (x0, y1))]
        for i in range(4):
            p.linelist.append(Segment(n0=c[i], n1=c[(i + 1) % 4],
                                      BoundaryMarker=0 if k == 0 else -1))
    p.labellist = [
        BlockLabel(x=x, y=y, BlockType=BLOCK[name], MaxArea=a,
                   InCircuit=0 if name == "coil" else -1,
                   Turns=TURNS if name == "coil" else 1)
        for name, (x, y), a in zip(LABELS, label_points(params),
                                   label_areas(params))]
    return p


def label_points(params: dict):
    """(x, y) of each block label, cm, in LABELS order."""
    return list(POINTS)


def region_areas(params: dict):
    """The area of each labelled region, cm^2, in LABELS order."""
    rect = [(x1 - x0) * (y1 - y0) for x0, y0, x1, y1 in
            (RECTS[k] for k in LABELS[1:])]
    return [(2.0 * BOX) ** 2 - sum(rect)] + rect


def fixed_nodes(params: dict, nodes) -> np.ndarray:
    """The Dirichlet nodes: those on the box's outer edge."""
    xy = np.asarray(nodes, np.float64)
    return ((np.abs(np.abs(xy[:, 0]) - BOX) <= 1e-12 * BOX)
            | (np.abs(np.abs(xy[:, 1]) - BOX) <= 1e-12 * BOX))


def reference(params: dict, nodes, elements, element_labels):
    """The plain reference's problem on a mesh (node coordinates in cm,
    counter-clockwise elements, each element's index into LABELS), in
    SI units: the coil carries turns x amps over its meshed area with
    the winding's permeability, the steel and the aluminium their eddy
    currents, the aluminium its own source density besides."""
    lbl = np.asarray(element_labels)
    xy = 0.01 * np.asarray(nodes, np.float64)
    tris = np.asarray(elements)
    v = xy[tris]
    area = 0.5 * np.abs((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
                        - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1]))
    coil = LABELS.index("coil")
    a_coil = float(area[lbl == coil].sum())
    mu_r = np.ones(len(lbl), np.complex128)
    sigma = np.zeros(len(lbl))
    J = np.zeros(len(lbl), np.complex128)
    for k, name in enumerate(LABELS):
        _n, mu, sig, j, lam, ns, wd = MATERIALS[BLOCK[name]]
        sel = lbl == k
        if lam == 3:
            mu_r[sel] = wound_mu_r(params["freq"], 1e6 * sig, 1e-3 * wd, ns,
                                   TURNS, a_coil)
            J[sel] = TURNS * AMPS / a_coil
        else:
            mu_r[sel] = mu
            sigma[sel] = 1e6 * sig
            J[sel] = 1e6 * j
    return Harmonic(xy=xy, tris=tris, mu_r=mu_r, sigma=sigma, J=J,
                    freq=params["freq"], fixed=fixed_nodes(params, nodes),
                    fixed_vals=np.zeros(len(xy), np.complex128))


def answer(solution):
    """The nodal unknown of the program's solution: complex A, Wb/m."""
    return np.asarray(solution.A, np.complex128)


judge = gap
#: the reference's own solve (the control runs it in complex64)
reference_solve = harmonic_solve
