"""Planar nonlinear magnetostatics: a steel cylinder between two opposed
coils in a square air box with A = 0 on its outer edge.

A frozen copy of the program's synthetic benchmark problem
(``models/benchprob.build``) with its dimensions as parameters: ``box``
(half width, m), ``r`` (steel radius), ``x0`` / ``x1`` (the coils' inner
and outer x), ``coil_half_height``, ``J`` (Coil+ current density, MA/m^2;
Coil- carries -J), ``target_nodes`` (sets every label's MaxArea),
``precision``, ``min_angle``, ``arc_deg`` (the arcs' MaxSideLength),
``air_label`` and ``steel_bh`` ((B, H) points).
"""

from __future__ import annotations

import math

import numpy as np

from ..reference import bh
from ..reference.magnetostatic import Magnetostatic, gap
from ..reference.magnetostatic import solve as magnetostatic_solve

#: block labels in the order of the problem's label list
LABELS = ("air", "steel", "coil+", "coil-")


def max_area(params: dict) -> float:
    """The area constraint of ``models/benchprob.build(target_nodes)``:
    the refiner's calibrated 0.857 of the box area per target node."""
    return 0.857 * (2.0 * params["box"]) ** 2 / max(params["target_nodes"],
                                                    100)


def build(params: dict):
    """The problem document, through the program's geometry classes."""
    from xfemm_tpu_torch.constants import FileType, LengthUnit, ProblemType
    from xfemm_tpu_torch.geometry.problem import (ArcSegment, BlockLabel,
                                                  BoundaryProp, PointProp,
                                                  Problem, Segment)
    from xfemm_tpu_torch.materials.magnetic import MagneticMaterial

    p = Problem(filetype=FileType.MAGNETICS)
    p.Frequency = 0.0
    p.Precision = params["precision"]
    p.MinAngle = params["min_angle"]
    p.Depth = 1.0
    p.LengthUnits = LengthUnit.METERS
    p.ProblemType = ProblemType.PLANAR
    p.DoSmartMesh = False

    air = MagneticMaterial(name="Air")
    steel = MagneticMaterial(name="Steel")
    for b, h in params["steel_bh"]:
        steel.Bdata.append(b)
        steel.Hdata.append(complex(h))
    J = params["J"]
    p.blockproplist = [air, steel, MagneticMaterial(name="Coil+", J=J),
                       MagneticMaterial(name="Coil-", J=-J)]
    p.lineproplist = [BoundaryProp(name="A0", BdryFormat=0)]
    p.nodeproplist = [PointProp(name="origin")]

    s = params["box"]
    ids = [p.add_node(x, y) for x, y in ((-s, -s), (s, -s), (s, s), (-s, s))]
    for i in range(4):
        p.linelist.append(Segment(n0=ids[i], n1=ids[(i + 1) % 4],
                                  BoundaryMarker=0))
    r = params["r"]
    a = p.add_node(r, 0.0)
    b = p.add_node(-r, 0.0)
    p.arclist.append(ArcSegment(n0=a, n1=b, ArcLength=180,
                                MaxSideLength=params["arc_deg"]))
    p.arclist.append(ArcSegment(n0=b, n1=a, ArcLength=180,
                                MaxSideLength=params["arc_deg"]))
    h = params["coil_half_height"]
    for sgn in (1, -1):
        x0, x1 = params["x0"] * sgn, params["x1"] * sgn
        c = [p.add_node(x0, -h), p.add_node(x1, -h), p.add_node(x1, h),
             p.add_node(x0, h)]
        for i in range(4):
            p.linelist.append(Segment(n0=c[i], n1=c[(i + 1) % 4]))
    ma = max_area(params)
    p.labellist = [BlockLabel(x=x, y=y, BlockType=k, MaxArea=ma)
                   for k, (x, y) in enumerate(label_points(params))]
    return p


def label_points(params: dict):
    """(x, y) of each block label, in LABELS order."""
    xc = (params["x0"] + params["x1"]) / 2.0
    return [tuple(params["air_label"]), (0.0, 0.0), (xc, 0.0), (-xc, 0.0)]


def region_areas(params: dict):
    """The area of each labelled region, in LABELS order: the steel
    region is the polygon of the arcs' chords (each half arc in
    ceil(180 / arc_deg) equal chords), the coils are rectangles."""
    k = 2 * math.ceil(180.0 / params["arc_deg"])
    r = params["r"]
    steel = 0.5 * k * r * r * math.sin(2.0 * math.pi / k)
    coil = (params["x1"] - params["x0"]) * 2.0 * params["coil_half_height"]
    box = (2.0 * params["box"]) ** 2
    return [box - steel - 2.0 * coil, steel, coil, coil]


def fixed_nodes(params: dict, nodes) -> np.ndarray:
    """The Dirichlet nodes: those on the box's outer edge."""
    xy = np.asarray(nodes, np.float64)
    s = params["box"]
    return ((np.abs(np.abs(xy[:, 0]) - s) <= 1e-12 * s)
            | (np.abs(np.abs(xy[:, 1]) - s) <= 1e-12 * s))


def reference(params: dict, nodes, elements, element_labels):
    """The plain reference's problem on a mesh (node coordinates in m,
    counter-clockwise elements, each element's index into LABELS)."""
    lbl = np.asarray(element_labels)
    J = 1e6 * params["J"] * np.array([0.0, 0.0, 1.0, -1.0])[lbl]
    curve = np.where(lbl == 1, 0, -1)
    xy = np.asarray(nodes, np.float64)
    fixed = fixed_nodes(params, xy)
    B, H = zip(*params["steel_bh"])
    T = len(lbl)
    return Magnetostatic(
        xy=xy, tris=np.asarray(elements), mu_r=np.ones(T), curve=curve,
        J=J, Hc=np.zeros(T), magdir=np.zeros(T), fixed=fixed,
        fixed_vals=np.zeros(len(xy)), curves=[bh.Curve(B, H)])


def answer(solution):
    """The nodal unknown of the program's solution: A, Wb/m."""
    return np.asarray(solution.A, np.float64)


judge = gap
#: the reference's own solve (the control runs it in float32)
reference_solve = magnetostatic_solve
