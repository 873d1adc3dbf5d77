"""Axisymmetric nonlinear magnetostatics: the AxiSolenoid test problem of
this repository's fixtures (``tests/fixtures/AxiSolenoid.fem``, whose
golden answer the unmodified upstream xfemm fsolver gave): a steel rod
on the axis (r <= 1 cm, |z| <= 4 cm; the nine-point B-H curve of
upstream's ``Temp.fem``) inside a coil (2 <= r <= 3 cm, |z| <= 3 cm)
carrying J, in an air region 10 cm in r and 20 cm in z with A = 0 on
its outer edge and on the axis. Lengths in cm, as in the source.

A frozen copy of the source's geometry, materials and boundary, built
in code. Its parameters: ``J`` (the coil's current density, MA/m^2; 3 in
the source), ``precision``, ``min_angle``, ``steel_bh`` ((B, H) points),
the geometry (``box``: the region's r extent and half height; ``rod``:
the rod's radius and half height; ``coil``: the coil's inner and outer
radius and half height; ``label_points``), ``max_area`` (each label's
MaxArea in cm^2, the source's) and ``area_scale``, which multiplies
every label's MaxArea to set the mesh's density.
"""

from __future__ import annotations

import numpy as np

from ..reference import bh
from ..reference.axisymmetric import Axisymmetric, gap
from ..reference.axisymmetric import solve as axisymmetric_solve

#: block labels in the order of the problem's label list
LABELS = ("air", "steel", "coil")


def label_areas(params: dict) -> list:
    """Each label's MaxArea (cm^2), in LABELS order: the source's times
    ``area_scale``."""
    return [params["max_area"][k] * params["area_scale"] for k in LABELS]


def max_area(params: dict) -> float:
    """The largest label's MaxArea, cm^2 (the air's)."""
    return max(label_areas(params))


def build(params: dict):
    """The problem document, through the program's geometry classes."""
    from xfemm_tpu_torch.constants import FileType, LengthUnit, ProblemType
    from xfemm_tpu_torch.geometry.problem import (BlockLabel, BoundaryProp,
                                                  Problem, Segment)
    from xfemm_tpu_torch.materials.magnetic import MagneticMaterial

    p = Problem(filetype=FileType.MAGNETICS)
    p.Frequency = 0.0
    p.Precision = params["precision"]
    p.MinAngle = params["min_angle"]
    p.Depth = 1.0
    p.LengthUnits = LengthUnit.CENTIMETERS
    p.ProblemType = ProblemType.AXISYMMETRIC
    p.DoSmartMesh = False

    steel = MagneticMaterial(name="Steel")
    for b, h in params["steel_bh"]:
        steel.Bdata.append(b)
        steel.Hdata.append(complex(h))
    p.blockproplist = [MagneticMaterial(name="Air"), steel,
                       MagneticMaterial(name="Coil", J=params["J"])]
    p.lineproplist = [BoundaryProp(name="A0", BdryFormat=0)]

    rb, zb = params["box"]
    rr, zr = params["rod"]
    r0, r1, zc = params["coil"]
    # the source's node order: the outer region, the rod, the coil
    for r, z in ((0.0, -zb), (rb, -zb), (rb, zb), (0.0, zb),
                 (0.0, -zr), (rr, -zr), (rr, zr), (0.0, zr),
                 (r0, -zc), (r1, -zc), (r1, zc), (r0, zc)):
        p.add_node(r, z)
    # the outer edge and the axis carry A0; the rod's edge on the axis
    # lies on the axis segment
    for n0, n1, marker in ((0, 1, 0), (1, 2, 0), (2, 3, 0), (3, 0, 0),
                           (4, 5, -1), (5, 6, -1), (6, 7, -1),
                           (8, 9, -1), (9, 10, -1), (10, 11, -1),
                           (11, 8, -1)):
        p.linelist.append(Segment(n0=n0, n1=n1, BoundaryMarker=marker))
    p.labellist = [BlockLabel(x=x, y=y, BlockType=k, MaxArea=a)
                   for k, ((x, y), a) in enumerate(zip(
                       label_points(params), label_areas(params)))]
    return p


def label_points(params: dict):
    """(r, z) of each block label, cm, in LABELS order."""
    return [tuple(params["label_points"][k]) for k in LABELS]


def region_areas(params: dict):
    """The area of each labelled region in the (r, z) half plane, cm^2,
    in LABELS order."""
    rb, zb = params["box"]
    rr, zr = params["rod"]
    r0, r1, zc = params["coil"]
    rod = rr * 2.0 * zr
    coil = (r1 - r0) * 2.0 * zc
    return [rb * 2.0 * zb - rod - coil, rod, coil]


def fixed_nodes(params: dict, nodes) -> np.ndarray:
    """The pinned nodes: those on the outer edge (A = 0) and on the axis
    (r = 0)."""
    rz = np.asarray(nodes, np.float64)
    rb, zb = params["box"]
    return ((np.abs(rz[:, 0]) <= 1e-12 * rb)
            | (np.abs(rz[:, 0] - rb) <= 1e-12 * rb)
            | (np.abs(np.abs(rz[:, 1]) - zb) <= 1e-12 * zb))


def reference(params: dict, nodes, elements, element_labels):
    """The plain reference's problem on a mesh (node coordinates in cm,
    counter-clockwise elements, each element's index into LABELS), in SI
    units."""
    lbl = np.asarray(element_labels)
    rz = 0.01 * np.asarray(nodes, np.float64)
    J = 1e6 * params["J"] * (lbl == LABELS.index("coil"))
    curve = np.where(lbl == LABELS.index("steel"), 0, -1)
    B, H = zip(*params["steel_bh"])
    return Axisymmetric(rz=rz, tris=np.asarray(elements),
                        mu_r=np.ones(len(lbl)), curve=curve, J=J,
                        fixed=fixed_nodes(params, nodes),
                        curves=[bh.Curve(B, H)])


def answer(solution):
    """The nodal output of the program's solution: the flux 2 pi r A,
    Wb."""
    return np.asarray(solution.A, np.float64)


judge = gap
#: the reference's own solve (the control runs it in float32)
reference_solve = axisymmetric_solve
