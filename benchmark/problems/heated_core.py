"""Planar nonlinear heat flow: a heated cylindrical core with a K(T)
table inside a conducting square box held at a fixed temperature.

A frozen copy of the program's synthetic heat benchmark
(``models/benchprob.build_heat``) with its dimensions as parameters:
``box`` (half width, m), ``r`` (core radius), ``qv`` (core volume source,
W/m^3), ``k_medium`` (W/(m K)), ``k_table`` ((T, k) points of the core),
``t_boundary``, ``max_area`` from ``target_nodes``, ``precision``,
``min_angle``, ``arc_deg`` and ``medium_label``.
"""

from __future__ import annotations

import math

import numpy as np

from ..reference.heatflow import HeatFlow, gap
from ..reference.heatflow import solve as heatflow_solve
from .coil_cylinder import max_area  # noqa: F401 (the harness reads it)

#: block labels in the order of the problem's label list
LABELS = ("medium", "core")


def label_points(params: dict):
    """(x, y) of each block label, in LABELS order."""
    return [tuple(params["medium_label"]), (0.0, 0.0)]


def build(params: dict):
    """The problem document, through the program's geometry classes."""
    from xfemm_tpu_torch.constants import FileType, LengthUnit, ProblemType
    from xfemm_tpu_torch.geometry.problem import (ArcSegment, BlockLabel,
                                                  BoundaryProp, HeatMaterial,
                                                  PointProp, Problem, Segment)

    p = Problem(filetype=FileType.HEATFLOW)
    p.Precision = params["precision"]
    p.MinAngle = params["min_angle"]
    p.Depth = 1.0
    p.LengthUnits = LengthUnit.METERS
    p.ProblemType = ProblemType.PLANAR
    p.DoSmartMesh = False

    k = params["k_medium"]
    medium = HeatMaterial(name="Medium", Kx=k, Ky=k)
    core = HeatMaterial(name="Core", qv=params["qv"])
    core.Tdata = [t for t, _k in params["k_table"]]
    core.Kdata = [kk for _t, kk in params["k_table"]]
    p.blockproplist = [medium, core]
    p.lineproplist = [BoundaryProp(name="T0", BdryFormat=0,
                                   Tset=params["t_boundary"])]
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
    ma = max_area(params)
    p.labellist = [BlockLabel(x=x, y=y, BlockType=i, MaxArea=ma)
                   for i, (x, y) in enumerate(label_points(params))]
    return p


def region_areas(params: dict):
    """The area of each labelled region, in LABELS order (the core is the
    polygon of the arcs' chords)."""
    n = 2 * math.ceil(180.0 / params["arc_deg"])
    r = params["r"]
    core = 0.5 * n * r * r * math.sin(2.0 * math.pi / n)
    return [(2.0 * params["box"]) ** 2 - core, core]


def fixed_nodes(params: dict, nodes) -> np.ndarray:
    """The Dirichlet nodes: those on the box's outer edge."""
    xy = np.asarray(nodes, np.float64)
    s = params["box"]
    return ((np.abs(np.abs(xy[:, 0]) - s) <= 1e-12 * s)
            | (np.abs(np.abs(xy[:, 1]) - s) <= 1e-12 * s))


def reference(params: dict, nodes, elements, element_labels):
    """The plain reference's problem on a mesh."""
    lbl = np.asarray(element_labels)
    xy = np.asarray(nodes, np.float64)
    fixed = fixed_nodes(params, xy)
    k = np.full(len(lbl), float(params["k_medium"]))
    tp, kp = zip(*params["k_table"])
    return HeatFlow(
        xy=xy, tris=np.asarray(elements), kx=k, ky=k.copy(),
        table=np.where(lbl == 1, 0, -1),
        qv=np.where(lbl == 1, float(params["qv"]), 0.0), fixed=fixed,
        fixed_vals=np.full(len(xy), float(params["t_boundary"])),
        tables=[(tp, kp)])


def answer(solution):
    """The nodal unknown of the program's solution: T."""
    return np.asarray(solution.T, np.float64)


judge = gap
#: the reference's own solve (the control runs it in float32)
reference_solve = heatflow_solve
