"""Geometry/mesh exporters (the mfemm visualisation/interop surface).

Covers the reference's MATLAB-layer export utilities with idiomatic
Python equivalents:

- ``to_tikz``: TikZ picture of the problem geometry for LaTeX inclusion
  (mfemm/visualisation/femmproblem2tikzpic.m -- width scaling, optional
  group filter with excluded entities emitted commented-out).
- ``to_freecad``: FreeCAD python-console commands recreating the
  geometry as Draft wires/arcs in mm
  (mfemm/visualisation/problem2freecad_mfemm.m).
- ``to_elmer``: ElmerGrid-format mesh directory (mesh.header /
  mesh.nodes / mesh.elements / mesh.boundary) from a solved or meshed
  problem (mfemm/+mfemm2elmer semantics: triangles as Elmer type 303,
  boundary edges as type 202, bodies = block-label regions, boundaries
  = edge markers).
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..constants import LENGTH_TO_METERS


def _entity_included(ent, groups) -> bool:
    return groups is None or ent.InGroup in groups


def to_tikz(problem, width_mm: float = 150.0, groups=None) -> str:
    """TikZ picture of the input geometry (segments + arcs), scaled so
    the drawing is ``width_mm`` wide. ``groups``: optional iterable of
    group numbers; entities outside it are emitted commented-out."""
    if not problem.nodelist:
        return "\\begin{tikzpicture}\n\\end{tikzpicture}\n"
    lc = LENGTH_TO_METERS[problem.LengthUnits]
    xs = [n.x for n in problem.nodelist]
    ys = [n.y for n in problem.nodelist]
    w = (max(xs) - min(xs)) * lc
    scale = (width_mm / 1000.0) / w if w else 1.0
    groups = set(groups) if groups is not None else None

    def pt(i):
        n = problem.nodelist[i]
        return n.x * lc * scale, n.y * lc * scale

    lines = ["\\begin{tikzpicture}"]
    for seg in problem.linelist:
        x0, y0 = pt(seg.n0)
        x1, y1 = pt(seg.n1)
        s = (f"\\draw ({x0:.6f},{y0:.6f}) -- ({x1:.6f},{y1:.6f});")
        if not _entity_included(seg, groups):
            s = "% " + s
        lines.append(s)
    for arc in problem.arclist:
        c, r = problem.get_circle(arc)
        a0 = problem.nodelist[arc.n0]
        start = math.degrees(math.atan2(a0.y - c.imag, a0.x - c.real))
        x0, y0 = pt(arc.n0)
        s = (f"\\draw ({x0:.6f},{y0:.6f}) arc "
             f"({start:.4f}:{start + arc.ArcLength:.4f}:"
             f"{r * lc * scale:.6f});")
        if not _entity_included(arc, groups):
            s = "% " + s
        lines.append(s)
    lines.append("\\end{tikzpicture}")
    return "\n".join(lines) + "\n"


def to_freecad(problem, groups=None, shape_name: str = "Shape",
               include_header: bool = True) -> str:
    """FreeCAD python commands recreating the geometry in millimetres
    (Draft lines and circular arcs), one Draft object per input entity.
    Paste into the FreeCAD python console or save as a .FCMacro."""
    lc_mm = LENGTH_TO_METERS[problem.LengthUnits] * 1000.0
    groups = set(groups) if groups is not None else None
    out = []
    if include_header:
        out += ["import FreeCAD", "import Draft",
                "doc = FreeCAD.newDocument()"]

    def vec(i):
        n = problem.nodelist[i]
        return (f"FreeCAD.Vector({n.x * lc_mm:.9g}, "
                f"{n.y * lc_mm:.9g}, 0)")

    k = 0
    for seg in problem.linelist:
        if not _entity_included(seg, groups):
            continue
        out.append(f"{shape_name}_{k} = Draft.makeWire("
                   f"[{vec(seg.n0)}, {vec(seg.n1)}])")
        k += 1
    for arc in problem.arclist:
        if not _entity_included(arc, groups):
            continue
        c, r = problem.get_circle(arc)
        a0 = problem.nodelist[arc.n0]
        start = math.degrees(math.atan2(a0.y - c.imag, a0.x - c.real))
        out.append(
            f"{shape_name}_{k} = Draft.makeCircle("
            f"radius={r * lc_mm:.9g}, "
            f"placement=FreeCAD.Placement(FreeCAD.Vector("
            f"{c.real * lc_mm:.9g}, {c.imag * lc_mm:.9g}, 0), "
            f"FreeCAD.Rotation()), face=False, "
            f"startangle={start:.6f}, endangle={start + arc.ArcLength:.6f})")
        k += 1
    if include_header:
        out.append("doc.recompute()")
    return "\n".join(out) + "\n"


def to_elmer(mesh, problem, dirname: str) -> None:
    """Write an Elmer mesh directory (mesh.header, mesh.nodes,
    mesh.elements, mesh.boundary). Bodies are the problem's block-label
    regions (1-based); boundary edges carry their boundary-condition
    index + 1 (edges with no marker are skipped). Coordinates are
    emitted in metres."""
    os.makedirs(dirname, exist_ok=True)
    lc = LENGTH_TO_METERS[problem.LengthUnits]
    nodes = np.asarray(mesh.nodes) * lc
    tris = np.asarray(mesh.elements)
    labels = np.asarray(mesh.element_labels)

    # boundary edges: marker < 0 encodes -(bdry idx + 2)
    em = np.asarray(mesh.edge_markers)
    sel = em < 0
    bedges = np.asarray(mesh.edges)[sel]
    bmark = ((-em[sel]) & 0xFFFF) - 2 + 1        # 1-based Elmer boundary id

    with open(os.path.join(dirname, "mesh.header"), "w") as f:
        f.write(f"{len(nodes)} {len(tris)} {len(bedges)}\n")
        f.write("2\n")
        f.write(f"303 {len(tris)}\n")
        f.write(f"202 {len(bedges)}\n")
    with open(os.path.join(dirname, "mesh.nodes"), "w") as f:
        for i, (x, y) in enumerate(nodes, start=1):
            f.write(f"{i} -1 {x:.17g} {y:.17g} 0\n")
    with open(os.path.join(dirname, "mesh.elements"), "w") as f:
        for i, (tri, lbl) in enumerate(zip(tris, labels), start=1):
            f.write(f"{i} {int(lbl) + 1} 303 "
                    f"{tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")
    with open(os.path.join(dirname, "mesh.boundary"), "w") as f:
        for i, ((a, b), m) in enumerate(zip(bedges, bmark), start=1):
            f.write(f"{i} {int(m)} 0 0 202 {a + 1} {b + 1}\n")
