"""Geometry editing operations on a Problem (FemmProblem CAD semantics).

The reference's FemmProblem carries the full preprocessor CAD model:
adding a node splits any segment/arc passing through it, adding a
segment/arc splits everything it intersects (cfemm/libfemm/
FemmProblem.h:134-206 addNode/addSegment/addArcSegment), and selected
geometry can be translated/rotated/mirrored/scaled as moves or copies
(FemmProblem.h:400-440). This module provides the same operations as
free functions over the dataclass-based Problem document.

Intersection math follows the reference's GetIntersection /
GetLineArcIntersection / GetArcArcIntersection (FemmProblem.cpp)
computed with complex arithmetic.
"""

from __future__ import annotations

import cmath
import math

from .problem import ArcSegment, BlockLabel, Node, Problem, Segment

DEG = math.pi / 180.0


def _tol(problem: Problem) -> float:
    """Default snap tolerance: 1e-6 of the model extent
    (FemmProblem::addNode uses d based on the bounding box)."""
    if not problem.nodelist:
        return 1e-08
    xs = [n.x for n in problem.nodelist]
    ys = [n.y for n in problem.nodelist]
    ext = max(max(xs) - min(xs), max(ys) - min(ys), 1e-06)
    return ext * 1e-06


def close_to(a: complex, b: complex, d: float) -> bool:
    return abs(a - b) < d


def _seg_param(p0: complex, p1: complex, q: complex) -> float:
    """Projection parameter of q on segment p0-p1 (0..1 inside)."""
    d = p1 - p0
    L2 = (d.real ** 2 + d.imag ** 2)
    if L2 == 0:
        return 0.0
    return ((q - p0).real * d.real + (q - p0).imag * d.imag) / L2


def seg_seg_intersection(p0, p1, q0, q1):
    """Proper interior intersection point of two segments, or None."""
    d1 = p1 - p0
    d2 = q1 - q0
    den = d1.real * d2.imag - d1.imag * d2.real
    if den == 0:
        return None
    t = ((q0 - p0).real * d2.imag - (q0 - p0).imag * d2.real) / den
    u = ((q0 - p0).real * d1.imag - (q0 - p0).imag * d1.real) / den
    eps = 1e-12
    if eps < t < 1 - eps and eps < u < 1 - eps:
        return p0 + t * d1
    return None


def circle_of(problem: Problem, arc: ArcSegment):
    return problem.get_circle(arc)


def _on_arc(problem: Problem, arc: ArcSegment, pt: complex,
            d: float) -> bool:
    c, r = circle_of(problem, arc)
    a0 = problem.nodelist[arc.n0].cc()
    th0 = cmath.phase(a0 - c)
    th = (cmath.phase(pt - c) - th0) % (2 * math.pi)
    return 1e-9 < th < arc.ArcLength * DEG - 1e-9


def seg_arc_intersections(problem: Problem, p0, p1, arc: ArcSegment):
    """Interior intersections of segment p0-p1 with an arc."""
    c, r = circle_of(problem, arc)
    d = p1 - p0
    L = abs(d)
    if L == 0:
        return []
    t = d / L
    # closest approach of the infinite line to c
    s = ((c - p0).real * t.real + (c - p0).imag * t.imag)
    foot = p0 + s * t
    h2 = r * r - abs(foot - c) ** 2
    if h2 <= 0:
        return []
    h = math.sqrt(h2)
    out = []
    for sgn in (-1.0, 1.0):
        q = foot + sgn * h * t
        u = _seg_param(p0, p1, q)
        if 1e-9 < u < 1 - 1e-9 and _on_arc(problem, arc, q, 0.0):
            out.append(q)
    return out


def arc_arc_intersections(problem: Problem, arc1: ArcSegment,
                          arc2: ArcSegment):
    c1, r1 = circle_of(problem, arc1)
    c2, r2 = circle_of(problem, arc2)
    d = abs(c2 - c1)
    if d == 0 or d > r1 + r2 or d < abs(r1 - r2):
        return []
    a = (r1 * r1 - r2 * r2 + d * d) / (2 * d)
    h2 = r1 * r1 - a * a
    if h2 < 0:
        return []
    h = math.sqrt(h2)
    base = c1 + a * (c2 - c1) / d
    perp = 1j * (c2 - c1) / d
    out = []
    for sgn in ((-1.0, 1.0) if h > 1e-14 else (0.0,)):
        q = base + sgn * h * perp
        if _on_arc(problem, arc1, q, 0.0) and _on_arc(problem, arc2, q, 0.0):
            out.append(q)
    return out


# --------------------------------------------------------------------- #
# editing primitives                                                    #
# --------------------------------------------------------------------- #

def add_node(problem: Problem, x: float, y: float,
             d: float | None = None) -> int:
    """Add a node, splitting any segment or arc it lies on
    (FemmProblem::addNode)."""
    if d is None:
        d = _tol(problem)
    pt = complex(x, y)
    for i, n in enumerate(problem.nodelist):
        if close_to(n.cc(), pt, d):
            return i
    problem.nodelist.append(Node(x=x, y=y))
    idx = len(problem.nodelist) - 1

    # split segments passing through the point
    for i in range(len(problem.linelist) - 1, -1, -1):
        seg = problem.linelist[i]
        p0 = problem.nodelist[seg.n0].cc()
        p1 = problem.nodelist[seg.n1].cc()
        u = _seg_param(p0, p1, pt)
        if 1e-9 < u < 1 - 1e-9 and abs(p0 + u * (p1 - p0) - pt) < d:
            _split_segment(problem, i, idx)
    # split arcs passing through the point
    for i in range(len(problem.arclist) - 1, -1, -1):
        arc = problem.arclist[i]
        c, r = circle_of(problem, arc)
        if abs(abs(pt - c) - r) < d and _on_arc(problem, arc, pt, d):
            _split_arc(problem, i, idx)
    return idx


def _split_segment(problem: Problem, si: int, node: int):
    seg = problem.linelist[si]
    s2 = Segment(**{k: getattr(seg, k) for k in
                    ("BoundaryMarker", "InGroup", "InConductor",
                     "MaxSideLength", "Hidden")})
    s2.n0 = node
    s2.n1 = seg.n1
    seg.n1 = node
    problem.linelist.append(s2)


def _split_arc(problem: Problem, ai: int, node: int):
    arc = problem.arclist[ai]
    c, r = circle_of(problem, arc)
    a0 = problem.nodelist[arc.n0].cc()
    pt = problem.nodelist[node].cc()
    th = (cmath.phase(pt - c) - cmath.phase(a0 - c)) % (2 * math.pi) / DEG
    a2 = ArcSegment(n0=node, n1=arc.n1,
                    ArcLength=arc.ArcLength - th,
                    MaxSideLength=arc.MaxSideLength,
                    BoundaryMarker=arc.BoundaryMarker,
                    InGroup=arc.InGroup, InConductor=arc.InConductor,
                    Hidden=arc.Hidden)
    arc.n1 = node
    arc.ArcLength = th
    problem.arclist.append(a2)


def add_segment(problem: Problem, n0: int, n1: int,
                d: float | None = None, **props) -> bool:
    """Add a segment, splitting it (and existing geometry) at every
    crossing (FemmProblem::addSegment)."""
    if n0 == n1:
        return False
    if d is None:
        d = _tol(problem)
    for seg in problem.linelist:
        if (seg.n0, seg.n1) in ((n0, n1), (n1, n0)):
            return False
    p0 = problem.nodelist[n0].cc()
    p1 = problem.nodelist[n1].cc()

    # collect split points: nodes on the new segment, intersections
    pts = []
    for i, nd in enumerate(problem.nodelist):
        if i in (n0, n1):
            continue
        q = nd.cc()
        u = _seg_param(p0, p1, q)
        if 1e-9 < u < 1 - 1e-9 and abs(p0 + u * (p1 - p0) - q) < d:
            pts.append(q)
    for i in range(len(problem.linelist)):
        seg = problem.linelist[i]
        q = seg_seg_intersection(p0, p1,
                                 problem.nodelist[seg.n0].cc(),
                                 problem.nodelist[seg.n1].cc())
        if q is not None:
            pts.append(q)
    for i in range(len(problem.arclist)):
        pts.extend(seg_arc_intersections(problem, p0, p1,
                                         problem.arclist[i]))

    ids = [n0]
    for q in sorted(pts, key=lambda q: _seg_param(p0, p1, q)):
        ids.append(add_node(problem, q.real, q.imag, d))
    ids.append(n1)
    added = False
    for a, b in zip(ids, ids[1:]):
        if a == b:
            continue
        if any((s.n0, s.n1) in ((a, b), (b, a)) for s in problem.linelist):
            continue
        problem.linelist.append(Segment(n0=a, n1=b, **props))
        added = True
    return added


def add_arc_segment(problem: Problem, n0: int, n1: int, arc_length: float,
                    max_seg_deg: float = 10.0, d: float | None = None,
                    **props) -> bool:
    """Add an arc, splitting at intersections with existing geometry
    (FemmProblem::addArcSegment)."""
    if n0 == n1 or arc_length <= 0:
        return False
    if d is None:
        d = _tol(problem)
    arc = ArcSegment(n0=n0, n1=n1, ArcLength=arc_length,
                     MaxSideLength=max_seg_deg, **props)
    # find intersections with existing segments and arcs
    c, r = circle_of(problem, arc)
    pts = []
    for seg in list(problem.linelist):
        pts.extend(seg_arc_intersections(
            problem, problem.nodelist[seg.n0].cc(),
            problem.nodelist[seg.n1].cc(), arc))
    for other in list(problem.arclist):
        pts.extend(arc_arc_intersections(problem, arc, other))

    problem.arclist.append(arc)
    ai = len(problem.arclist) - 1
    a0 = problem.nodelist[n0].cc()
    th0 = cmath.phase(a0 - c)
    # split own arc at each intersection (also splits crossed geometry
    # via add_node)
    for q in sorted(pts, key=lambda q:
                    (cmath.phase(q - c) - th0) % (2 * math.pi)):
        nid = add_node(problem, q.real, q.imag, d)
    return True


# --------------------------------------------------------------------- #
# selection-based transforms (FemmProblem.h:400-440)                    #
# --------------------------------------------------------------------- #

def _map_pt(pt: complex, op: str, arg) -> complex:
    if op == "translate":
        return pt + arg
    if op == "rotate":
        center, deg = arg
        return center + (pt - center) * cmath.exp(1j * deg * DEG)
    center, s = arg               # scale
    return center + (pt - center) * s


def _mirror_pt(pt: complex, p0: complex, p1: complex) -> complex:
    """Reflect pt across the line through p0, p1 (unit direction d:
    v -> d^2 conj(v))."""
    d = (p1 - p0) / abs(p1 - p0)
    return p0 + d * d * (pt - p0).conjugate()


def _transform(pt: complex, op: str, arg) -> complex:
    if op == "mirror":
        return _mirror_pt(pt, *arg)
    return _map_pt(pt, op, arg)


def _gather_selection(problem: Problem, group: int | None,
                      nodes=None, segments=None, arcs=None, labels=None):
    """Indices of selected entities: explicit lists or by group id
    (group=None selects everything)."""
    def sel(lst, given):
        if given is not None:
            return list(given)
        return [i for i, e in enumerate(lst)
                if group is None or e.InGroup == group]
    return (sel(problem.nodelist, nodes), sel(problem.linelist, segments),
            sel(problem.arclist, arcs), sel(problem.labellist, labels))


def transform_selection(problem: Problem, op: str, arg, group=None,
                        copies: int = 0, nodes=None, segments=None,
                        arcs=None, labels=None):
    """Move (copies=0) or copy (copies=N) the selected geometry through
    a transform: 'translate' (arg=dx+i*dy), 'rotate' (arg=(center, deg)),
    'scale' (arg=(center, factor)), 'mirror' (arg=(p0, p1))."""
    ns, ss, As, ls = _gather_selection(problem, group, nodes, segments,
                                       arcs, labels)
    mirror_flip = op == "mirror"
    if copies == 0:
        for i in ns:
            nd = problem.nodelist[i]
            q = _transform(nd.cc(), op, arg)
            nd.x, nd.y = q.real, q.imag
        for i in As:
            if mirror_flip:
                a = problem.arclist[i]
                a.n0, a.n1 = a.n1, a.n0
        for i in ls:
            lab = problem.labellist[i]
            q = _transform(complex(lab.x, lab.y), op, arg)
            lab.x, lab.y = q.real, q.imag
        return

    for rep in range(1, copies + 1):
        if op == "translate":
            arg_k = arg * rep
        elif op == "rotate":
            arg_k = (arg[0], arg[1] * rep)
        elif op == "scale":
            arg_k = (arg[0], arg[1] ** rep)
        else:
            arg_k = arg
            if rep > 1:
                break          # mirroring twice is the identity
        nodemap = {}
        for i in ns:
            q = _transform(problem.nodelist[i].cc(), op, arg_k)
            problem.nodelist.append(Node(x=q.real, y=q.imag,
                                         InGroup=problem.nodelist[i].InGroup))
            nodemap[i] = len(problem.nodelist) - 1
        for i in ss:
            s = problem.linelist[i]
            if s.n0 in nodemap and s.n1 in nodemap:
                s2 = Segment(n0=nodemap[s.n0], n1=nodemap[s.n1],
                             BoundaryMarker=s.BoundaryMarker,
                             InGroup=s.InGroup, InConductor=s.InConductor,
                             MaxSideLength=s.MaxSideLength)
                problem.linelist.append(s2)
        for i in As:
            a = problem.arclist[i]
            if a.n0 in nodemap and a.n1 in nodemap:
                pn0, pn1 = nodemap[a.n0], nodemap[a.n1]
                if mirror_flip:
                    pn0, pn1 = pn1, pn0
                problem.arclist.append(ArcSegment(
                    n0=pn0, n1=pn1, ArcLength=a.ArcLength,
                    MaxSideLength=a.MaxSideLength,
                    BoundaryMarker=a.BoundaryMarker, InGroup=a.InGroup,
                    InConductor=a.InConductor))
        for i in ls:
            lab = problem.labellist[i]
            q = _transform(complex(lab.x, lab.y), op, arg_k)
            import copy as _copy
            l2 = _copy.copy(lab)
            l2.x, l2.y = q.real, q.imag
            problem.labellist.append(l2)


# --------------------------------------------------------------------- #
# corner fillet (FemmProblem::createRadius, FemmProblem.cpp:943)        #
# --------------------------------------------------------------------- #
def _seg_distance(problem: Problem, si: int, pt: complex) -> float:
    seg = problem.linelist[si]
    p0 = problem.nodelist[seg.n0].cc()
    p1 = problem.nodelist[seg.n1].cc()
    u = _seg_param(p0, p1, pt)
    u = max(0.0, min(1.0, u))
    return abs(p0 + u * (p1 - p0) - pt)


def _arc_distance(problem: Problem, ai: int, pt: complex) -> float:
    """Distance from pt to the arc (endpoint distance when the radial
    projection falls outside the span) -- shortestDistanceFromArc."""
    arc = problem.arclist[ai]
    c, r = circle_of(problem, arc)
    a0 = problem.nodelist[arc.n0].cc()
    a1 = problem.nodelist[arc.n1].cc()
    if abs(pt - c) < 1e-30:
        return r
    proj = c + r * (pt - c) / abs(pt - c)
    th = (cmath.phase(proj - c) - cmath.phase(a0 - c)) % (2 * math.pi)
    if th <= arc.ArcLength * DEG + 1e-12:
        return abs(abs(pt - c) - r)
    return min(abs(pt - a0), abs(pt - a1))


def delete_node(problem: Problem, n: int) -> None:
    """Remove node n and every segment/arc attached to it, shifting the
    remaining node indices (deleteSelectedNodes semantics)."""
    problem.linelist[:] = [s for s in problem.linelist
                           if s.n0 != n and s.n1 != n]
    problem.arclist[:] = [a for a in problem.arclist
                          if a.n0 != n and a.n1 != n]
    del problem.nodelist[n]
    for s in problem.linelist:
        if s.n0 > n:
            s.n0 -= 1
        if s.n1 > n:
            s.n1 -= 1
    for a in problem.arclist:
        if a.n0 > n:
            a.n0 -= 1
        if a.n1 > n:
            a.n1 -= 1


def _closest_node(problem: Problem, pt: complex) -> int:
    return min(range(len(problem.nodelist)),
               key=lambda i: abs(problem.nodelist[i].cc() - pt))


def create_radius(problem: Problem, n: int, r: float) -> bool:
    """Replace the corner at node n with a fillet arc of radius r.
    Handles line-line, line-arc, and arc-arc corners exactly like the
    reference (FemmProblem::createRadius): tangency points are found by
    intersecting the r-offset curves, nodes are added there (splitting
    the original entities), the corner node (with its two stubs) is
    deleted, and a new arc spanning the computed angle is added,
    inheriting the boundary/group of one original entity."""
    if r <= 0:
        return False
    segs = [k for k, s in enumerate(problem.linelist)
            if s.n0 == n or s.n1 == n]
    arcs = [k for k, a in enumerate(problem.arclist)
            if a.n0 == n or a.n1 == n]
    if len(segs) + len(arcs) != 2:
        return False
    p0 = problem.nodelist[n].cc()
    props = {}

    if len(segs) == 2:
        s0, s1 = (problem.linelist[k] for k in segs)
        p1 = problem.nodelist[s0.n1 if s0.n0 == n else s0.n0].cc()
        p2 = problem.nodelist[s1.n1 if s1.n0 == n else s1.n0].cc()
        phi = cmath.phase((p2 - p0) / (p1 - p0))
        if abs(phi) > 179.0 * DEG:
            return False
        inherit = segs[0]
        if phi < 0:
            p1, p2 = p2, p1
            inherit = segs[1]
            phi = abs(phi)
        ln = r / math.tan(phi / 2.0)
        if abs(p1 - p0) < ln or abs(p2 - p0) < ln:
            return False
        t1 = ln * (p1 - p0) / abs(p1 - p0) + p0
        t2 = ln * (p2 - p0) / abs(p2 - p0) + p0
        seg = problem.linelist[inherit]
        props = dict(BoundaryMarker=seg.BoundaryMarker,
                     InGroup=seg.InGroup)
        add_node(problem, t1.real, t1.imag, ln / 10000.0)
        add_node(problem, t2.real, t2.imag, ln / 10000.0)
        delete_node(problem, _closest_node(problem, p0))
        # arc runs from the second line's tangent point to the first's
        # (ccw, spanning 180 - phi)
        n0 = _closest_node(problem, t2)
        n1 = _closest_node(problem, t1)
        return add_arc_segment(problem, n0, n1, 180.0 - phi / DEG,
                               max_seg_deg=10.0, **props)

    if len(segs) == 1 and len(arcs) == 1:
        si, ai = segs[0], arcs[0]
        arc = problem.arclist[ai]
        c, rc = circle_of(problem, arc)
        seg = problem.linelist[si]
        pl = problem.nodelist[seg.n1 if seg.n0 == n else seg.n0].cc()
        u = (pl - p0) / abs(pl - p0)
        q = p0 + u * ((c - p0) / u).real       # foot of center on line
        if abs(q - c) < 1e-30:
            return False
        w = (q - c) / abs(q - c)
        cands = []
        for foot, R in ((q + r * w, rc + r), (q - r * w, rc + r),
                        (q + r * w, rc - r), (q - r * w, rc - r)):
            b2 = R * R - abs(foot - c) ** 2
            if b2 < 0:
                continue
            b = math.sqrt(b2)
            for sgn in (1.0, -1.0):
                v = foot + sgn * 1j * b * (foot - c) / abs(foot - c)
                i1 = p0 + u * ((v - p0) / u).real   # tangency on line
                i2 = c + rc * (v - c) / abs(v - c)  # tangency on circle
                if (_arc_distance(problem, ai, i2) < r / 10000.0
                        and _seg_distance(problem, si, i1) < r / 10000.0
                        and abs(i1 - i2) > r / 10000.0):
                    cands.append((abs(v - p0), v, i1, i2))
        if not cands:
            return False
        _, v, i1, i2 = min(cands, key=lambda t: t[0])
        props = dict(BoundaryMarker=arc.BoundaryMarker,
                     InGroup=arc.InGroup)
        add_node(problem, i1.real, i1.imag, r / 10000.0)
        add_node(problem, i2.real, i2.imag, r / 10000.0)
        delete_node(problem, _closest_node(problem, p0))
        phi = cmath.phase((i2 - v) / (i1 - v))
        if phi < 0:
            i1, i2 = i2, i1
            phi = abs(phi)
        n0 = _closest_node(problem, i1)
        n1 = _closest_node(problem, i2)
        return add_arc_segment(problem, n0, n1, phi / DEG,
                               max_seg_deg=10.0, **props)

    # two arcs
    a0i, a1i = arcs
    arc0, arc1 = problem.arclist[a0i], problem.arclist[a1i]
    c1, r1 = circle_of(problem, arc0)
    c2, r2 = circle_of(problem, arc1)
    cc = abs(c2 - c1)
    if cc < 1e-30:
        return False
    e = (c2 - c1) / cc
    cands = []
    for a, b in ((r1 + r, r2 + r), (r1 - r, r2 - r),
                 (r1 - r, r2 + r), (r1 + r, r2 - r)):
        x = (b * b + cc * cc - a * a) / (2.0 * cc * cc)
        d2 = b * b - x * x * cc * cc
        if d2 < 0:
            continue
        d = math.sqrt(d2)
        for sgn in (1.0, -1.0):
            v = ((1 - x) * cc + sgn * 1j * d) * e + c1
            i1 = c1 + r1 * (v - c1) / abs(v - c1)
            i2 = c2 + r2 * (v - c2) / abs(v - c2)
            if (_arc_distance(problem, a0i, i1) < r / 10000.0
                    and _arc_distance(problem, a1i, i2) < r / 10000.0
                    and abs(i1 - i2) > r / 10000.0):
                cands.append((abs(v - p0), v, i1, i2))
    if not cands:
        return False
    _, v, i1, i2 = min(cands, key=lambda t: t[0])
    props = dict(BoundaryMarker=arc0.BoundaryMarker, InGroup=arc0.InGroup)
    add_node(problem, i1.real, i1.imag, cc / 10000.0)
    add_node(problem, i2.real, i2.imag, cc / 10000.0)
    delete_node(problem, _closest_node(problem, p0))
    phi = cmath.phase((i2 - v) / (i1 - v))
    if phi < 0:
        i1, i2 = i2, i1
        phi = abs(phi)
    n0 = _closest_node(problem, i1)
    n1 = _closest_node(problem, i2)
    return add_arc_segment(problem, n0, n1, phi / DEG,
                           max_seg_deg=10.0, **props)
