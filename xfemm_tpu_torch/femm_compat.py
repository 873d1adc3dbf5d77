"""pyFEMM / femmcli-compatible command layer.

The reference exposes its automation as flat mi_*/mo_*, hi_*/ho_*,
ei_*/eo_* commands over an implicit current document (cfemm/femmcli/
LuaMagneticsCommands.cpp, LuaHeatflowCommands.cpp,
LuaElectrostaticsCommands.cpp; same surface as the pyFEMM package).
This module provides those verbs 1:1 over the session API so existing
FEMM automation scripts port with minimal changes::

    import xfemm_tpu_torch.femm_compat as femm
    femm.newdocument(0)                  # 0 = magnetics
    femm.mi_probdef(0, "centimeters", "planar", 1e-8, 1, 30)
    femm.mi_addnode(0, 0); ...
    femm.mi_analyze()
    femm.mi_loadsolution()
    print(femm.mo_getpointvalues(0.1, 0.2))

Only the functional (non-GUI) surface is provided; window/zoom/plot
commands are accepted as no-ops like femmcli's own stubs
(cfemm/femmcli/LuaBaseCommands.cpp makeplot/zoom stubs).
"""

from __future__ import annotations

import cmath
import math

import numpy as np

from . import api
from .constants import FileType, LengthUnit, MU0, PI, ProblemType
from .materials.magnetic import MagneticMaterial
from .geometry.problem import BoundaryProp, Circuit, Conductor

_UNITS = {"inches": LengthUnit.INCHES, "millimeters": LengthUnit.MILLIMETERS,
          "centimeters": LengthUnit.CENTIMETERS, "meters": LengthUnit.METERS,
          "mils": LengthUnit.MILS, "micrometers": LengthUnit.MICROMETERS}

_doc: api.Document | None = None
_sol: api.Solution | None = None
_selected_nodes: list[int] = []
_selected_labels: list[int] = []
_selected_groups: list[int] = []
_selected_segments: list[int] = []
_selected_arcs: list[int] = []


def _d() -> api.Document:
    if _doc is None:
        raise RuntimeError("no document open; call newdocument() first")
    return _doc


def _s() -> api.Solution:
    if _sol is None:
        raise RuntimeError("no solution; call mi_analyze/mi_loadsolution")
    return _sol


def newdocument(doctype: int = 0, device=None,
                hbm_bytes: float | None = None):
    """0 magnetics, 2 heat flow, 1 electrostatics (femm doc types).
    ``device`` / ``hbm_bytes``: where the document's solves run (CUDA
    by default; see ``api.Document``)."""
    global _doc, _sol
    kind = {0: "magnetics", 1: "electrostatics", 2: "heatflow"}[int(doctype)]
    _doc = api.new_document(kind, device=device, hbm_bytes=hbm_bytes)
    _sol = None
    mi_clearselected()
    _contour.clear()
    return _doc


def opendocument(path: str, device=None, hbm_bytes: float | None = None):
    global _doc, _sol
    _doc = api.open_document(path, device=device, hbm_bytes=hbm_bytes)
    _sol = None
    mi_clearselected()
    _contour.clear()
    return _doc


# ---------------------- problem definition --------------------------- #
def mi_probdef(freq=0.0, units="centimeters", probtype="planar",
               precision=1e-8, depth=1.0, minangle=30.0, acsolver=0):
    p = _d().problem
    p.Frequency = freq
    p.LengthUnits = _UNITS[units]
    p.ProblemType = (ProblemType.AXISYMMETRIC if probtype.startswith("axi")
                     else ProblemType.PLANAR)
    p.Precision = precision
    p.Depth = depth
    p.MinAngle = minangle


# ------------------------- geometry ---------------------------------- #
def mi_addnode(x, y):
    return _d().add_node(x, y)


def mi_addsegment(x1, y1, x2, y2):
    d = _d()
    d.add_segment(d.add_node(x1, y1), d.add_node(x2, y2))


def mi_addarc(x1, y1, x2, y2, angle, maxseg):
    d = _d()
    d.add_arc(d.add_node(x1, y1), d.add_node(x2, y2), angle, maxseg)


def mi_addblocklabel(x, y):
    d = _d()
    lab = d.add_block_label(x, y)
    return lab


def mi_drawrectangle(x1, y1, x2, y2):
    mi_addsegment(x1, y1, x2, y1)
    mi_addsegment(x2, y1, x2, y2)
    mi_addsegment(x2, y2, x1, y2)
    mi_addsegment(x1, y2, x1, y1)


def mi_selectnode(x, y):
    i = _d()._nearest_node(x, y)
    _selected_nodes.append(i)
    return i


def mi_selectlabel(x, y):
    p = _d().problem
    best, bd = -1, 1e300
    for i, lab in enumerate(p.labellist):
        dd = (lab.x - x) ** 2 + (lab.y - y) ** 2
        if dd < bd:
            best, bd = i, dd
    _selected_labels.append(best)
    return best


def mi_selectgroup(g):
    _selected_groups.append(int(g))


def mi_clearselected():
    _selected_nodes.clear()
    _selected_labels.clear()
    _selected_groups.clear()
    _selected_segments.clear()
    _selected_arcs.clear()


def mi_setnodeprop(propname="", groupno=0, inconductor=""):
    d = _d()
    for i in _selected_nodes:
        nd = d.problem.nodelist[i]
        nd.InGroup = groupno
        if propname:
            nd.BoundaryMarker = d.problem.point_prop_index(propname)


def mi_setblockprop(blockname="", automesh=1, meshsize=0, incircuit="",
                    magdir=0, group=0, turns=1):
    d = _d()
    for i in _selected_labels:
        lab = d.problem.labellist[i]
        if blockname:
            lab.BlockType = d.problem.material_index(blockname)
        lab.InCircuit = (d.problem.circuit_index(incircuit)
                         if incircuit else -1)
        if isinstance(magdir, str):
            lab.MagDirFctn = magdir
        else:
            lab.MagDir = float(magdir)
        lab.InGroup = group
        lab.Turns = turns
        lab.MaxArea = (0.0 if automesh else
                       math.pi * meshsize * meshsize / 4.0)


def mi_setsegmentprop(propname="", elementsize=0, automesh=1, hide=0,
                      group=0, inconductor=""):
    d = _d()
    # applies to every segment whose BOTH endpoints are selected
    selset = set(_selected_nodes)
    for seg in d.problem.linelist:
        if seg.n0 in selset and seg.n1 in selset:
            if propname:
                seg.BoundaryMarker = d.problem.boundary_index(propname)
            seg.InGroup = group
            seg.MaxSideLength = -1 if automesh else elementsize


def mi_setarcsegmentprop(maxsegdeg=1.0, propname="", hide=0, group=0,
                         inconductor=""):
    d = _d()
    selset = set(_selected_nodes)
    for arc in d.problem.arclist:
        if arc.n0 in selset and arc.n1 in selset:
            if propname:
                arc.BoundaryMarker = d.problem.boundary_index(propname)
            arc.InGroup = group
            arc.MaxSideLength = maxsegdeg


def mi_moverotate(bx, by, shiftangle):
    _d().move_rotate(bx, by, shiftangle,
                     group=_selected_groups[-1] if _selected_groups
                     else None)


def mi_movetranslate(dx, dy):
    _d().move_translate(dx, dy,
                        group=_selected_groups[-1] if _selected_groups
                        else None)


def mi_copyrotate(bx, by, angle, copies):
    _d().copy_rotate(bx, by, angle, copies=copies,
                     group=_selected_groups[-1] if _selected_groups
                     else None)


def mi_mirror(x1, y1, x2, y2):
    _d().mirror(x1, y1, x2, y2,
                group=_selected_groups[-1] if _selected_groups else None)


# ------------------------- properties -------------------------------- #
def mi_addmaterial(name, mux=1, muy=1, Hc=0, J=0, Cduct=0, Lam_d=0,
                   Phi_hmax=0, lam_fill=1, LamType=0, Phi_hx=0, Phi_hy=0,
                   NStrands=0, WireD=0):
    m = MagneticMaterial(name=name, mu_x=mux, mu_y=muy, H_c=Hc,
                         J=complex(J), Cduct=Cduct, Lam_d=Lam_d,
                         Theta_hn=Phi_hmax, LamFill=lam_fill,
                         LamType=LamType, Theta_hx=Phi_hx, Theta_hy=Phi_hy,
                         NStrands=NStrands, WireD=WireD)
    _d().problem.blockproplist.append(m)


# A few standard materials built in (physical constants, the same
# values FEMM's library documents publicly): enough for scripts that
# The full standard FEMM material libraries ship with the package
# (xfemm_tpu_torch/data/{matlib,heatlib,statlib}.json — the same data the
# reference installs as cfemm/femmcli/release/*.dat next to femmcli),
# so *_getmaterial works out of the box. An explicit libpath= or the
# XFEMM_TPU_{MATLIB,HEATLIB,STATLIB} environment variable overrides.


def _getmaterial(name, libpath, envvar, filetype):
    import os
    from .materials import library as _lib
    if libpath is None:
        libpath = os.environ.get(envvar)
    if libpath is not None:
        return _d().add_material_from_library(libpath, name)
    m = _lib.get_builtin(name, filetype)
    if m is None:
        raise ValueError(
            f"material {name!r} is not in the shipped library; pass "
            f"libpath= or set {envvar} to a FEMM-format library file")
    _d().problem.blockproplist.append(m)
    return m


def mi_getmaterial(name, libpath=None):
    """Pull a material from the shipped standard library
    (mi_getmaterial; reference: cfemm/femmcli/release/matlib.dat +
    LuaMagneticsCommands.cpp luaGetMaterialFromLib), an explicit
    library file, or $XFEMM_TPU_MATLIB."""
    from .constants import FileType
    _getmaterial(name, libpath, "XFEMM_TPU_MATLIB", FileType.MAGNETICS)


def mi_addboundprop(name, A0=0, A1=0, A2=0, phi=0, Mu=0, Sig=0, c0=0,
                    c1=0, BdryFormat=0, ia=0, oa=0):
    _d().problem.lineproplist.append(BoundaryProp(
        name=name, A0=A0, A1=A1, A2=A2, phi=phi, Mu=Mu, Sig=Sig,
        c0=complex(c0), c1=complex(c1), BdryFormat=BdryFormat,
        InnerAngle=ia, OuterAngle=oa))


def mi_addcircprop(name, current=0, circuittype=1):
    _d().problem.circproplist.append(Circuit(
        name=name, Amps=complex(current), CircType=circuittype))


def mi_addpointprop(name, a=0, j=0):
    _d().add_point_prop(name, A=complex(a), J=complex(j))


def mi_modifyboundprop(name, propnum, value):
    bp = _d().problem.lineproplist[_d().problem.boundary_index(name)]
    fields = ["name", "A0", "A1", "A2", "phi", "Mu", "Sig", "c0", "c1",
              "BdryFormat", "InnerAngle", "OuterAngle"]
    if fields[int(propnum)] == "BdryFormat":
        value = int(value)
    setattr(bp, fields[int(propnum)], value)


# --------------------------- pipeline --------------------------------- #
def mi_saveas(path):
    _d().save(path)


def mi_createmesh():
    return _d().create_mesh().num_nodes


def mi_analyze(flag=0):
    # the reference's analyze always re-meshes the current geometry
    # (femmcli runs fmesher then fsolver); keep that contract so
    # property edits between analyses take effect
    global _sol
    _d()._mesh = None
    _sol = _d().analyze()


def mi_loadsolution():
    global _sol
    if _sol is None:
        mi_analyze()
    return _sol


# --------------------------- post ------------------------------------ #
def mo_getpointvalues(x, y):
    """A,B1,B2,Sig,E,H1,H2,Je,Js,Mu1,Mu2,Pe,Ph (femmcli order)."""
    v = _s().point_values(x, y)
    if not v:
        return None
    # energy density E = B.H/2
    E = ((v["B1"] * np.conj(v["H1"])).real
         + (v["B2"] * np.conj(v["H2"])).real) / 2.0
    out = (v["A"], v["B1"], v["B2"], v.get("Sig", 0.0), E,
           v["H1"], v["H2"], v.get("Je", 0.0), v.get("Js", 0.0),
           v["mu1"], v["mu2"], v.get("Pe", 0.0), v.get("Ph", 0.0))
    if _d().problem.Frequency == 0:
        # the scripting layer exposes real numbers for DC solutions
        out = tuple(x.real if isinstance(x, complex) else x for x in out)
    return out


def mo_selectblock(x, y):
    _selected_labels.extend(_s().select_blocks_at((x, y)))


def mo_clearblock():
    _selected_labels.clear()


def mo_blockintegral(inttype):
    sel = set(_selected_labels) or None
    return _s().block_integral(inttype, sel)


def mo_lineintegral(inttype, contour=None):
    """Integrate along ``contour`` if given, else along the contour
    built with mo_addcontour/mo_selectpoint/mo_bendcontour."""
    if contour is None:
        if len(_contour) < 2:
            raise ValueError("no contour defined; call mo_addcontour "
                             "or pass the contour points explicitly")
        contour = [(z.real, z.imag) for z in _contour]
    return _s().line_integral(inttype, contour)


def mo_gapintegral(bdryname, inttype):
    return _s().gap_integral(bdryname, inttype)


def mo_getcircuitproperties(name):
    return _s().circuit_properties(name)


def mo_getgapb(bdryname, angle_deg):
    """(Br, Bt) reconstructed from the air-gap harmonics at an angle."""
    post = _s().post
    i = post._age_index(bdryname)
    h = post.age[i]
    th = math.radians(angle_deg)
    br = float(np.sum(h.brc * np.cos(h.nh * th) + h.brs * np.sin(h.nh * th)))
    bt = float(np.sum(h.btc * np.cos(h.nh * th) + h.bts * np.sin(h.nh * th)))
    return br, bt


def mo_getgapharmonics(bdryname, k):
    post = _s().post
    h = post.age[post._age_index(bdryname)]
    return (h.nh[k], complex(h.brc[k]), complex(h.brs[k]),
            complex(h.btc[k]), complex(h.bts[k]))


def mo_getgapa(bdryname, angle_deg):
    """Vector potential in the air gap at an angle, reconstructed from
    the gap harmonics (luaGetGapA -> FPProc::getGapA, fpproc.cpp:5968):
    A(theta) = aco + sum_k (R/n_k)(-brs_k cos(n_k theta)
    + brc_k sin(n_k theta))."""
    post = _s().post
    i = post._age_index(bdryname)
    h = post.age[i]
    g = post.mesh.airgaps[i]
    R = (g.ri + g.ro) / 2.0
    th = math.radians(angle_deg)
    ac = complex(h.aco)
    nz = h.nh != 0
    n = h.nh[nz].astype(float)
    ac += complex(np.sum((R / n) * (-h.brs[nz] * np.cos(n * th)
                                    + h.brc[nz] * np.sin(n * th))))
    return ac.real if _d().problem.Frequency == 0 else ac


# ------------------------- contours ----------------------------------- #
_contour: list[complex] = []


def mo_addcontour(x, y):
    """Append a point to the postprocessor contour (luaAddContourPoint,
    fpproc's `contour` list); mo_lineintegral integrates along it."""
    z = complex(x, y)
    if not _contour or _contour[-1] != z:
        _contour.append(z)


def mo_clearcontour():
    _contour.clear()


def mo_bendcontour(angle, anglestep):
    """Replace the contour's last straight segment with an arc spanning
    ``angle`` degrees, discretized at <= ``anglestep`` degrees per piece
    (FPProc::BendContour semantics)."""
    if angle == 0 or len(_contour) < 2:
        return
    if anglestep == 0:
        anglestep = 1.0
    if angle < -180.0 or angle > 180.0:
        return
    n = int(math.ceil(abs(angle / anglestep)))
    tta = math.radians(angle)
    dtta = tta / n
    a1 = _contour.pop()
    a0 = _contour[-1]
    d = abs(a1 - a0)
    R = d / (2.0 * math.sin(abs(tta / 2.0)))
    if tta > 0:
        c = a0 + (R / d) * (a1 - a0) * cmath.exp(1j * (math.pi - tta) / 2.0)
    else:
        c = a0 + (R / d) * (a1 - a0) * cmath.exp(-1j * (math.pi + tta) / 2.0)
    for k in range(1, n + 1):
        _contour.append(c + (a0 - c) * cmath.exp(1j * k * dtta))


def mo_selectpoint(x, y):
    """Add the nearest input-geometry node to the contour; when the
    previous contour point and the new one are the endpoints of an input
    arc, the contour follows the arc (luaAddContourPointFromNode)."""
    p = _d().problem
    if not p.nodelist:
        return
    best, bd = -1, 1e300
    for i, nd in enumerate(p.nodelist):
        dd = (nd.x - x) ** 2 + (nd.y - y) ** 2
        if dd < bd:
            best, bd = i, dd
    nd = p.nodelist[best]
    z = complex(nd.x, nd.y)
    if _contour and _contour[-1] == z:
        return
    if _contour:
        prev = _contour[-1]
        # endpoints of an input arc? follow the arc like the reference
        for arc in p.arclist:
            za = complex(p.nodelist[arc.n0].x, p.nodelist[arc.n0].y)
            zb = complex(p.nodelist[arc.n1].x, p.nodelist[arc.n1].y)
            if abs(prev - za) < 1e-12 and abs(zb - z) < 1e-12:
                _contour.append(z)
                mo_bendcontour(arc.ArcLength, arc.MaxSideLength)
                return
            if abs(prev - zb) < 1e-12 and abs(za - z) < 1e-12:
                _contour.append(z)
                mo_bendcontour(-arc.ArcLength, arc.MaxSideLength)
                return
    _contour.append(z)


def mo_groupselectblock(group=None):
    """Select every block label in group ``group`` (all blocks when the
    argument is omitted) -- luaGroupSelectBlock."""
    labels = _s().post.labels
    for i, lab in enumerate(labels):
        if group is None or lab.InGroup == int(group):
            if i not in _selected_labels:
                _selected_labels.append(i)


def mo_numnodes():
    return _s().mesh.num_nodes


def mo_numelements():
    return _s().mesh.num_elements


def mo_getnode(n):
    """(x, y) of mesh node n (1-based, luaGetMeshNode)."""
    i = int(n) - 1
    mesh = _s().mesh
    if i < 0 or i >= mesh.num_nodes:
        return None
    return (float(mesh.nodes[i, 0]), float(mesh.nodes[i, 1]))


def mo_getelement(n):
    """(p1, p2, p3, x, y, area, group) of mesh element n (1-based,
    luaGetElement; indices are 1-based, area in length-units^2)."""
    i = int(n) - 1
    post = _s().post
    mesh = _s().mesh
    if i < 0 or i >= mesh.num_elements:
        return None
    tri = mesh.elements[i]
    ctr = mesh.nodes[tri].mean(axis=0)
    area = post.da[i] / 2.0
    grp = post.labels[mesh.element_labels[i]].InGroup
    return (int(tri[0]) + 1, int(tri[1]) + 1, int(tri[2]) + 1,
            float(ctr[0]), float(ctr[1]), float(area), int(grp))


def mo_getprobleminfo():
    return mi_getprobleminfo()


def mo_gettitle():
    return mi_gettitle()


def mo_reload():
    """Reload the solution for the current document (luaLoadSolution)."""
    return mi_loadsolution()


def mo_smooth(flag="on"):
    """Toggle patch-smoothing of B for point values (luaSetSmoothing)."""
    post = _s().post
    post.smoothing = str(flag).lower() != "off"


def mo_gradient(xo, yo):
    """Field-gradient tensor at (xo, yo) by integrating each element's
    magnetization contribution (luaBGradient; undocumented in the FEMM
    manual). Returns (dbxdx, dbxdy, dbydx, dbydy) re/im interleaved like
    the Lua binding."""
    post = _s().post
    mesh = _s().mesh
    lc = post.lc
    T = mesh.num_elements
    dbxdx = dbxdy = dbydx = 0.0 + 0j
    for i in range(T):
        M1, M2 = post.get_magnetization(i)
        da = MU0 * (post.da[i] / 2.0) / lc
        ctr = mesh.nodes[mesh.elements[i]].mean(axis=0)
        x, y = float(ctr[0]), float(ctr[1])
        p0 = PI * ((x - xo) ** 2 + (y - yo) ** 2) ** 3
        p1 = (-3.0 * (x - xo) ** 2 + (y - yo) ** 2) * (y - yo)
        p2 = (x - xo) * ((x - xo) ** 2 - 3.0 * (y - yo) ** 2)
        dbxdx += da * (-(M2 * p1) + M1 * p2) / p0
        dbxdy += da * (-(M1 * p1) - M2 * p2) / p0
        dbydx += da * (-(M1 * p1) - M2 * p2) / p0
    dbydy = -dbxdx
    return (dbxdx.real, dbxdx.imag, dbxdy.real, dbxdy.imag,
            dbydx.real, dbydx.imag, dbydy.real, dbydy.imag)


# ---------------- property deletion / modification -------------------- #
def mi_deletematerial(name):
    p = _d().problem
    i = p.material_index(name)
    del p.blockproplist[i]
    for lab in p.labellist:
        if lab.BlockType == i:
            lab.BlockType = -1
        elif lab.BlockType > i:
            lab.BlockType -= 1


def mi_deleteboundprop(name):
    p = _d().problem
    i = p.boundary_index(name)
    del p.lineproplist[i]
    for lst, attr in ((p.linelist, "BoundaryMarker"),
                      (p.arclist, "BoundaryMarker")):
        for s in lst:
            v = getattr(s, attr)
            if v == i:
                setattr(s, attr, -1)
            elif v > i:
                setattr(s, attr, v - 1)


def mi_deletecircuit(name):
    p = _d().problem
    i = p.circuit_index(name)
    del p.circproplist[i]
    for lab in p.labellist:
        if lab.InCircuit == i:
            lab.InCircuit = -1
        elif lab.InCircuit > i:
            lab.InCircuit -= 1


def mi_deletepointprop(name):
    p = _d().problem
    i = p.point_prop_index(name)
    del p.nodeproplist[i]
    for nd in p.nodelist:
        if nd.BoundaryMarker == i:
            nd.BoundaryMarker = -1
        elif nd.BoundaryMarker > i:
            nd.BoundaryMarker -= 1


def mi_modifypointprop(name, propnum, value):
    """Field order name, A_re, A_im (or V), J_re, J_im
    (luaModifyPointProperty)."""
    p = _d().problem
    pp = p.nodeproplist[p.point_prop_index(name)]
    n = int(propnum)
    if n == 0:
        pp.name = value
    elif n == 1:
        pp.A = complex(value, complex(pp.A).imag)
    elif n == 2:
        pp.A = complex(complex(pp.A).real, value)
    elif n == 3:
        pp.J = complex(value, complex(pp.J).imag)
    elif n == 4:
        pp.J = complex(complex(pp.J).real, value)


# ----------------- external region / default label --------------------- #
def mi_defineouterspace(Zo, Ro, Ri):
    """Kelvin-transform external region parameters
    (luaDefineOuterSpace; feasolver extZo/extRo/extRi)."""
    p = _d().problem
    p.extZo = float(Zo)
    p.extRo = float(Ro)
    p.extRi = float(Ri)


def mi_attachouterspace():
    p = _d().problem
    for i in set(_selected_labels):
        p.labellist[i].IsExternal = True


def mi_detachouterspace():
    p = _d().problem
    for i in set(_selected_labels):
        p.labellist[i].IsExternal = False


def mi_attachdefault():
    """Mark the selected block label as the default label: its
    properties apply to any otherwise-unlabeled region
    (luaAttachDefault)."""
    p = _d().problem
    for i in set(_selected_labels):
        p.labellist[i].IsDefault = True


def mi_detachdefault():
    p = _d().problem
    for i in set(_selected_labels):
        p.labellist[i].IsDefault = False


# --------------------- geometry: copy / fillet ------------------------- #
def mi_copytranslate(dx, dy, copies=1, editaction=None):
    _d().copy_translate(dx, dy, copies=int(copies),
                        group=_selected_groups[-1] if _selected_groups
                        else None)


def mi_createradius(x, y, r):
    """Fillet the corner nearest (x, y) with an arc of radius r
    (luaCreateRadius -> FemmProblem::createRadius)."""
    from .geometry import editor
    d = _d()
    i = d._nearest_node(x, y)
    ok = editor.create_radius(d.problem, i, float(r))
    if ok:
        d._mesh = None
    return ok


def mi_setprevious(filename, prevtype=1):
    """Use a previous solution as the operating point for incremental
    (prevtype 1) / frozen (prevtype 2) permeability AC analysis
    (luaSetPrevious; fsolver [prevsoln]/[prevtype])."""
    p = _d().problem
    p.PrevSoln = filename
    p.PrevType = int(prevtype)


def mi_analyse(flag=0):
    mi_analyze(flag)


def mi_newdocument(device=None, hbm_bytes: float | None = None):
    return newdocument(0, device, hbm_bytes)


# ------------------------ no-op GUI stubs ----------------------------- #
def _noop(*args, **kw):
    return None


for _name in ("mi_zoomnatural", "mi_zoom", "mi_showgrid", "mi_hidegrid",
              "mo_zoom", "mo_zoomnatural", "mo_showdensityplot",
              "mo_hidedensityplot", "mi_refreshview", "mo_refreshview",
              "main_maximize", "main_minimize", "showconsole",
              "hideconsole", "messagebox", "makeplot", "mi_close",
              "mo_close",
              # the reference registers these as luaNOP too
              # (LuaMagneticsCommands.cpp: GUI window/plot commands)
              "mi_gridsnap", "mo_gridsnap", "mo_hidecontourplot",
              "mo_hidemesh", "mo_hidepoints", "mo_makeplot",
              "mi_maximize", "mo_maximize", "mi_minimize", "mo_minimize",
              "mi_readdxf", "mi_resize", "mo_resize", "mi_restore",
              "mo_restore", "mi_savebitmap", "mo_savebitmap",
              "mi_savedxf", "mi_savemetafile", "mo_savemetafile",
              "mi_setgrid", "mo_setgrid", "mo_showcontourplot",
              "mi_showmesh", "mo_showmesh", "mi_shownames",
              "mo_shownames", "mo_showpoints", "mo_showvectorplot",
              "mi_zoomin", "mo_zoomin", "mi_zoomout", "mo_zoomout",
              "mi_setfocus", "mo_setfocus", "mo_showgrid",
              "mo_hidegrid"):
    globals()[_name] = _noop


# ----------------- heat-flow verbs (hi_*/ho_*) ------------------------- #
# (LuaHeatflowCommands.cpp registrations; the in-memory session flow is
# identical to magnetics: analyze solves by filetype, the postprocessor
# handle exposes point values/integrals)
def hi_analyze(flag=0):
    mi_analyze(flag)


def hi_loadsolution():
    return mi_loadsolution()


def hi_saveas(path):
    mi_saveas(path)


def ho_getpointvalues(x, y):
    """T, Fx, Fy, Gx, Gy, kx, ky (LuaHeatflowCommands luaGetpointvals)."""
    v = _s().point_values(x, y)
    if not v:
        return None
    return (v["T"], v["Fx"], v["Fy"], v["Gx"], v["Gy"], v["Kx"], v["Ky"])


def ho_blockintegral(inttype):
    return mo_blockintegral(inttype)


def ho_lineintegral(inttype, contour=None):
    return mo_lineintegral(inttype, contour)


def ho_getconductorproperties(name):
    sol = _sol.raw
    p = _d().problem
    for i, c in enumerate(p.circproplist):
        if c.name == name:
            return (sol.conductor_V[i], sol.conductor_q[i])
    raise KeyError(name)


# -------------- electrostatics verbs (ei_*/eo_*) ----------------------- #
def ei_analyze(flag=0):
    mi_analyze(flag)


def ei_loadsolution():
    return mi_loadsolution()


def ei_saveas(path):
    mi_saveas(path)


def eo_getpointvalues(x, y):
    """V, Dx, Dy, Ex, Ey, ex, ey, nrg (LuaElectrostaticsCommands)."""
    v = _s().point_values(x, y)
    if not v:
        return None
    from .post.scalarproc import EPS0
    nrg = (v["Dx"] * v["Ex"] + v["Dy"] * v["Ey"]) / 2.0
    # the scripting layer reports RELATIVE permittivity (femm42 ex/ey)
    return (v["V"], v["Dx"], v["Dy"], v["Ex"], v["Ey"],
            v["Kx"] / EPS0, v["Ky"] / EPS0, nrg)


def eo_blockintegral(inttype):
    return mo_blockintegral(inttype)


def eo_lineintegral(inttype, contour=None):
    return mo_lineintegral(inttype, contour)


def eo_getconductorproperties(name):
    return ho_getconductorproperties(name)


# ------------------ selection & editing (additional verbs) ------------- #
def mi_selectsegment(x, y):
    """Select the segment nearest (x, y) (LuaCommonCommands
    luaSelectSegment); its endpoints are also marked so the
    set*segmentprop verbs see it."""
    p = _d().problem
    best, bd = -1, 1e300
    for i, seg in enumerate(p.linelist):
        a = p.nodelist[seg.n0]
        bnd = p.nodelist[seg.n1]
        ax, ay, bx, by = a.x, a.y, bnd.x, bnd.y
        dx, dy = bx - ax, by - ay
        L2 = dx * dx + dy * dy
        t = 0.0 if L2 == 0 else max(0.0, min(1.0, ((x - ax) * dx
                                                   + (y - ay) * dy) / L2))
        d2 = (ax + t * dx - x) ** 2 + (ay + t * dy - y) ** 2
        if d2 < bd:
            best, bd = i, d2
    if best >= 0:
        _selected_segments.append(best)
        seg = p.linelist[best]
        _selected_nodes.extend([seg.n0, seg.n1])
    return best


def mi_selectarcsegment(x, y):
    p = _d().problem
    best, bd = -1, 1e300
    for i, arc in enumerate(p.arclist):
        a = p.nodelist[arc.n0]
        b = p.nodelist[arc.n1]
        mx, my = (a.x + b.x) / 2, (a.y + b.y) / 2
        d2 = (mx - x) ** 2 + (my - y) ** 2
        if d2 < bd:
            best, bd = i, d2
    if best >= 0:
        _selected_arcs.append(best)
        arc = p.arclist[best]
        _selected_nodes.extend([arc.n0, arc.n1])
    return best


def mi_selectcircle(x, y, R, editmode=4):
    """Select all entities within radius R of (x, y)."""
    p = _d().problem
    for i, nd in enumerate(p.nodelist):
        if (nd.x - x) ** 2 + (nd.y - y) ** 2 <= R * R:
            _selected_nodes.append(i)
    for i, lab in enumerate(p.labellist):
        if (lab.x - x) ** 2 + (lab.y - y) ** 2 <= R * R:
            _selected_labels.append(i)


def mi_selectrectangle(x1, y1, x2, y2, editmode=4):
    p = _d().problem
    xlo, xhi = min(x1, x2), max(x1, x2)
    ylo, yhi = min(y1, y2), max(y1, y2)
    for i, nd in enumerate(p.nodelist):
        if xlo <= nd.x <= xhi and ylo <= nd.y <= yhi:
            _selected_nodes.append(i)
    for i, lab in enumerate(p.labellist):
        if xlo <= lab.x <= xhi and ylo <= lab.y <= yhi:
            _selected_labels.append(i)


def mi_deleteselectednodes():
    p = _d().problem
    for i in sorted(set(_selected_nodes), reverse=True):
        # drop segments/arcs touching the node, then the node itself
        p.linelist[:] = [s for s in p.linelist
                         if s.n0 != i and s.n1 != i]
        p.arclist[:] = [a for a in p.arclist if a.n0 != i and a.n1 != i]
        del p.nodelist[i]
        for s in p.linelist:
            if s.n0 > i:
                s.n0 -= 1
            if s.n1 > i:
                s.n1 -= 1
        for a in p.arclist:
            if a.n0 > i:
                a.n0 -= 1
            if a.n1 > i:
                a.n1 -= 1
    _selected_nodes.clear()
    _d()._mesh = None


def mi_deleteselectedsegments():
    p = _d().problem
    for i in sorted(set(_selected_segments), reverse=True):
        del p.linelist[i]
    _selected_segments.clear()
    _d()._mesh = None


def mi_deleteselectedarcsegments():
    p = _d().problem
    for i in sorted(set(_selected_arcs), reverse=True):
        del p.arclist[i]
    _selected_arcs.clear()
    _d()._mesh = None


def mi_deleteselectedlabels():
    p = _d().problem
    for i in sorted(set(_selected_labels), reverse=True):
        del p.labellist[i]
    _selected_labels.clear()
    _d()._mesh = None


def mi_deleteselected():
    mi_deleteselectedsegments()
    mi_deleteselectedarcsegments()
    mi_deleteselectedlabels()
    mi_deleteselectednodes()


def mi_setgroup(g):
    """Move every selected entity into group g (LuaCommonCommands
    luaSetGroup)."""
    p = _d().problem
    for i in set(_selected_nodes):
        p.nodelist[i].InGroup = int(g)
    for i in set(_selected_segments):
        p.linelist[i].InGroup = int(g)
    for i in set(_selected_arcs):
        p.arclist[i].InGroup = int(g)
    for i in set(_selected_labels):
        p.labellist[i].InGroup = int(g)
    mi_clearselected()


def mi_scale(bx, by, factor):
    from .geometry import editor
    editor.transform_selection(
        _d().problem, "scale", (complex(bx, by), factor),
        group=_selected_groups[-1] if _selected_groups else None)
    _d()._mesh = None


def mi_addbhpoint(name, b, h):
    p = _d().problem
    m = p.blockproplist[p.material_index(name)]
    m.Bdata.append(float(b))
    m.Hdata.append(float(h))
    m.slope = []          # invalidate the spline fit


def mi_clearbhpoints(name):
    p = _d().problem
    m = p.blockproplist[p.material_index(name)]
    m.Bdata.clear()
    m.Hdata.clear()
    m.slope = []


def mi_modifymaterial(name, propnum, value):
    """mi_modifymaterial field order (LuaMagneticsCommands
    luaModifyMaterialProp)."""
    p = _d().problem
    m = p.blockproplist[p.material_index(name)]
    fields = ["name", "mu_x", "mu_y", "H_c", "J", "Cduct", "Lam_d",
              "Theta_hn", "LamFill", "LamType", "Theta_hx", "Theta_hy",
              "NStrands", "WireD"]
    f = fields[int(propnum)]
    if f == "J":
        value = complex(value)
    setattr(m, f, value)


def mi_modifycircprop(name, propnum, value):
    p = _d().problem
    c = p.circproplist[p.circuit_index(name)]
    if int(propnum) == 0:
        c.name = value
    elif int(propnum) == 1:
        c.Amps = complex(value)
    else:
        c.CircType = int(value)


def mi_setcurrent(name, amps):
    mi_modifycircprop(name, 1, amps)


def mi_getprobleminfo():
    p = _d().problem
    from .constants import LENGTH_TO_METERS
    return (int(p.ProblemType), p.Frequency,
            LENGTH_TO_METERS[p.LengthUnits], p.Depth)


def mi_getboundingbox():
    p = _d().problem
    xs = [n.x for n in p.nodelist]
    ys = [n.y for n in p.nodelist]
    return (min(xs), max(xs), min(ys), max(ys))


def mi_purgemesh():
    _d()._mesh = None


def mi_gettitle():
    return _d().path or ""


def mi_saveas_alias(path):
    mi_saveas(path)


# -------- heat-flow / electrostatics document + property verbs --------- #
def hi_probdef(units="meters", probtype="planar", precision=1e-8,
               depth=1.0, minangle=30.0, prevsoln="", timestep=0.0):
    """hi_probdef(units, type, precision, depth, minangle,
    (prevsoln, timestep)) -- LuaHeatflowCommands luaProblemDefinition."""
    p = _d().problem
    p.LengthUnits = _UNITS[units]
    p.ProblemType = (ProblemType.AXISYMMETRIC if probtype.startswith("axi")
                     else ProblemType.PLANAR)
    p.Precision = precision
    p.Depth = depth
    p.MinAngle = minangle
    p.PrevSoln = prevsoln
    p.dT = timestep


def ei_probdef(units="meters", probtype="planar", precision=1e-8,
               depth=1.0, minangle=30.0):
    p = _d().problem
    p.LengthUnits = _UNITS[units]
    p.ProblemType = (ProblemType.AXISYMMETRIC if probtype.startswith("axi")
                     else ProblemType.PLANAR)
    p.Precision = precision
    p.Depth = depth
    p.MinAngle = minangle


def hi_addmaterial(name, kx=1.0, ky=1.0, qv=0.0, kt=0.0):
    from .geometry.problem import HeatMaterial
    _d().problem.blockproplist.append(
        HeatMaterial(name=name, Kx=kx, Ky=ky, qv=qv, Kt=kt))


def hi_addtkpoint(name, T, k):
    p = _d().problem
    m = p.blockproplist[p.material_index(name)]
    m.Tdata.append(float(T))
    m.Kdata.append(float(k))


def hi_cleartkpoints(name):
    p = _d().problem
    m = p.blockproplist[p.material_index(name)]
    m.Tdata.clear()
    m.Kdata.clear()


def ei_addmaterial(name, ex=1.0, ey=1.0, qv=0.0):
    from .geometry.problem import ElectrostaticsMaterial
    _d().problem.blockproplist.append(
        ElectrostaticsMaterial(name=name, ex=ex, ey=ey, qv=qv))


def hi_getmaterial(name, libpath=None):
    """Pull a heat-flow material from the shipped standard library
    (hi_getmaterial; reference heatlib.dat), an explicit library file,
    or $XFEMM_TPU_HEATLIB."""
    from .constants import FileType
    _getmaterial(name, libpath, "XFEMM_TPU_HEATLIB", FileType.HEATFLOW)


def ei_getmaterial(name, libpath=None):
    """Pull an electrostatics material from the shipped standard
    library (ei_getmaterial; reference statlib.dat), an explicit
    library file, or $XFEMM_TPU_STATLIB."""
    from .constants import FileType
    _getmaterial(name, libpath, "XFEMM_TPU_STATLIB",
                 FileType.ELECTROSTATICS)


def hi_addboundprop(name, fmt=0, Tset=0.0, qs=0.0, Tinf=0.0, h=0.0,
                    beta=0.0):
    _d().problem.lineproplist.append(BoundaryProp(
        name=name, BdryFormat=int(fmt), Tset=Tset, qs=qs, Tinf=Tinf,
        h=h, beta=beta))


def ei_addboundprop(name, Vs=0.0, qs=0.0, c0=0.0, c1=0.0, fmt=0):
    # fixed voltage is stored in A0 (the .fee writer emits it as <Vs>)
    _d().problem.lineproplist.append(BoundaryProp(
        name=name, BdryFormat=int(fmt), A0=Vs, qs=qs, c0=c0, c1=c1))


def hi_addconductorprop(name, Tc=0.0, qc=0.0, conductortype=0):
    _d().problem.circproplist.append(Conductor(
        name=name, V=Tc, q=qc, CircType=int(conductortype)))


def ei_addconductorprop(name, Vc=0.0, qc=0.0, conductortype=0):
    _d().problem.circproplist.append(Conductor(
        name=name, V=Vc, q=qc, CircType=int(conductortype)))


def hi_addpointprop(name, Tp=0.0, qp=0.0):
    from .geometry.problem import PointProp
    _d().problem.nodeproplist.append(PointProp(name=name, V=Tp, qp=qp))


def ei_addpointprop(name, Vp=0.0, qp=0.0):
    from .geometry.problem import PointProp
    _d().problem.nodeproplist.append(PointProp(name=name, V=Vp, qp=qp))


def _hi_newdocument(device=None, hbm_bytes: float | None = None):
    return newdocument(2, device, hbm_bytes)


def _ei_newdocument(device=None, hbm_bytes: float | None = None):
    return newdocument(1, device, hbm_bytes)


def hi_modifymaterial(name, propnum, value):
    """Heat-flow field order: name, Kx, Ky, qv, Kt
    (LuaHeatflowCommands luaModifyMaterialProp)."""
    p = _d().problem
    m = p.blockproplist[p.material_index(name)]
    fields = ["name", "Kx", "Ky", "qv", "Kt"]
    setattr(m, fields[int(propnum)], value)


def ei_modifymaterial(name, propnum, value):
    """Electrostatics field order: name, ex, ey, qv
    (LuaElectrostaticsCommands luaModifyMaterialProp)."""
    p = _d().problem
    m = p.blockproplist[p.material_index(name)]
    fields = ["name", "ex", "ey", "qv"]
    setattr(m, fields[int(propnum)], value)


def _deleteconductor(name):
    p = _d().problem
    i = p.circuit_index(name)
    del p.circproplist[i]
    for lst in (p.nodelist, p.linelist, p.arclist):
        for e in lst:
            if getattr(e, "InConductor", -1) == i:
                e.InConductor = -1
            elif getattr(e, "InConductor", -1) > i:
                e.InConductor -= 1


def _modifyconductorprop(name, propnum, value):
    """Field order: name, V (Tc), q (qc), type
    (luaModifyConductorProperty)."""
    p = _d().problem
    c = p.circproplist[p.circuit_index(name)]
    n = int(propnum)
    if n == 0:
        c.name = value
    elif n == 1:
        c.V = value
    elif n == 2:
        c.q = value
    else:
        c.CircType = int(value)


_selected_conductors: list[int] = []


def _o_selectconductor(name):
    """Record the named conductor as selected in the output view
    (luaSelectConductor; selection highlighting only)."""
    p = _d().problem
    _selected_conductors.append(p.circuit_index(name))


globals()["hi_deleteconductor"] = _deleteconductor
globals()["ei_deleteconductor"] = _deleteconductor
globals()["hi_modifyconductorprop"] = _modifyconductorprop
globals()["ei_modifyconductorprop"] = _modifyconductorprop
globals()["ho_selectconductor"] = _o_selectconductor
globals()["eo_selectconductor"] = _o_selectconductor


# hi_/ei_ geometry, selection, transform and pipeline verbs share the
# magnetics implementations (one Document, dispatch on file type)
_SHARED_VERBS = (
    "addnode", "addsegment", "addarc", "addblocklabel", "drawrectangle",
    "selectnode", "selectlabel", "selectgroup", "selectsegment",
    "selectarcsegment", "selectcircle", "selectrectangle",
    "clearselected", "setnodeprop", "setblockprop", "setsegmentprop",
    "setarcsegmentprop", "moverotate", "movetranslate", "copyrotate",
    "mirror", "scale", "setgroup", "deleteselected",
    "deleteselectednodes", "deleteselectedsegments",
    "deleteselectedarcsegments", "deleteselectedlabels", "createmesh",
    "purgemesh", "getboundingbox", "getprobleminfo", "gettitle",
    "modifyboundprop",
    # document-editing verbs shared with the magnetics implementations
    "analyse", "attachdefault", "detachdefault", "attachouterspace",
    "detachouterspace", "defineouterspace", "copytranslate",
    "createradius", "deleteboundprop", "deletematerial",
    "deletepointprop", "modifypointprop", "setprevious",
)
for _pfx in ("hi_", "ei_"):
    for _v in _SHARED_VERBS:
        _impl = globals().get("mi_" + _v)
        if _impl is not None:
            globals().setdefault(_pfx + _v, _impl)

# ho_/eo_ postprocessor verbs shared with the magnetics implementations
# (contours, mesh accessors, selection, smoothing)
_SHARED_O_VERBS = (
    "addcontour", "bendcontour", "clearcontour", "selectpoint",
    "clearblock", "selectblock", "groupselectblock", "getelement",
    "getnode", "getprobleminfo", "gettitle", "numelements", "numnodes",
    "reload", "smooth",
)
for _pfx in ("ho_", "eo_"):
    for _v in _SHARED_O_VERBS:
        _impl = globals().get("mo_" + _v)
        if _impl is not None:
            globals().setdefault(_pfx + _v, _impl)

globals().setdefault("hi_newdocument", _hi_newdocument)
globals().setdefault("ei_newdocument", _ei_newdocument)
for _name in ("hi_zoomnatural", "hi_zoom", "hi_showgrid", "hi_hidegrid",
              "ei_zoomnatural", "ei_zoom", "ei_showgrid", "ei_hidegrid",
              "hi_close", "ei_close", "ho_close", "eo_close",
              "hi_seteditmode", "ei_seteditmode", "mi_seteditmode",
              "mo_seteditmode", "ho_seteditmode", "eo_seteditmode"):
    globals().setdefault(_name, _noop)

# the reference registers the remaining window/plot commands as no-ops
# for every domain prefix (LuaInstance::luaNOP)
for _pfx in ("hi_", "ei_", "ho_", "eo_"):
    for _v in ("gridsnap", "maximize", "minimize", "readdxf",
               "refreshview", "resize", "restore", "savebitmap",
               "savedxf", "savemetafile", "setfocus", "setgrid",
               "showmesh", "shownames", "zoomin", "zoomout", "zoom",
               "zoomnatural", "showgrid", "hidegrid", "makeplot",
               "hidecontourplot", "showcontourplot", "hidedensityplot",
               "showdensityplot", "hidemesh", "hidepoints",
               "showpoints", "showvectorplot"):
        globals().setdefault(_pfx + _v, _noop)
