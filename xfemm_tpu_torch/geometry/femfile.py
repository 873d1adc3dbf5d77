"""Reader/writer for FEMM problem files (.fem / .feh / .fee).

Grammar follows the reference parsers exactly:
* header tokens: cfemm/libfemm/feasolver.cpp:182 ``LoadProblemFile`` and
  cfemm/libfemm/FemmReader.cpp,
* property records: the ``fromStream`` methods in cfemm/libfemm/C*.cpp,
* geometry records: cfemm/libfemm/FemmReader.cpp:434-587,
* writer: FemmProblem::writeProblemDescription (cfemm/libfemm/FemmProblem.cpp).

All indices are converted between the file's 1-based convention and the
in-memory 0-based convention on the way through, like the reference does.
"""

from __future__ import annotations

import io
import math
from typing import TextIO

from ..constants import (
    PI,
    CoordinateSystem,
    FileType,
    LENGTH_UNIT_BY_NAME,
    LENGTH_UNIT_NAMES,
    LengthUnit,
    ProblemType,
)
from ..materials.magnetic import MagneticMaterial
from .problem import (
    ArcSegment,
    BlockLabel,
    BoundaryProp,
    Circuit,
    Conductor,
    ElectrostaticsMaterial,
    HeatMaterial,
    Node,
    PointProp,
    Problem,
    Segment,
)

FILETYPE_BY_SUFFIX = {
    ".fem": FileType.MAGNETICS,
    ".feh": FileType.HEATFLOW,
    ".fee": FileType.ELECTROSTATICS,
}


def _strip_quotes(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        return s[1:-1]
    return s


def _kv_value(line: str) -> str:
    """Value after '=' in a ``[key] = value`` or ``<key> = value`` line."""
    _, _, v = line.partition("=")
    return v.strip()


#: tags whose value is a count of immediately-following data lines
_DATA_TAGS = ("bhpoints", "tkpoints")


class _TaggedBlock:
    """Parses a <BeginX> ... <EndX> tagged record into a dict.

    Tags in ``_DATA_TAGS`` are followed by that many raw data lines inside
    the block (the B-H / T-K curve tables); those are captured into
    ``self.data[tag]``.
    """

    def __init__(self, lines: "LineFeed", endtag: str):
        self.fields: dict[str, str] = {}
        self.data: dict[str, list[str]] = {}
        while True:
            line = lines.next()
            if line is None:
                raise ValueError(f"unterminated block, expected {endtag}")
            tok = line.strip()
            if tok.lower().startswith(endtag):
                break
            key = tok.split("=")[0].strip().lower().strip("<>")
            self.fields[key] = _kv_value(tok)
            if key in _DATA_TAGS:
                count = int(float(self.fields[key]))
                self.data[key] = [lines.next() for _ in range(count)]

    def num(self, key: str, default: float = 0.0) -> float:
        v = self.fields.get(key)
        return float(v) if v is not None else default

    def text(self, key: str, default: str = "") -> str:
        v = self.fields.get(key)
        return _strip_quotes(v) if v is not None else default


class LineFeed:
    def __init__(self, stream: TextIO):
        self._it = iter(stream.read().splitlines())
        self._push: list[str] = []

    def next(self):
        if self._push:
            return self._push.pop()
        return next(self._it, None)

    def pushback(self, line: str):
        self._push.append(line)


def _parse_point_prop(lines: LineFeed, filetype: FileType) -> PointProp:
    blk = _TaggedBlock(lines, "<endpoint>")
    pp = PointProp(name=blk.text("pointname", "New Point Property"))
    if filetype == FileType.MAGNETICS:
        pp.A = complex(blk.num("a_re"), blk.num("a_im"))
        pp.J = complex(blk.num("i_re"), blk.num("i_im"))
    elif filetype == FileType.HEATFLOW:
        pp.V = blk.num("tp")
        pp.qp = blk.num("qp")
    else:
        pp.V = blk.num("vp")
        pp.qp = blk.num("qp")
    return pp


def _parse_bdry_prop(lines: LineFeed, filetype: FileType) -> BoundaryProp:
    blk = _TaggedBlock(lines, "<endbdry>")
    bp = BoundaryProp(name=blk.text("bdryname", "New Boundary"))
    bp.BdryFormat = int(blk.num("bdrytype"))
    if filetype == FileType.MAGNETICS:
        bp.A0 = blk.num("a_0")
        bp.A1 = blk.num("a_1")
        bp.A2 = blk.num("a_2")
        bp.phi = blk.num("phi")
        bp.c0 = complex(blk.num("c0"), blk.num("c0i"))
        bp.c1 = complex(blk.num("c1"), blk.num("c1i"))
        bp.Mu = blk.num("mu_ssd")
        bp.Sig = blk.num("sigma_ssd")
        bp.InnerAngle = blk.num("innerangle")
        bp.OuterAngle = blk.num("outerangle")
    elif filetype == FileType.HEATFLOW:
        bp.Tset = blk.num("tset")
        bp.qs = blk.num("qs")
        bp.beta = blk.num("beta")
        bp.h = blk.num("h")
        bp.Tinf = blk.num("tinf")
    else:
        bp.A0 = blk.num("vs")       # prescribed voltage
        bp.qs = blk.num("qs")       # prescribed surface charge
        bp.c0 = complex(blk.num("c0"), 0.0)
        bp.c1 = complex(blk.num("c1"), 0.0)
    return bp


def _parse_block_prop(lines: LineFeed, filetype: FileType):
    blk = _TaggedBlock(lines, "<endblock>")
    if filetype == FileType.MAGNETICS:
        mat = MagneticMaterial(name=blk.text("blockname", "New Material"))
        mat.mu_x = blk.num("mu_x", 1.0)
        mat.mu_y = blk.num("mu_y", 1.0)
        mat.H_c = blk.num("h_c")
        mat.Theta_hn = blk.num("h_cangle")
        mat.J = complex(blk.num("j_re"), blk.num("j_im"))
        mat.Cduct = blk.num("sigma")
        mat.Lam_d = blk.num("d_lam")
        mat.Theta_hn = blk.num("phi_h", mat.Theta_hn)
        mat.Theta_hx = blk.num("phi_hx")
        mat.Theta_hy = blk.num("phi_hy")
        mat.LamType = int(blk.num("lamtype"))
        mat.LamFill = blk.num("lamfill", 1.0)
        mat.NStrands = int(blk.num("nstrands"))
        mat.WireD = blk.num("wired")
        for row in blk.data.get("bhpoints", []):
            parts = row.split()
            mat.Bdata.append(float(parts[0]))
            mat.Hdata.append(complex(float(parts[1]), 0.0))
        return mat
    if filetype == FileType.HEATFLOW:
        mat = HeatMaterial(name=blk.text("blockname", "New Material"))
        mat.Kx = blk.num("kx", 1.0)
        mat.Ky = blk.num("ky", 1.0)
        mat.Kt = blk.num("kt")
        mat.qv = blk.num("qv")
        for row in blk.data.get("tkpoints", []):
            parts = row.split()
            mat.Tdata.append(float(parts[0]))
            mat.Kdata.append(float(parts[1]))
        return mat
    mat = ElectrostaticsMaterial(name=blk.text("blockname", "New Material"))
    mat.ex = blk.num("ex", 1.0)
    mat.ey = blk.num("ey", 1.0)
    mat.qv = blk.num("qv")
    return mat


def _parse_circuit(lines: LineFeed, filetype: FileType):
    if filetype == FileType.MAGNETICS:
        blk = _TaggedBlock(lines, "<endcircuit>")
        c = Circuit(name=blk.text("circuitname", "New Circuit"))
        c.dVolts = complex(blk.num("voltgradient_re"), blk.num("voltgradient_im"))
        c.Amps = complex(blk.num("totalamps_re"), blk.num("totalamps_im"))
        c.CircType = int(blk.num("circuittype"))
        return c
    blk = _TaggedBlock(lines, "<endconductor>")
    c = Conductor(name=blk.text("conductorname", "New Conductor"))
    if filetype == FileType.HEATFLOW:
        c.V = blk.num("tc")
        c.q = blk.num("qc")
    else:
        c.V = blk.num("vc")
        c.q = blk.num("qc")
    c.CircType = int(blk.num("conductortype"))
    return c


def loads(text: str, filetype: FileType = FileType.MAGNETICS) -> Problem:
    """Parse problem text into a :class:`Problem`."""
    prob = Problem(filetype=filetype)
    lines = LineFeed(io.StringIO(text))
    while True:
        raw = lines.next()
        if raw is None:
            break
        line = raw.strip()
        if not line:
            continue
        token = line.split()[0].lower()

        if token == "[format]":
            prob.Format = float(_kv_value(line))
        elif token == "[frequency]":
            prob.Frequency = float(_kv_value(line))
        elif token == "[precision]":
            prob.Precision = float(_kv_value(line))
        elif token == "[minangle]":
            prob.MinAngle = float(_kv_value(line))
        elif token == "[depth]":
            prob.Depth = float(_kv_value(line))
        elif token == "[dosmartmesh]":
            prob.DoSmartMesh = bool(int(float(_kv_value(line))))
        elif token == "[forcemaxmesh]":
            prob.DoForceMaxMeshArea = bool(int(float(_kv_value(line))))
        elif token == "[lengthunits]":
            prob.LengthUnits = LENGTH_UNIT_BY_NAME[_kv_value(line)]
        elif token == "[problemtype]":
            prob.ProblemType = (ProblemType.PLANAR
                                if _kv_value(line) == "planar"
                                else ProblemType.AXISYMMETRIC)
        elif token == "[coordinates]":
            prob.Coords = (CoordinateSystem.CARTESIAN
                           if _kv_value(line) == "cartesian"
                           else CoordinateSystem.POLAR)
        elif token == "[acsolver]":
            prob.ACSolver = int(float(_kv_value(line)))
        elif token == "[prevtype]":
            prob.PrevType = int(float(_kv_value(line)))
        elif token == "[prevsoln]":
            prob.PrevSoln = _strip_quotes(_kv_value(line))
        elif token == "[comment]":
            prob.Comment = _strip_quotes(_kv_value(line))
        elif token == "[extzo]":
            prob.extZo = float(_kv_value(line))
        elif token == "[extro]":
            prob.extRo = float(_kv_value(line))
        elif token == "[extri]":
            prob.extRi = float(_kv_value(line))
        elif token == "[dt]":
            prob.dT = float(_kv_value(line))
        elif token == "[pointprops]":
            for _ in range(int(_kv_value(line))):
                while True:
                    l2 = lines.next().strip().lower()
                    if l2.startswith("<beginpoint>"):
                        break
                prob.nodeproplist.append(_parse_point_prop(lines, filetype))
        elif token == "[bdryprops]":
            for _ in range(int(_kv_value(line))):
                while True:
                    l2 = lines.next().strip().lower()
                    if l2.startswith("<beginbdry>"):
                        break
                prob.lineproplist.append(_parse_bdry_prop(lines, filetype))
        elif token == "[blockprops]":
            for _ in range(int(_kv_value(line))):
                while True:
                    l2 = lines.next().strip().lower()
                    if l2.startswith("<beginblock>"):
                        break
                prob.blockproplist.append(_parse_block_prop(lines, filetype))
        elif token in ("[circuitprops]", "[conductorprops]"):
            begintag = ("<begincircuit>" if filetype == FileType.MAGNETICS
                        else "<beginconductor>")
            for _ in range(int(_kv_value(line))):
                while True:
                    l2 = lines.next().strip().lower()
                    if l2.startswith(begintag):
                        break
                prob.circproplist.append(_parse_circuit(lines, filetype))
        elif token == "[numpoints]":
            for _ in range(int(_kv_value(line))):
                parts = lines.next().split()
                nd = Node(x=float(parts[0]), y=float(parts[1]),
                          BoundaryMarker=int(parts[2]) - 1,
                          InGroup=int(parts[3]))
                if filetype != FileType.MAGNETICS and len(parts) > 4:
                    nd.InConductor = int(parts[4]) - 1
                prob.nodelist.append(nd)
        elif token == "[numsegments]":
            for _ in range(int(_kv_value(line))):
                parts = lines.next().split()
                sg = Segment(n0=int(parts[0]), n1=int(parts[1]),
                             MaxSideLength=float(parts[2]),
                             BoundaryMarker=int(parts[3]) - 1,
                             Hidden=bool(int(parts[4])),
                             InGroup=int(parts[5]))
                if filetype != FileType.MAGNETICS and len(parts) > 6:
                    sg.InConductor = int(parts[6]) - 1
                prob.linelist.append(sg)
        elif token == "[numarcsegments]":
            for _ in range(int(_kv_value(line))):
                parts = lines.next().split()
                arc = ArcSegment(n0=int(parts[0]), n1=int(parts[1]),
                                 ArcLength=float(parts[2]),
                                 MaxSideLength=float(parts[3]),
                                 BoundaryMarker=int(parts[4]) - 1,
                                 Hidden=bool(int(parts[5])),
                                 InGroup=int(parts[6]))
                arc.mySideLength = arc.MaxSideLength
                if len(parts) > 7:
                    if filetype == FileType.MAGNETICS:
                        arc.mySideLength = float(parts[7])
                    else:
                        arc.InConductor = int(parts[7]) - 1
                prob.arclist.append(arc)
        elif token == "[numholes]":
            for _ in range(int(_kv_value(line))):
                parts = lines.next().split()
                prob.labellist.append(BlockLabel(
                    x=float(parts[0]), y=float(parts[1]),
                    BlockType=-1, InGroup=int(parts[2])))
        elif token == "[numblocklabels]":
            for _ in range(int(_kv_value(line))):
                parts = lines.next().split()
                lab = BlockLabel(x=float(parts[0]), y=float(parts[1]),
                                 BlockType=int(parts[2]) - 1)
                # MaxArea is stored as a mesh-size length d; the area
                # constraint is pi*d^2/4 (CBlockLabel.cpp fromStream)
                maxa = float(parts[3])
                lab.MaxArea = PI * maxa * maxa / 4.0 if maxa > 0 else 0.0
                if filetype == FileType.MAGNETICS:
                    lab.InCircuit = int(parts[4]) - 1
                    lab.MagDir = float(parts[5])
                    lab.InGroup = int(parts[6])
                    lab.Turns = int(float(parts[7]))
                    ext = int(parts[8]) if len(parts) > 8 else 0
                    lab.IsDefault = bool(ext & 2)
                    lab.IsExternal = bool(ext & 1)
                    if len(parts) > 9:
                        lab.MagDirFctn = _strip_quotes(" ".join(parts[9:]))
                else:
                    lab.InGroup = int(parts[4])
                    ext = int(parts[5]) if len(parts) > 5 else 0
                    lab.IsDefault = bool(ext & 2)
                prob.labellist.append(lab)
        elif token == "[solution]":
            break
        # unknown tokens are skipped (ignoreUnhandled semantics)
    return prob


def load(path: str) -> Problem:
    for suffix, ft in FILETYPE_BY_SUFFIX.items():
        if path.endswith(suffix):
            filetype = ft
            break
    else:
        filetype = FileType.MAGNETICS
    with open(path, encoding="utf-8", errors="replace") as f:
        return loads(f.read(), filetype)


# ---------------------------------------------------------------------- #
# writer                                                                 #
# ---------------------------------------------------------------------- #

def _fmt(x: float) -> str:
    return f"{x:.17g}"


def dumps(p: Problem) -> str:
    """Serialize a Problem back to .fem text (magnetics flavor; the heat
    and electrostatics writers follow the same scheme with their fields).
    Mirrors FemmProblem::writeProblemDescription."""
    out = []
    w = out.append
    w(f"[Format]      =  {p.Format}")
    if p.filetype == FileType.MAGNETICS:
        w(f"[Frequency]   =  {_fmt(p.Frequency)}")
    w(f"[Precision]   =  {_fmt(p.Precision)}")
    w(f"[MinAngle]    =  {_fmt(p.MinAngle)}")
    w(f"[DoSmartMesh] =  {int(p.DoSmartMesh)}")
    w(f"[Depth]       =  {_fmt(p.Depth)}")
    w(f"[LengthUnits] =  {LENGTH_UNIT_NAMES[p.LengthUnits]}")
    w(f"[ProblemType] =  "
      f"{'planar' if p.ProblemType == ProblemType.PLANAR else 'axisymmetric'}")
    w(f"[Coordinates] =  "
      f"{'cartesian' if p.Coords == CoordinateSystem.CARTESIAN else 'polar'}")
    if p.filetype == FileType.MAGNETICS:
        w(f"[ACSolver]    =  {p.ACSolver}")
        w(f"[PrevType]    =  {p.PrevType}")
        w(f'[PrevSoln]    =  "{p.PrevSoln}"')
    if p.filetype == FileType.HEATFLOW:
        w(f"[dT]          =  {_fmt(p.dT)}")
        if p.PrevSoln:
            w(f'[PrevSoln]    =  "{p.PrevSoln}"')
    if p.ProblemType == ProblemType.AXISYMMETRIC and (
            p.extZo != 0 or p.extRo != 0 or p.extRi != 0):
        w(f"[extZo] = {_fmt(p.extZo)}")
        w(f"[extRo] = {_fmt(p.extRo)}")
        w(f"[extRi] = {_fmt(p.extRi)}")
    w(f'[Comment]     =  "{p.Comment}"')

    w(f"[PointProps]   = {len(p.nodeproplist)}")
    for pp in p.nodeproplist:
        w("  <BeginPoint>")
        w(f'    <PointName> = "{pp.name}"')
        if p.filetype == FileType.MAGNETICS:
            w(f"    <I_re> = {_fmt(pp.J.real)}")
            w(f"    <I_im> = {_fmt(pp.J.imag)}")
            w(f"    <A_re> = {_fmt(pp.A.real)}")
            w(f"    <A_im> = {_fmt(pp.A.imag)}")
        elif p.filetype == FileType.HEATFLOW:
            w(f"    <Tp> = {_fmt(pp.V)}")
            w(f"    <qp> = {_fmt(pp.qp)}")
        else:
            w(f"    <Vp> = {_fmt(pp.V)}")
            w(f"    <qp> = {_fmt(pp.qp)}")
        w("  <EndPoint>")

    w(f"[BdryProps]   = {len(p.lineproplist)}")
    for bp in p.lineproplist:
        w("  <BeginBdry>")
        w(f'    <BdryName> = "{bp.name}"')
        w(f"    <BdryType> = {bp.BdryFormat}")
        if p.filetype == FileType.MAGNETICS:
            w(f"    <A_0> = {_fmt(bp.A0)}")
            w(f"    <A_1> = {_fmt(bp.A1)}")
            w(f"    <A_2> = {_fmt(bp.A2)}")
            w(f"    <Phi> = {_fmt(bp.phi)}")
            w(f"    <c0> = {_fmt(bp.c0.real)}")
            w(f"    <c0i> = {_fmt(bp.c0.imag)}")
            w(f"    <c1> = {_fmt(bp.c1.real)}")
            w(f"    <c1i> = {_fmt(bp.c1.imag)}")
            w(f"    <Mu_ssd> = {_fmt(bp.Mu)}")
            w(f"    <Sigma_ssd> = {_fmt(bp.Sig)}")
            w(f"    <innerangle> = {_fmt(bp.InnerAngle)}")
            w(f"    <outerangle> = {_fmt(bp.OuterAngle)}")
        elif p.filetype == FileType.HEATFLOW:
            w(f"    <Tset> = {_fmt(bp.Tset)}")
            w(f"    <qs> = {_fmt(bp.qs)}")
            w(f"    <beta> = {_fmt(bp.beta)}")
            w(f"    <h> = {_fmt(bp.h)}")
            w(f"    <Tinf> = {_fmt(bp.Tinf)}")
        else:
            w(f"    <Vs> = {_fmt(bp.A0)}")
            w(f"    <qs> = {_fmt(bp.qs)}")
            w(f"    <c0> = {_fmt(bp.c0.real)}")
            w(f"    <c1> = {_fmt(bp.c1.real)}")
        w("  <EndBdry>")

    w(f"[BlockProps]  = {len(p.blockproplist)}")
    for mp in p.blockproplist:
        w("  <BeginBlock>")
        w(f'    <BlockName> = "{mp.name}"')
        if p.filetype == FileType.MAGNETICS:
            w(f"    <Mu_x> = {_fmt(mp.mu_x)}")
            w(f"    <Mu_y> = {_fmt(mp.mu_y)}")
            w(f"    <H_c> = {_fmt(mp.H_c)}")
            w(f"    <H_cAngle> = {_fmt(mp.Theta_hn)}")
            w(f"    <J_re> = {_fmt(mp.J.real)}")
            w(f"    <J_im> = {_fmt(mp.J.imag)}")
            w(f"    <Sigma> = {_fmt(mp.Cduct)}")
            w(f"    <d_lam> = {_fmt(mp.Lam_d)}")
            w(f"    <Phi_h> = {_fmt(mp.Theta_hn)}")
            w(f"    <Phi_hx> = {_fmt(mp.Theta_hx)}")
            w(f"    <Phi_hy> = {_fmt(mp.Theta_hy)}")
            w(f"    <LamType> = {mp.LamType}")
            w(f"    <LamFill> = {_fmt(mp.LamFill)}")
            w(f"    <NStrands> = {mp.NStrands}")
            w(f"    <WireD> = {_fmt(mp.WireD)}")
            w(f"    <BHPoints> = {mp.BHpoints}")
            for b, h in zip(mp.Bdata, mp.Hdata):
                w(f"      {_fmt(b)}\t{_fmt(h.real)}")
        elif p.filetype == FileType.HEATFLOW:
            w(f"    <Kx> = {_fmt(mp.Kx)}")
            w(f"    <Ky> = {_fmt(mp.Ky)}")
            w(f"    <Kt> = {_fmt(mp.Kt)}")
            w(f"    <qv> = {_fmt(mp.qv)}")
            w(f"    <TKPoints> = {mp.npts}")
            for t, k in zip(mp.Tdata, mp.Kdata):
                w(f"      {_fmt(t)}\t{_fmt(k)}")
        else:
            w(f"    <ex> = {_fmt(mp.ex)}")
            w(f"    <ey> = {_fmt(mp.ey)}")
            w(f"    <qv> = {_fmt(mp.qv)}")
        w("  <EndBlock>")

    if p.filetype == FileType.MAGNETICS:
        w(f"[CircuitProps]  = {len(p.circproplist)}")
        for c in p.circproplist:
            w("  <BeginCircuit>")
            w(f'    <CircuitName> = "{c.name}"')
            w(f"    <TotalAmps_re> = {_fmt(c.Amps.real)}")
            w(f"    <TotalAmps_im> = {_fmt(c.Amps.imag)}")
            w(f"    <CircuitType> = {c.CircType}")
            w("  <EndCircuit>")
    else:
        w(f"[ConductorProps]  = {len(p.circproplist)}")
        for c in p.circproplist:
            w("  <BeginConductor>")
            w(f'    <ConductorName> = "{c.name}"')
            if p.filetype == FileType.HEATFLOW:
                w(f"    <Tc> = {_fmt(c.V)}")
            else:
                w(f"    <Vc> = {_fmt(c.V)}")
            w(f"    <qc> = {_fmt(c.q)}")
            w(f"    <ConductorType> = {c.CircType}")
            w("  <EndConductor>")

    w(f"[NumPoints] = {len(p.nodelist)}")
    for nd in p.nodelist:
        cols = [_fmt(nd.x), _fmt(nd.y), str(nd.BoundaryMarker + 1),
                str(nd.InGroup)]
        if p.filetype != FileType.MAGNETICS:
            cols.append(str(nd.InConductor + 1))
        w("\t".join(cols))
    w(f"[NumSegments] = {len(p.linelist)}")
    for sg in p.linelist:
        cols = [str(sg.n0), str(sg.n1), _fmt(sg.MaxSideLength),
                str(sg.BoundaryMarker + 1), str(int(sg.Hidden)),
                str(sg.InGroup)]
        if p.filetype != FileType.MAGNETICS:
            cols.append(str(sg.InConductor + 1))
        w("\t".join(cols))
    w(f"[NumArcSegments] = {len(p.arclist)}")
    for arc in p.arclist:
        cols = [str(arc.n0), str(arc.n1), _fmt(arc.ArcLength),
                _fmt(arc.MaxSideLength), str(arc.BoundaryMarker + 1),
                str(int(arc.Hidden)), str(arc.InGroup)]
        if p.filetype == FileType.MAGNETICS:
            cols.append(_fmt(arc.mySideLength))
        else:
            cols.append(str(arc.InConductor + 1))
        w("\t".join(cols))
    holes = [lab for lab in p.labellist if lab.is_hole()]
    w(f"[NumHoles] = {len(holes)}")
    for lab in holes:
        w(f"{_fmt(lab.x)}\t{_fmt(lab.y)}\t{lab.InGroup}")
    labels = [lab for lab in p.labellist if not lab.is_hole()]
    w(f"[NumBlockLabels] = {len(labels)}")
    for lab in labels:
        # invert the pi*d^2/4 area transform back to the stored length
        d = math.sqrt(4.0 * lab.MaxArea / PI) if lab.MaxArea > 0 else -1.0
        if p.filetype == FileType.MAGNETICS:
            ext = (2 if lab.IsDefault else 0) | (1 if lab.IsExternal else 0)
            cols = [_fmt(lab.x), _fmt(lab.y), str(lab.BlockType + 1),
                    _fmt(d), str(lab.InCircuit + 1), _fmt(lab.MagDir),
                    str(lab.InGroup), str(lab.Turns), str(ext)]
            if lab.MagDirFctn:
                cols.append(f'"{lab.MagDirFctn}"')
        else:
            ext = 2 if lab.IsDefault else 0
            cols = [_fmt(lab.x), _fmt(lab.y), str(lab.BlockType + 1),
                    _fmt(d), str(lab.InGroup), str(ext)]
        w("\t".join(cols))
    return "\n".join(out) + "\n"


def dump(p: Problem, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps(p))
