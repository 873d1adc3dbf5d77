"""In-memory problem document model (geometry + properties).

TPU-native counterpart of the reference's ``FemmProblem`` CAD document
(cfemm/libfemm/FemmProblem.h:60): node/segment/arc/hole/label lists plus the
four property lists. This is pure host-side Python; the mesher consumes it
and emits packed NumPy arrays for the device pipeline.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

from ..constants import (
    PI,
    CoordinateSystem,
    FileType,
    LengthUnit,
    ProblemType,
)
from ..materials.magnetic import MagneticMaterial


@dataclass
class Node:
    """Geometry-defining point (cfemm/libfemm/CNode.h)."""

    x: float = 0.0
    y: float = 0.0
    BoundaryMarker: int = -1   # index into nodeprops, -1 = none
    InGroup: int = 0
    InConductor: int = -1      # heat/electrostatics only

    def cc(self) -> complex:
        return complex(self.x, self.y)


@dataclass
class Segment:
    """Line segment between two nodes (cfemm/libfemm/CSegment.h)."""

    n0: int = 0
    n1: int = 0
    MaxSideLength: float = -1.0
    BoundaryMarker: int = -1
    Hidden: bool = False
    InGroup: int = 0
    InConductor: int = -1
    # scratch used by the mesher (mirrors the reference's cnt/IsSelected)
    cnt: int = 0
    IsSelected: bool = False


@dataclass
class ArcSegment:
    """Circular arc from n0 to n1, counter-clockwise, spanning ArcLength
    degrees (cfemm/libfemm/CArcSegment.h)."""

    n0: int = 0
    n1: int = 0
    ArcLength: float = 90.0
    MaxSideLength: float = 10.0
    BoundaryMarker: int = -1
    Hidden: bool = False
    InGroup: int = 0
    InConductor: int = -1
    mySideLength: float = -1.0
    NormalDirection: bool = True
    cnt: int = 0
    IsSelected: bool = False


@dataclass
class BlockLabel:
    """Region label (cfemm/libfemm/CBlockLabel.h). ``BlockType`` indexes the
    material list; -1 marks a hole (``<No Mesh>``)."""

    x: float = 0.0
    y: float = 0.0
    BlockType: int = -1
    MaxArea: float = 0.0       # triangle area constraint (already pi*d^2/4)
    InCircuit: int = -1
    MagDir: float = 0.0
    MagDirFctn: str = ""
    InGroup: int = 0
    Turns: int = 1
    IsExternal: bool = False
    IsDefault: bool = False

    def is_hole(self) -> bool:
        return self.BlockType < 0


@dataclass
class PointProp:
    """Magnetics point property: prescribed A or point current
    (cfemm/libfemm/CPointProp.h)."""

    name: str = "New Point Property"
    A: complex = 0.0
    J: complex = 0.0
    # heat/electrostatics flavors
    V: float = 0.0
    qp: float = 0.0


class BdryFormat:
    """Magnetics boundary types (cfemm/libfemm/CBoundaryProp.h)."""

    PRESCRIBED_A = 0
    SMALL_SKIN_DEPTH = 1
    MIXED = 2
    STRATEGIC_DUAL_IMAGE = 3
    PERIODIC = 4
    ANTIPERIODIC = 5
    PERIODIC_AIRGAP = 6
    ANTIPERIODIC_AIRGAP = 7


@dataclass
class BoundaryProp:
    """Boundary condition property (cfemm/libfemm/CBoundaryProp.h)."""

    name: str = "New Boundary"
    BdryFormat: int = 0
    A0: float = 0.0
    A1: float = 0.0
    A2: float = 0.0
    phi: float = 0.0
    Mu: float = 0.0            # small-skin-depth relative permeability
    Sig: float = 0.0           # small-skin-depth conductivity [MS/m]
    c0: complex = 0.0          # mixed-BC coefficients
    c1: complex = 0.0
    InnerAngle: float = 0.0    # air-gap element rotor/stator shift [deg]
    OuterAngle: float = 0.0
    # heat-flow flavors (Tset, beta/convection, h, Tinf, emissivity)
    Tset: float = 0.0
    qs: float = 0.0
    beta: float = 0.0
    h: float = 0.0
    Tinf: float = 0.0

    def is_periodic(self) -> bool:
        return self.BdryFormat in (BdryFormat.PERIODIC, BdryFormat.ANTIPERIODIC)

    def is_airgap(self) -> bool:
        return self.BdryFormat in (BdryFormat.PERIODIC_AIRGAP,
                                   BdryFormat.ANTIPERIODIC_AIRGAP)


@dataclass
class Circuit:
    """Circuit property (cfemm/libfemm/CCircuit.h). CircType 0 = parallel
    (total current constraint), 1 = series."""

    name: str = "New Circuit"
    dVolts: complex = 0.0
    Amps: complex = 0.0
    CircType: int = 0
    # solved results (fsolver Case 0/1/2 bookkeeping)
    Case: int = 0
    dV: complex = 0.0
    J: complex = 0.0


@dataclass
class Problem:
    """Complete problem document. Mirrors cfemm/libfemm/FemmProblem.h:60."""

    filetype: FileType = FileType.MAGNETICS
    Format: float = 4.0
    Frequency: float = 0.0
    Precision: float = 1e-08
    MinAngle: float = 30.0
    Depth: float = 1.0
    LengthUnits: LengthUnit = LengthUnit.INCHES
    ProblemType: ProblemType = ProblemType.PLANAR
    Coords: CoordinateSystem = CoordinateSystem.CARTESIAN
    ACSolver: int = 0
    PrevType: int = 0
    PrevSoln: str = ""
    Comment: str = "Add comments here."
    DoSmartMesh: bool = True
    DoForceMaxMeshArea: bool = False
    extZo: float = 0.0
    extRo: float = 0.0
    extRi: float = 0.0
    # heat flow transient parameters (cfemm/hsolver/hsolver.h:36-42)
    dT: float = 0.0

    nodelist: list[Node] = field(default_factory=list)
    linelist: list[Segment] = field(default_factory=list)
    arclist: list[ArcSegment] = field(default_factory=list)
    labellist: list[BlockLabel] = field(default_factory=list)
    nodeproplist: list[PointProp] = field(default_factory=list)
    lineproplist: list[BoundaryProp] = field(default_factory=list)
    blockproplist: list = field(default_factory=list)
    circproplist: list[Circuit] = field(default_factory=list)

    # ------------------------------------------------------------------ #
    # geometry helpers                                                   #
    # ------------------------------------------------------------------ #
    def length_of_line(self, seg: Segment | int) -> float:
        if isinstance(seg, int):
            seg = self.linelist[seg]
        a = self.nodelist[seg.n0]
        b = self.nodelist[seg.n1]
        return math.hypot(b.x - a.x, b.y - a.y)

    def get_circle(self, arc: ArcSegment) -> tuple[complex, float]:
        """Center and radius of an arc's circle
        (FemmProblem::getCircle)."""
        a0 = self.nodelist[arc.n0].cc()
        a1 = self.nodelist[arc.n1].cc()
        dist = abs(a1 - a0)
        theta = arc.ArcLength * PI / 180.0
        R = dist / (2.0 * math.sin(theta / 2.0))
        # center: along the perpendicular bisector, CCW side
        t = (a1 - a0) / dist
        center = a0 + (dist / 2.0 + 1j * math.sqrt(max(R * R - dist * dist / 4.0, 0.0))) * t
        return center, R

    def average_line_length(self) -> float:
        if not self.linelist:
            return 0.0
        return sum(self.length_of_line(s) for s in self.linelist) / len(self.linelist)

    def count_holes(self) -> int:
        return sum(1 for lab in self.labellist if lab.is_hole())

    # name lookups ------------------------------------------------------ #
    def boundary_index(self, name: str) -> int:
        for i, bp in enumerate(self.lineproplist):
            if bp.name == name:
                return i
        return -1

    def material_index(self, name: str) -> int:
        for i, mp in enumerate(self.blockproplist):
            if mp.name == name:
                return i
        return -1

    def circuit_index(self, name: str) -> int:
        for i, cp in enumerate(self.circproplist):
            if cp.name == name:
                return i
        return -1

    def point_prop_index(self, name: str) -> int:
        for i, pp in enumerate(self.nodeproplist):
            if pp.name == name:
                return i
        return -1

    # ------------------------------------------------------------------ #
    # geometry construction (the addNode/addSegment editing surface of   #
    # FemmProblem.h:134-206, simplified: intersection splitting is done  #
    # for exact duplicates only; full CSG editing lives in api.py)       #
    # ------------------------------------------------------------------ #
    def add_node(self, x: float, y: float, tol: float = 1e-08) -> int:
        for i, nd in enumerate(self.nodelist):
            if math.hypot(nd.x - x, nd.y - y) < tol:
                return i
        self.nodelist.append(Node(x=x, y=y))
        return len(self.nodelist) - 1

    def add_segment(self, n0: int, n1: int, **kw) -> int:
        for i, sg in enumerate(self.linelist):
            if {sg.n0, sg.n1} == {n0, n1}:
                return i
        self.linelist.append(Segment(n0=n0, n1=n1, **kw))
        return len(self.linelist) - 1

    def add_arc(self, n0: int, n1: int, arc_length: float, max_seg_deg: float,
                **kw) -> int:
        self.arclist.append(ArcSegment(n0=n0, n1=n1, ArcLength=arc_length,
                                       MaxSideLength=max_seg_deg, **kw))
        return len(self.arclist) - 1

    def add_block_label(self, x: float, y: float, **kw) -> int:
        self.labellist.append(BlockLabel(x=x, y=y, **kw))
        return len(self.labellist) - 1

    def clone(self) -> "Problem":
        import copy

        return copy.deepcopy(self)


# Heat-flow and electrostatics material properties share the Problem
# container; they are small dataclasses of their own.

@dataclass
class HeatMaterial:
    """Thermal material (cfemm/libfemm/CMaterialProp.h:225 CHMaterialProp):
    orthotropic conductivity, optional K(T) curve, volume heat source."""

    name: str = "New Material"
    Kx: float = 1.0
    Ky: float = 1.0
    Kt: float = 0.0            # volumetric heat capacity [MJ/(m^3*K)]
    qv: float = 0.0            # volume heat generation [W/m^3]
    Tdata: list[float] = field(default_factory=list)
    Kdata: list[float] = field(default_factory=list)

    @property
    def npts(self) -> int:
        return len(self.Tdata)

    def get_k(self, T: float) -> tuple[float, float]:
        """Conductivity at temperature T, piecewise-linear in the K(T)
        curve, clamped at the ends and isotropic when a curve is given
        (CMaterialProp.cpp:1388 CHMaterialProp::GetK)."""
        if self.npts == 0:
            return self.Kx, self.Ky
        if self.npts == 1 or T <= self.Tdata[0]:
            return self.Kdata[0], self.Kdata[0]
        if T >= self.Tdata[-1]:
            return self.Kdata[-1], self.Kdata[-1]
        i = 0
        while i < self.npts - 2 and self.Tdata[i + 1] < T:
            i += 1
        t0, t1 = self.Tdata[i], self.Tdata[i + 1]
        k0, k1 = self.Kdata[i], self.Kdata[i + 1]
        k = k0 + (k1 - k0) * (T - t0) / (t1 - t0)
        return k, k

    def get_k_array(self, T: "np.ndarray") -> "np.ndarray":
        """Vectorized ``get_k`` over an array of temperatures for
        materials with a K(T) curve, which is always isotropic (same
        clamped piecewise-linear rule). Materials WITHOUT a curve may be
        orthotropic (Kx != Ky) and must use ``Kx``/``Ky`` directly --
        this raises rather than silently dropping Ky."""
        import numpy as np

        if self.npts == 0:
            if self.Kx != self.Ky:
                raise ValueError(
                    "get_k_array is for isotropic K(T)-curve materials; "
                    f"'{self.name}' is orthotropic (Kx={self.Kx}, "
                    f"Ky={self.Ky}) -- use Kx/Ky directly")
            return np.full(np.shape(T), self.Kx)
        if self.npts == 1:
            return np.full(np.shape(T), self.Kdata[0])
        return np.interp(T, self.Tdata, self.Kdata)


@dataclass
class ElectrostaticsMaterial:
    """Electrostatics material (cfemm/libfemm/CMaterialProp.h:270):
    orthotropic relative permittivity + volume charge density."""

    name: str = "New Material"
    ex: float = 1.0
    ey: float = 1.0
    qv: float = 0.0


@dataclass
class Conductor:
    """Heat/electrostatics conductor (fixed potential/temperature or total
    charge/flux), cfemm/libfemm/CCircuit.h CHConductor/CSConductor."""

    name: str = "New Conductor"
    V: float = 0.0       # prescribed temperature / voltage
    q: float = 0.0       # prescribed total flux / charge
    CircType: int = 0    # 0 = prescribed q, 1 = prescribed V
    # solved results
    V_result: float = 0.0
    q_result: float = 0.0
