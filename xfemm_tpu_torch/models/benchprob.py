"""Synthetic scalable benchmark problem generator.

Builds a nonlinear magnetostatic problem -- a saturated steel cylinder
between two opposing coil regions inside an air box with A=0 on the outer
boundary -- whose mesh density (and therefore DOF count) is set by one
knob. Both this framework and the reference fsolver can solve the exact
same premeshed files, giving an apples-to-apples performance baseline
(the JAX package's bench.py; the port's chip_smoke.py drives
build(250_000) on the card).
"""

from __future__ import annotations

import numpy as np

from ..constants import FileType, LengthUnit, ProblemType
from ..geometry.problem import (BlockLabel, BoundaryProp, Node, PointProp,
                                Problem, Segment, ArcSegment)
from ..materials.magnetic import MagneticMaterial

#: The reference test suite's nonlinear steel curve
#: (cfemm/fsolver/test/Temp.fem blockprops).
STEEL_BH = [(0.0, 0.0), (0.7004, 238.7325), (1.351, 795.775),
            (1.624, 3183.1), (1.77, 7957.75), (2.0, 31831.0),
            (2.23, 111408.5), (2.725, 270099.75), (3.87, 1178736.3)]


def build(target_nodes: int = 1_000_000) -> Problem:
    """Planar nonlinear magnetostatics, meters, Precision 1e-8."""
    p = Problem(filetype=FileType.MAGNETICS)
    p.Frequency = 0.0
    p.Precision = 1e-08
    p.MinAngle = 30.0
    p.Depth = 1.0
    p.LengthUnits = LengthUnit.METERS
    p.ProblemType = ProblemType.PLANAR
    p.DoSmartMesh = False

    air = MagneticMaterial(name="Air")
    steel = MagneticMaterial(name="Steel")
    for b, h in STEEL_BH:
        steel.Bdata.append(b)
        steel.Hdata.append(complex(h))
    coil_p = MagneticMaterial(name="Coil+", J=2.0)   # MA/m^2
    coil_n = MagneticMaterial(name="Coil-", J=-2.0)
    p.blockproplist = [air, steel, coil_p, coil_n]

    p.lineproplist = [BoundaryProp(name="A0", BdryFormat=0)]
    p.nodeproplist = [PointProp(name="origin")]

    # outer box
    corners = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
    ids = [p.add_node(x, y) for x, y in corners]
    for i in range(4):
        p.linelist.append(Segment(n0=ids[i], n1=ids[(i + 1) % 4],
                                  BoundaryMarker=0))
    # steel cylinder r=0.3 at center: two half arcs
    a = p.add_node(0.3, 0.0)
    b = p.add_node(-0.3, 0.0)
    p.arclist.append(ArcSegment(n0=a, n1=b, ArcLength=180,
                                MaxSideLength=5.0))
    p.arclist.append(ArcSegment(n0=b, n1=a, ArcLength=180,
                                MaxSideLength=5.0))
    # coils: rectangles left and right
    for sgn, name in ((1, None), (-1, None)):
        x0, x1 = 0.45 * sgn, 0.7 * sgn
        y0, y1 = -0.5, 0.5
        c = [p.add_node(x0, y0), p.add_node(x1, y0),
             p.add_node(x1, y1), p.add_node(x0, y1)]
        for i in range(4):
            p.linelist.append(Segment(n0=c[i], n1=c[(i + 1) % 4]))

    # area constraint for the target DOF count: total area 4 m^2; the
    # 0.857 factor calibrates the refiner's actual density (measured
    # with the generation-stamped refinement queue at the magnetics
    # area_tighten of 1.0: build(250_000) -> ~250k mesh nodes)
    domain_area = 4.0
    max_area = 0.857 * domain_area / max(target_nodes, 100)
    p.labellist = [
        BlockLabel(x=0.0, y=0.9, BlockType=0, MaxArea=max_area),     # air
        BlockLabel(x=0.0, y=0.0, BlockType=1, MaxArea=max_area),     # steel
        BlockLabel(x=0.575, y=0.0, BlockType=2, MaxArea=max_area),   # coil+
        BlockLabel(x=-0.575, y=0.0, BlockType=3, MaxArea=max_area),  # coil-
    ]
    return p


def build_ac(target_nodes: int = 125_000, freq: float = 50.0) -> Problem:
    """AC eddy-current benchmark: the same geometry with LINEAR
    conductive steel (mu_r 1000, 2 MS/m) under 50 Hz coil drive --
    the complex-symmetric K + jwM solve path (harmonic2d.cpp:38). The
    port's chip_smoke.py drives build_ac(125_000) on the card."""
    p = build(target_nodes)
    p.Frequency = freq
    steel = p.blockproplist[1]
    steel.Bdata.clear()
    steel.Hdata.clear()
    steel.mu_x = steel.mu_y = 1000.0
    steel.Cduct = 2.0
    return p


def build_heat(target_nodes: int = 230_000) -> Problem:
    """Nonlinear K(T) heat-flow benchmark: a heated cylinder (volume
    source, strongly temperature-dependent conductivity) inside a
    conducting box with a fixed-temperature outer boundary -- the
    successive-substitution outer loop of hsolver.cpp:458. The port's
    chip_smoke.py drives build_heat(230_000) on the card."""
    from ..geometry.problem import HeatMaterial

    p = Problem(filetype=FileType.HEATFLOW)
    p.Precision = 1e-08
    p.MinAngle = 30.0
    p.Depth = 1.0
    p.LengthUnits = LengthUnit.METERS
    p.ProblemType = ProblemType.PLANAR
    p.DoSmartMesh = False

    medium = HeatMaterial(name="Medium", Kx=0.8, Ky=0.8)
    core = HeatMaterial(name="Core", qv=2.0e4)
    core.Tdata = [0.0, 100.0, 300.0, 600.0, 1000.0]
    core.Kdata = [60.0, 45.0, 28.0, 16.0, 10.0]
    p.blockproplist = [medium, core]
    p.lineproplist = [BoundaryProp(name="T0", BdryFormat=0, Tset=300.0)]
    p.nodeproplist = [PointProp(name="origin")]

    corners = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
    ids = [p.add_node(x, y) for x, y in corners]
    for i in range(4):
        p.linelist.append(Segment(n0=ids[i], n1=ids[(i + 1) % 4],
                                  BoundaryMarker=0))
    a = p.add_node(0.3, 0.0)
    b = p.add_node(-0.3, 0.0)
    p.arclist.append(ArcSegment(n0=a, n1=b, ArcLength=180,
                                MaxSideLength=5.0))
    p.arclist.append(ArcSegment(n0=b, n1=a, ArcLength=180,
                                MaxSideLength=5.0))
    max_area = 0.857 * 4.0 / max(target_nodes, 100)
    p.labellist = [
        BlockLabel(x=0.0, y=0.9, BlockType=0, MaxArea=max_area),
        BlockLabel(x=0.0, y=0.0, BlockType=1, MaxArea=max_area),
    ]
    return p
