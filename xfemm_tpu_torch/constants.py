"""Physical constants and unit conventions shared across the framework.

These mirror the numerical conventions of the reference implementation
(cfemm/libfemm/femmconstants.h, cfemm/libfemm/femmenums.h:33-96) exactly:
the solvers internally rescale all coordinates to centimeters for
conditioning (cfemm/fsolver/fsolver.cpp:386-388), and the magnetics solver
works with a scaled potential ``V = A / c`` where ``c = 4e-5 * pi``
(cfemm/fsolver/static2d.cpp:66).
"""

from __future__ import annotations

import enum
import math

PI = math.pi
MU0 = PI * 4e-07          # vacuum permeability [H/m]
DEG = PI / 180.0          # degrees -> radians
SMALL_VALUE = 1e-14

#: Scaled-potential conversion factor used by the magnetostatic solver:
#: lengths are in cm internally, so curl(A) picks up a factor 100;
#: A = C_APOT * V converts the solved vector back to SI vector potential.
C_APOT = PI * 4e-05


class LengthUnit(enum.IntEnum):
    """Problem length units, in the reference's enum order
    (cfemm/libfemm/femmenums.h:33)."""

    INCHES = 0
    MILLIMETERS = 1
    CENTIMETERS = 2
    METERS = 3
    MILS = 4
    MICROMETERS = 5


#: Conversion from one problem length unit to meters
#: (cfemm/libfemm/femmenums.h:51 ``LengthConvMeters``).
LENGTH_TO_METERS = {
    LengthUnit.INCHES: 0.0254,
    LengthUnit.MILLIMETERS: 0.001,
    LengthUnit.CENTIMETERS: 0.01,
    LengthUnit.METERS: 1.0,
    LengthUnit.MILS: 2.54e-05,
    LengthUnit.MICROMETERS: 1.0e-06,
}

#: Conversion from problem units to centimeters, the solver-internal unit
#: (the ``units[]`` tables in cfemm/fsolver/static2d.cpp:67).
LENGTH_TO_CM = {u: 100.0 * m for u, m in LENGTH_TO_METERS.items()}

LENGTH_UNIT_NAMES = {
    LengthUnit.INCHES: "inches",
    LengthUnit.MILLIMETERS: "millimeters",
    LengthUnit.CENTIMETERS: "centimeters",
    LengthUnit.METERS: "meters",
    LengthUnit.MILS: "mils",
    LengthUnit.MICROMETERS: "microns",
}

LENGTH_UNIT_BY_NAME = {v: k for k, v in LENGTH_UNIT_NAMES.items()}


class ProblemType(enum.IntEnum):
    PLANAR = 0
    AXISYMMETRIC = 1


class CoordinateSystem(enum.IntEnum):
    CARTESIAN = 0
    POLAR = 1


class FileType(enum.IntEnum):
    """Problem-domain file flavors (cfemm/libfemm/femmenums.h:98)."""

    MAGNETICS = 0
    HEATFLOW = 1
    ELECTROSTATICS = 2
