"""Default scripting environment (the reference's auto-loaded init.lua).

femmcli locates and runs ``release/init.lua`` on every invocation
(cfemm/femmcli/main.cpp:125 via location::locateFile), predefining the
physical constants (``uo``, ``eo``), unit conversion factors (``inch``,
``cm``, ``Gauss``, ...), the ``AWG`` wire-gauge helper, the
``*_drawline/drawarc/drawrectangle`` geometry helpers, the
``mi_setbhpointsfromfile`` B-H import helper, and the ``*_makeABC``
asymptotic-open-boundary builders with their fitted shell-permeability
tables.  Real-world FEMM scripts rely on these (``uo`` in particular),
so the interpreter installs the same environment by default; passing
``--lua-init`` still layers a user file on top, exactly as femmcli's
flag does (main.cpp:150).

The four ABC coefficient tables are a numerical contract and ship as
``data/abc_mu.json`` (re-emitted from the reference by
tools/make_abc_tables.py, like the material libraries); the helper
functions are reimplemented here in Python over the femm_compat verb
surface rather than as Lua source.
"""

from __future__ import annotations

import functools
import json
import math
import os

_E = 2.718281828459045


@functools.lru_cache(maxsize=1)
def abc_tables() -> dict:
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "abc_mu.json")
    with open(path) as f:
        return json.load(f)


def _lua_table(rows):
    """Nested 1-based dict-of-dicts, the interpreter's table encoding."""
    return {float(i + 1): {float(j + 1): v for j, v in enumerate(row)}
            for i, row in enumerate(rows)}


#: scalar constants of release/init.lua:1-36
CONSTANTS: dict[str, float] = {
    "uo": math.pi * 4e-7,
    "eo": 8.85418781762e-12,
    "Pi": math.pi, "pi": math.pi,
    "meter": 1.0, "inch": 0.0254, "cm": 0.01, "mm": 0.001,
    "um": 1e-6, "mil": 0.001 * 0.0254,
    "Tesla": 1.0, "mTesla": 0.001, "Gauss": 0.0001, "kGauss": 0.1,
    "AmpMeter": 1.0, "kAmpMeter": 1000.0,
    "Oersted": 250.0 / math.pi, "kOersted": 250000.0 / math.pi,
}
for _base, _aliases in (
        ("meter", ("meters", "Meter", "Meters")),
        ("inch", ("inches", "Inch", "Inches", "in")),
        ("cm", ("centimeter", "centimeters", "Centimeter", "Centimeters")),
        ("mm", ("millimeter", "millimeters", "Millimeter", "Millimeters",
                "milimeter", "milimeters")),
        ("um", ("micrometer", "micrometers", "Micrometer", "Micrometers",
                "micron", "microns", "Micron", "Microns")),
        ("mil", ("mils", "Mil", "Mils"))):
    for _a in _aliases:
        CONSTANTS[_a] = CONSTANTS[_base]


def _awg(awg):
    """Diameter in mm of an AWG wire gauge (init.lua AWG())."""
    return 8.2514694 * math.exp(-0.115943 * float(awg))


def _compat():
    from .. import femm_compat
    return femm_compat


def _verb(prefix: str, name: str):
    fc = _compat()
    fn = getattr(fc, prefix + name, None)
    if fn is None:
        raise RuntimeError(f"{prefix}{name} is not available")
    return fn


def _make_draw_helpers(prefix: str):
    def drawline(x1, y1, x2, y2):
        _verb(prefix, "addnode")(x1, y1)
        _verb(prefix, "addnode")(x2, y2)
        _verb(prefix, "addsegment")(x1, y1, x2, y2)

    def drawarc(x1, y1, x2, y2, tta, dtta):
        _verb(prefix, "addnode")(x1, y1)
        _verb(prefix, "addnode")(x2, y2)
        _verb(prefix, "addarc")(x1, y1, x2, y2, tta, dtta)

    def drawrectangle(x1, y1, x2, y2):
        drawline(x1, y1, x2, y1)
        drawline(x2, y1, x2, y2)
        drawline(x2, y2, x1, y2)
        drawline(x1, y2, x1, y1)

    return drawline, drawarc, drawrectangle


def _make_abc(prefix: str, mat_prefix: str, is_mag: bool):
    """``*_makeABC([n], [R], [x], [y], [bc])`` -- build an n-shell
    improvised asymptotic boundary condition around the model, placing
    shell materials from the fitted tables (init.lua mi_makeABC and the
    ei_/hi_ analogues; the magnetics variant uses the u2D*/uAx* tables
    directly, the scalar domains swap the 0/1 roles)."""

    def makeabc(enn=None, arr=None, ex=None, wye=None, bc=None):
        tabs = abc_tables()
        x0, x1, y0, y1 = _verb(prefix, "getboundingbox")()
        flag = int(_verb(prefix, "getprobleminfo")()[0])
        n = 7 if enn is None else max(1, min(12, int(enn)))
        if bc is None:
            # magnetics defaults to Dirichlet; the scalar-potential
            # domains default Neumann in 2-D, Dirichlet axi
            bctype = 0 if is_mag else (1 if flag == 0 else 0)
        else:
            bctype = int(bc)
        if flag == 0:
            R = (0.75 * abs(complex(x0, y0) - complex(x1, y1))
                 if arr is None else float(arr))
            x = (x0 + x1) / 2.0 if ex is None else float(ex)
            y = (y0 + y1) / 2.0 if wye is None else float(wye)
        else:
            x = 0.0
            if wye is not None:
                y, R = float(wye), float(arr)
            elif ex is not None:
                y, R = float(ex), float(arr)
            elif arr is not None:
                y, R = (y0 + y1) / 2.0, float(arr)
            else:
                y = (y0 + y1) / 2.0
                R = 1.5 * abs(complex(x1, (y1 - y0) / 2.0))
        drawline, drawarc, _ = _make_draw_helpers(prefix)
        # interior-domain boundary
        if flag == 0:
            drawarc(x, y + R, x, y - R, 180, 1)
        else:
            drawline(0, y - 1.1 * R, 0, y + 1.1 * R)
        drawarc(x, y - R, x, y + R, 180, 1)
        d = 0.1 * R / (2 * n)
        if is_mag:
            t2d = tabs["u2D0"] if bctype == 0 else tabs["u2D1"]
            tax = tabs["uAx0"] if bctype == 0 else tabs["uAx1"]
        else:
            t2d = tabs["u2D1"] if bctype == 0 else tabs["u2D0"]
            tax = tabs["uAx1"] if bctype == 0 else tabs["uAx0"]
        for k in range(1, n + 1):
            r = R * (1 + (2 * k - 1) / (20.0 * n))
            drawarc(x, y - r - d, x, y + r + d, 180, 1)
            z = r * complex(math.cos(math.radians(90.0 * k / (n + 1))),
                            math.sin(math.radians(90.0 * k / (n + 1))))
            name = f"{mat_prefix}{k}"
            _verb(prefix, "addblocklabel")(x + z.real, y + z.imag)
            _verb(prefix, "selectlabel")(x + z.real, y + z.imag)
            _verb(prefix, "setblockprop")(name, 1, 0, "<None>", 0, 0, 1)
            _verb(prefix, "clearselected")()
            mu = (t2d if flag == 0 else tax)[n - 1][k - 1]
            # a single-mu addmaterial mirrors it into both axes
            # (LuaMagneticsCommands.cpp luaAddMatProperty: n>1 sets
            # mu_y = mu_x)
            _verb(prefix, "addmaterial")(name, mu, mu)
            if flag == 0:
                drawarc(x, y + r + d, x, y - r - d, 180, 1)
        if bctype == 0:
            bname = "A=0" if is_mag else "V=0"
            if is_mag:
                _verb(prefix, "addboundprop")(bname, 0, 0, 0, 0, 0, 0, 0,
                                              0, 0)
            else:
                _verb(prefix, "addboundprop")(bname)
            _verb(prefix, "selectarcsegment")(1.1 * R + x, y)
            if flag == 0:
                _verb(prefix, "selectarcsegment")(-1.1 * R + x, y)
            _verb(prefix, "setarcsegmentprop")(1, bname, 0, 0)
            _verb(prefix, "clearselected")()

    return makeabc


def _setbhpointsfromfile(filename, materialname, unitb=None, unith=None,
                         order=None):
    """Read (B, H) pairs from a whitespace-separated file into a
    material (init.lua mi_setbhpointsfromfile, by Dr. Henning Kiel);
    ``order == 1`` means H-first columns."""
    fc = _compat()
    fact_b = 1.0 if unitb is None else float(unitb)
    fact_h = 1.0 if unith is None else float(unith)
    bh_first = not (order is not None and int(order) == 1)
    fc.mi_clearbhpoints(materialname)
    with open(filename) as f:
        vals = f.read().split()
    for i in range(0, len(vals) - 1, 2):
        a, bv = float(vals[i]), float(vals[i + 1])
        b, h = (a, bv) if bh_first else (bv, a)
        fc.mi_addbhpoint(materialname, b * fact_b, h * fact_h)


def install(g: dict) -> None:
    """Install the default environment into interpreter globals ``g``
    (non-destructively: real verbs and user definitions win)."""
    for name, val in CONSTANTS.items():
        g.setdefault(name, val)
    g.setdefault("AWG", _awg)
    tabs = abc_tables()
    for name in ("uAx0", "u2D0", "uAx1", "u2D1"):
        g.setdefault(name, _lua_table(tabs[name]))
    for prefix, mat_prefix, is_mag in (("mi_", "u", True),
                                       ("ei_", "e", False),
                                       ("hi_", "e", False)):
        drawline, drawarc, drawrectangle = _make_draw_helpers(prefix)
        g.setdefault(prefix + "drawline", drawline)
        g.setdefault(prefix + "drawarc", drawarc)
        g.setdefault(prefix + "drawrectangle", drawrectangle)
        g.setdefault(prefix + "makeABC", _make_abc(prefix, mat_prefix,
                                                   is_mag))
    g.setdefault("mi_setbhpointsfromfile", _setbhpointsfromfile)
