"""Evaluation of FEMM's per-element Lua magnetization-direction functions.

The reference embeds Lua 4.0 and evaluates ``MagDirFctn`` strings per
element with the variables ``x, y, r, z, theta, R`` bound to the element
centroid (cfemm/fsolver/static2d.cpp:513-598). These expressions are simple
arithmetic (e.g. ``"theta+90"`` or ``"2*atan2(y,x)*180/PI"``), so instead
of embedding a Lua interpreter on the host we translate the Lua surface
syntax (``^`` power, Lua math library names) and evaluate with a restricted
Python expression evaluator.
"""

from __future__ import annotations

import math

_SAFE_NAMES = {
    "abs": abs, "acos": math.acos, "asin": math.asin, "atan": math.atan,
    "atan2": math.atan2, "ceil": math.ceil, "cos": math.cos,
    "cosh": math.cosh, "deg": math.degrees, "exp": math.exp,
    "floor": math.floor, "log": math.log, "log10": math.log10,
    "max": max, "min": min, "mod": math.fmod, "rad": math.radians,
    "sin": math.sin, "sinh": math.sinh, "sqrt": math.sqrt, "tan": math.tan,
    "tanh": math.tanh, "PI": math.pi, "Pi": math.pi, "pi": math.pi,
}


class MagDirError(ValueError):
    pass


def eval_magdir(expr: str, x: float, y: float) -> float:
    """Evaluate a magnetization-direction expression at centroid (x, y)
    in problem units; returns degrees. The bound variables match the
    reference's preamble: x, y, r=x, z=y, theta=atan2(y,x) in degrees,
    R=sqrt(x^2+y^2) (static2d.cpp:530)."""
    theta = math.degrees(math.atan2(y, x))
    R = math.hypot(x, y)
    names = dict(_SAFE_NAMES)
    names.update({"x": x, "y": y, "r": x, "z": y, "theta": theta, "R": R})
    py = expr.replace("^", "**")
    try:
        return float(eval(py, {"__builtins__": {}}, names))  # noqa: S307
    except Exception as exc:  # pragma: no cover - error path
        raise MagDirError(
            f"magnetization direction expression {expr!r} failed: {exc}"
        ) from exc
