"""FEMM materials-library reader (matlib.dat / heatlib.dat / statlib.dat).

The reference ships tagged-block material libraries with its scripting
CLI (cfemm/femmcli/release/{matlib,heatlib,statlib,condlib}.dat) and
loads entries by name through MatlibReader
(cfemm/libfemm/MatlibReader.cpp). The format is the same <BeginBlock>
record used inside problem files, optionally nested in <BeginFolder>
groups, so this reuses the femfile block parser.
"""

from __future__ import annotations

from ..constants import FileType
from ..geometry.femfile import LineFeed, _parse_block_prop

_FILETYPE_BY_NAME = {
    "matlib": FileType.MAGNETICS,
    "heatlib": FileType.HEATFLOW,
    "statlib": FileType.ELECTROSTATICS,
}


def loads(text: str, filetype: FileType = FileType.MAGNETICS) -> dict:
    """Parse library text into {material name: material}."""
    import io
    out = {}
    lines = LineFeed(io.StringIO(text))
    while True:
        line = lines.next()
        if line is None:
            break
        tok = line.strip().lower()
        if tok.startswith("<beginblock>"):
            mat = _parse_block_prop(lines, filetype)
            out[mat.name] = mat
        # <BeginFolder>/<FolderName>/<EndFolder> lines are grouping only
    return out


def load(path: str, filetype: FileType | None = None) -> dict:
    if filetype is None:
        lower = path.lower()
        filetype = FileType.MAGNETICS
        for key, ft in _FILETYPE_BY_NAME.items():
            if key in lower:
                filetype = ft
                break
    with open(path, encoding="utf-8", errors="replace") as f:
        return loads(f.read(), filetype)


def load_raw(path: str) -> list[dict]:
    """Parse a tagged-block library into raw {tag: value} dicts without
    mapping to a material class (used for condlib.dat, whose
    current-flow problem type has no solver in xfemm)."""
    out = []
    cur = None
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            tok = line.strip()
            low = tok.lower()
            if low.startswith("<beginblock>"):
                cur = {}
            elif low.startswith("<endblock>"):
                out.append(cur)
                cur = None
            elif cur is not None and "=" in tok and tok.startswith("<"):
                tag, _, val = tok.partition("=")
                tag = tag.strip().strip("<>")
                val = val.strip().strip('"')
                try:
                    cur[tag] = float(val) if "." in val or "e" in val.lower() \
                        else int(val)
                except ValueError:
                    cur[tag] = val
    return out


# ------------------------------------------------------------------ #
# JSON data format + shipped libraries                               #
# ------------------------------------------------------------------ #
# The package ships the standard FEMM material-library values
# (cfemm/femmcli/release/{matlib,heatlib,statlib}.dat, the data the
# reference installs next to femmcli) as JSON under xfemm_tpu_torch/data/,
# a copy of the JAX package's data/ (which tools/make_libraries.py
# regenerates).

def material_to_dict(m) -> dict:
    from ..geometry.problem import ElectrostaticsMaterial, HeatMaterial
    from .magnetic import MagneticMaterial
    if isinstance(m, MagneticMaterial):
        d = dict(name=m.name, mu_x=m.mu_x, mu_y=m.mu_y, H_c=m.H_c,
                 J_re=m.J.real, J_im=m.J.imag, Cduct=m.Cduct,
                 Lam_d=m.Lam_d, Theta_hn=m.Theta_hn, Theta_hx=m.Theta_hx,
                 Theta_hy=m.Theta_hy, LamType=m.LamType, LamFill=m.LamFill,
                 NStrands=m.NStrands, WireD=m.WireD)
        if m.Bdata:
            d["Bdata"] = [float(b) for b in m.Bdata]
            d["Hdata"] = [h.real for h in m.Hdata]
        return d
    if isinstance(m, HeatMaterial):
        d = dict(name=m.name, Kx=m.Kx, Ky=m.Ky, Kt=m.Kt, qv=m.qv)
        if m.Tdata:
            d["Tdata"] = list(m.Tdata)
            d["Kdata"] = list(m.Kdata)
        return d
    if isinstance(m, ElectrostaticsMaterial):
        return dict(name=m.name, ex=m.ex, ey=m.ey, qv=m.qv)
    raise TypeError(f"unknown material type {type(m).__name__}")


def material_from_dict(d: dict, filetype: FileType):
    from ..geometry.problem import ElectrostaticsMaterial, HeatMaterial
    from .magnetic import MagneticMaterial
    if filetype == FileType.MAGNETICS:
        m = MagneticMaterial(
            name=d["name"], mu_x=d.get("mu_x", 1.0), mu_y=d.get("mu_y", 1.0),
            H_c=d.get("H_c", 0.0),
            J=complex(d.get("J_re", 0.0), d.get("J_im", 0.0)),
            Cduct=d.get("Cduct", 0.0), Lam_d=d.get("Lam_d", 0.0),
            Theta_hn=d.get("Theta_hn", 0.0), Theta_hx=d.get("Theta_hx", 0.0),
            Theta_hy=d.get("Theta_hy", 0.0), LamType=d.get("LamType", 0),
            LamFill=d.get("LamFill", 1.0), NStrands=d.get("NStrands", 0),
            WireD=d.get("WireD", 0.0))
        m.Bdata = [float(b) for b in d.get("Bdata", [])]
        m.Hdata = [complex(h, 0.0) for h in d.get("Hdata", [])]
        return m
    if filetype == FileType.HEATFLOW:
        m = HeatMaterial(name=d["name"], Kx=d.get("Kx", 1.0),
                         Ky=d.get("Ky", 1.0), Kt=d.get("Kt", 0.0),
                         qv=d.get("qv", 0.0))
        m.Tdata = list(d.get("Tdata", []))
        m.Kdata = list(d.get("Kdata", []))
        return m
    return ElectrostaticsMaterial(name=d["name"], ex=d.get("ex", 1.0),
                                  ey=d.get("ey", 1.0), qv=d.get("qv", 0.0))


_STEM_BY_FILETYPE = {
    FileType.MAGNETICS: "matlib",
    FileType.HEATFLOW: "heatlib",
    FileType.ELECTROSTATICS: "statlib",
}

_BUILTIN_CACHE: dict = {}


def builtin(filetype: FileType = FileType.MAGNETICS) -> dict:
    """The shipped standard library for a problem class, as
    {lowercase name: material}. Loaded once per process."""
    if filetype in _BUILTIN_CACHE:
        return _BUILTIN_CACHE[filetype]
    import json
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data",
        _STEM_BY_FILETYPE[filetype] + ".json")
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        for d in data["materials"]:
            out[d["name"].lower()] = material_from_dict(d, filetype)
    _BUILTIN_CACHE[filetype] = out
    return out


def get_builtin(name: str, filetype: FileType = FileType.MAGNETICS):
    """Copy of a shipped standard material by (case-insensitive) name,
    or None. Returns a fresh deep copy so callers can mutate it (the
    solvers cache fitted B-H slopes on the material object)."""
    import copy
    m = builtin(filetype).get(name.lower())
    return copy.deepcopy(m) if m is not None else None
