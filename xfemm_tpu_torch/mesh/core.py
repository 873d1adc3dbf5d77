"""ctypes binding for the native tpumesh triangulation kernel.

The C++ source (csrc/tpumesh.cpp) is compiled on demand into a shared
library cached in the package's ``_build/`` directory, keyed by a content
hash, so the package needs no ahead-of-time build step.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from dataclasses import dataclass

import numpy as np

_SRC = pathlib.Path(__file__).parent / "csrc" / "tpumesh.cpp"
#: build directory inside the package (listed in .gitignore)
_BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
_LOCK = threading.Lock()
_LIB = None

#: flag bits of tpumesh_triangulate
FLAG_NO_BOUNDARY_STEINER = 1   # "-Y"
FLAG_PRUNE_UNUSED = 2          # "-j"


def _build_library() -> pathlib.Path:
    src = _SRC.read_text()
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cache_dir = pathlib.Path(
        os.environ.get("XFEMM_TORCH_BUILD", _BUILD_DIR))
    cache_dir.mkdir(parents=True, exist_ok=True)
    out = cache_dir / f"libtpumesh-{tag}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           str(_SRC), "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def _get_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = _build_library()
        lib = ctypes.CDLL(str(path))
        lib.tpumesh_triangulate.restype = ctypes.c_int
        lib.tpumesh_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


@dataclass
class Triangulation:
    """Raw triangulation output (mirrors the .node/.ele/.edge trio)."""

    points: np.ndarray         # (N, 2) float64
    point_markers: np.ndarray  # (N,) int32
    triangles: np.ndarray      # (T, 3) int32, CCW
    tri_attrs: np.ndarray      # (T,) int32 regional attribute (1-based)
    edges: np.ndarray          # (E, 2) int32
    edge_markers: np.ndarray   # (E,) int32 (segment marker or 0)
    vertex_map: np.ndarray     # input vertex index -> output index (or -1)


class TriangulationError(RuntimeError):
    pass


def triangulate(points: np.ndarray,
                segments: np.ndarray,
                point_markers: np.ndarray | None = None,
                segment_markers: np.ndarray | None = None,
                holes: np.ndarray | None = None,
                regions: np.ndarray | None = None,
                min_angle: float = 0.0,
                no_boundary_steiner: bool = False,
                prune_unused: bool = False) -> Triangulation:
    """Constrained Delaunay triangulation with quality refinement.

    Equivalent surface to the reference's ``triangulate()`` call with
    options ``-pq<angle>eAza`` (+ optional ``-Y``/``-j``), see
    cfemm/fmesher/writepoly.cpp:2324 ``triangulateParams``.

    Parameters mirror triangle's PSLG input: ``regions`` rows are
    ``(x, y, attribute, max_area)``.
    """
    lib = _get_lib()

    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = len(pts)
    segs = np.ascontiguousarray(segments, dtype=np.int32)
    pm = (np.ascontiguousarray(point_markers, dtype=np.int32)
          if point_markers is not None else np.zeros(n, np.int32))
    sm = (np.ascontiguousarray(segment_markers, dtype=np.int32)
          if segment_markers is not None
          else np.zeros(len(segs), np.int32))
    hl = (np.ascontiguousarray(holes, dtype=np.float64)
          if holes is not None and len(holes) else np.zeros((0, 2)))
    rg = (np.ascontiguousarray(regions, dtype=np.float64)
          if regions is not None and len(regions) else np.zeros((0, 4)))

    flags = (FLAG_NO_BOUNDARY_STEINER if no_boundary_steiner else 0) | \
            (FLAG_PRUNE_UNUSED if prune_unused else 0)

    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_dbl_p = ctypes.POINTER(ctypes.c_double)
    out_np = ctypes.c_int()
    out_pts = c_dbl_p()
    out_pm = c_int_p()
    out_nt = ctypes.c_int()
    out_tris = c_int_p()
    out_attrs = c_int_p()
    out_ne = ctypes.c_int()
    out_edges = c_int_p()
    out_em = c_int_p()
    out_vmap = c_int_p()

    status = lib.tpumesh_triangulate(
        ctypes.c_int(n), pts.ctypes.data_as(c_dbl_p),
        pm.ctypes.data_as(c_int_p),
        ctypes.c_int(len(segs)), segs.ctypes.data_as(c_int_p),
        sm.ctypes.data_as(c_int_p),
        ctypes.c_int(len(hl)), hl.ctypes.data_as(c_dbl_p),
        ctypes.c_int(len(rg)), rg.ctypes.data_as(c_dbl_p),
        ctypes.c_double(min_angle), ctypes.c_int(flags),
        ctypes.byref(out_np), ctypes.byref(out_pts), ctypes.byref(out_pm),
        ctypes.byref(out_nt), ctypes.byref(out_tris), ctypes.byref(out_attrs),
        ctypes.byref(out_ne), ctypes.byref(out_edges), ctypes.byref(out_em),
        ctypes.byref(out_vmap))
    if status != 0:
        raise TriangulationError(
            f"tpumesh_triangulate failed with status {status} "
            f"(1=bad input, 2=location failure, 3=constraint recovery "
            f"failure, 4=classification failure)")

    def take(ptr, shape, dtype):
        arr = np.ctypeslib.as_array(ptr, shape=shape).astype(dtype).copy()
        lib.tpumesh_free(ptr)
        return arr

    N, T, E = out_np.value, out_nt.value, out_ne.value
    result = Triangulation(
        points=take(out_pts, (N, 2), np.float64),
        point_markers=take(out_pm, (N,), np.int32),
        triangles=take(out_tris, (T, 3), np.int32),
        tri_attrs=take(out_attrs, (T,), np.int32),
        edges=take(out_edges, (E, 2), np.int32),
        edge_markers=take(out_em, (E,), np.int32),
        vertex_map=take(out_vmap, (n,), np.int32),
    )
    return result
