"""Checks of a mesh against the geometry it was made from: each
labelled region's area against the geometry's (``region_gap``, the
largest relative difference), the largest element against the
labels' MaxArea (``area_ratio``), and the block labels each lying in
an element of their own region, with every element counter-clockwise
(``label_misses``: labels outside their region plus inverted
elements)."""

from __future__ import annotations

import numpy as np

from .reference import fem


def _containing(xy, tris, x: float, y: float) -> np.ndarray:
    """Indices of the elements that contain the point (x, y)."""
    v = xy[tris]
    d = []
    for j in range(3):
        a, b = v[:, j], v[:, (j + 1) % 3]
        d.append((b[:, 0] - a[:, 0]) * (y - a[:, 1])
                 - (b[:, 1] - a[:, 1]) * (x - a[:, 0]))
    d = np.stack(d, 1)
    return np.nonzero((d >= 0).all(axis=1))[0]


def check(problem_module, params: dict, mesh) -> dict:
    xy = np.asarray(mesh.nodes, np.float64)
    tris = np.asarray(mesh.elements)
    lbl = np.asarray(mesh.element_labels)
    _b, _c, area = fem.gradients(xy, tris)
    want = problem_module.region_areas(params)
    gap = 0.0
    for k, a in enumerate(want):
        gap = max(gap, abs(float(area[lbl == k].sum()) - a) / a)
    misses = int((area <= 0).sum())
    for k, (x, y) in enumerate(problem_module.label_points(params)):
        inside = _containing(xy, tris, x, y)
        if len(inside) == 0 or (lbl[inside] != k).any():
            misses += 1
    ratio = float(area.max()) / problem_module.max_area(params)
    return {"region_gap": gap, "area_ratio": ratio,
            "label_misses": float(misses)}
