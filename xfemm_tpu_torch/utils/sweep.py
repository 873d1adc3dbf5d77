"""Checkpointed parameter sweeps with warm-started Newton chains.

The reference's rotor-sweep workflow is a Lua loop that re-runs
mesh+solve from scratch at every angle (femmcli_TorqueBenchmark.lua) and
has no notion of resuming an interrupted sweep; its only state-chaining
machinery is the ``[prevsoln]`` incremental/frozen-permeability reload
(fsolver.cpp:202-239).  This module provides the equivalents:

* **checkpoint/resume**: each completed sweep point persists its
  extracted result plus the full solution state ``(A, value)`` to a
  ``.npz`` under the checkpoint directory, with a JSON manifest.  A
  killed sweep re-run with the same checkpoint directory skips the
  completed points and reproduces their results exactly from disk.
* **warm start**: consecutive points start the Newton loop from the
  previous point's nodal ``A`` (interpolated when the mesh changed),
  which measurably cuts per-point Newton iterations.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np


def _interp_to(nodes_old: np.ndarray, A_old: np.ndarray,
               nodes_new: np.ndarray) -> np.ndarray:
    """Initial-guess interpolation of a nodal field onto a new mesh
    (Delaunay linear, nearest fallback): rotor sweeps re-mesh per angle,
    so node layouts differ even though most of the domain is unchanged."""
    if (nodes_old.shape == nodes_new.shape
            and np.array_equal(nodes_old, nodes_new)):
        return A_old
    from scipy.interpolate import LinearNDInterpolator, \
        NearestNDInterpolator
    lin = LinearNDInterpolator(nodes_old, A_old)
    out = lin(nodes_new)
    bad = ~np.isfinite(out)
    if bad.any():
        near = NearestNDInterpolator(nodes_old, A_old)
        out[bad] = near(nodes_new[bad])
    return out


class SweepCheckpoint:
    """Directory-backed sweep state: ``manifest.json`` + one ``.npz``
    per completed point (keyed by a stable string tag)."""

    def __init__(self, directory: str | os.PathLike):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.dir / "manifest.json"
        if self.manifest_path.exists():
            self.manifest = json.loads(self.manifest_path.read_text())
        else:
            self.manifest = {"done": []}

    def has(self, tag: str) -> bool:
        return tag in self.manifest["done"] and \
            (self.dir / f"{tag}.npz").exists()

    def load(self, tag: str):
        d = np.load(self.dir / f"{tag}.npz", allow_pickle=False)
        return d["value"], d["A"], d["nodes"]

    def store(self, tag: str, value, A: np.ndarray, nodes: np.ndarray):
        tmp = self.dir / f"{tag}.tmp.npz"   # np.savez appends .npz itself
        np.savez_compressed(tmp, value=np.asarray(value),
                            A=np.asarray(A), nodes=np.asarray(nodes))
        os.replace(tmp, self.dir / f"{tag}.npz")
        if tag not in self.manifest["done"]:
            self.manifest["done"].append(tag)
        tmp2 = self.dir / "manifest.json.tmp"
        tmp2.write_text(json.dumps(self.manifest))
        os.replace(tmp2, self.manifest_path)


def sweep(points, build, extract, checkpoint: str | None = None,
          warm_start: bool = True, solve_kwargs: dict | None = None):
    """Run ``build(point) -> (problem, mesh)`` + solve + ``extract``
    over ``points``, with checkpoint/resume and warm-started chains.

    Returns ``{point: extracted_value}``.  ``extract(solution)`` must
    return something ``np.asarray``-able for the checkpoint.
    ``solve_kwargs`` go to ``magnetostatics.solve``: ``device`` (CUDA
    when omitted) and ``hbm_bytes`` (needed with ``device="cpu"``).
    """
    from ..models import magnetostatics

    ck = SweepCheckpoint(checkpoint) if checkpoint else None
    out = {}
    prev = None          # (nodes, A) of the previous completed point
    for pt in points:
        tag = str(pt)
        if ck is not None and ck.has(tag):
            value, A, nodes = ck.load(tag)
            out[pt] = value
            prev = (nodes, A)
            continue
        problem, mesh = build(pt)
        x0 = None
        if warm_start and prev is not None:
            x0 = _interp_to(prev[0], prev[1], np.asarray(mesh.nodes))
        sol = magnetostatics.solve(problem, mesh, x0_A=x0,
                                   **(solve_kwargs or {}))
        value = extract(sol)
        out[pt] = value
        prev = (np.asarray(mesh.nodes), np.asarray(sol.A))
        if ck is not None:
            ck.store(tag, value, sol.A, mesh.nodes)
    return out
