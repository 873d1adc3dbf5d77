"""Problem / mesh / solution plotting (mfemm's visualisation layer).

Equivalents of mfemm/visualisation/plotfemmproblem.m, plotmesh_mfemm.m
and the density plots of the FEMM postprocessor windows, on matplotlib.
All functions accept an ``ax`` or create one; importing matplotlib is
deferred so headless solver runs never pay for it.
"""

from __future__ import annotations

import numpy as np

from ..geometry.problem import Problem
from ..mesh.meshdata import MeshData


def _ax(ax):
    if ax is not None:
        return ax
    import matplotlib.pyplot as plt
    _, ax = plt.subplots(figsize=(7, 7))
    ax.set_aspect("equal")
    return ax


def plot_problem(problem: Problem, ax=None, labels: bool = True):
    """Geometry outline: segments, arcs, block labels
    (plotfemmproblem.m)."""
    import matplotlib.pyplot as plt  # noqa: F401
    ax = _ax(ax)
    for seg in problem.linelist:
        p0 = problem.nodelist[seg.n0]
        p1 = problem.nodelist[seg.n1]
        ax.plot([p0.x, p1.x], [p0.y, p1.y], "b-", lw=1)
    for arc in problem.arclist:
        c, r = problem.get_circle(arc)
        a0 = problem.nodelist[arc.n0].cc()
        th0 = np.angle(a0 - c)
        th = th0 + np.linspace(0, np.radians(arc.ArcLength), 64)
        ax.plot(c.real + r * np.cos(th), c.imag + r * np.sin(th), "b-",
                lw=1)
    xs = [n.x for n in problem.nodelist]
    ys = [n.y for n in problem.nodelist]
    ax.plot(xs, ys, "r.", ms=3)
    if labels:
        for lab in problem.labellist:
            if lab.is_hole():
                ax.plot([lab.x], [lab.y], "kx", ms=6)
            else:
                name = (problem.blockproplist[lab.BlockType].name
                        if 0 <= lab.BlockType < len(problem.blockproplist)
                        else "?")
                ax.annotate(name, (lab.x, lab.y), fontsize=7, color="g")
    ax.set_aspect("equal")
    return ax


def plot_mesh(mesh: MeshData, ax=None, color="0.6", lw=0.3):
    """Triangulation wireframe (plotmesh_mfemm.m)."""
    import matplotlib.tri as mtri
    ax = _ax(ax)
    tri = mtri.Triangulation(mesh.nodes[:, 0], mesh.nodes[:, 1],
                             mesh.elements)
    ax.triplot(tri, color=color, lw=lw)
    ax.set_aspect("equal")
    return ax


def plot_density(mesh: MeshData, values, ax=None, kind="nodal",
                 cmap="viridis", levels=32, colorbar=True, label=""):
    """Filled density plot of a nodal or per-element scalar (|B|, T, V,
    ...) like the FEMM density view."""
    import matplotlib.pyplot as plt
    import matplotlib.tri as mtri
    ax = _ax(ax)
    tri = mtri.Triangulation(mesh.nodes[:, 0], mesh.nodes[:, 1],
                             mesh.elements)
    vals = np.asarray(values, float)
    if kind == "nodal":
        m = ax.tricontourf(tri, vals, levels=levels, cmap=cmap)
    else:
        m = ax.tripcolor(tri, facecolors=vals, cmap=cmap)
    if colorbar:
        plt.colorbar(m, ax=ax, label=label)
    ax.set_aspect("equal")
    return ax


def plot_flux_lines(mesh: MeshData, A, ax=None, levels=19, color="k"):
    """Flux lines = contours of the vector potential A (the FEMM
    postprocessor's default view)."""
    import matplotlib.tri as mtri
    ax = _ax(ax)
    tri = mtri.Triangulation(mesh.nodes[:, 0], mesh.nodes[:, 1],
                             mesh.elements)
    ax.tricontour(tri, np.real(np.asarray(A)), levels=levels,
                  colors=color, linewidths=0.6)
    ax.set_aspect("equal")
    return ax


def plot_B(post, ax=None, kind="magnitude", cmap="inferno", levels=32,
           colorbar=True, quiver_step: int = 0):
    """Flux-density view from a solved magnetics postprocessor
    (mfemm/visualisation/B_from_vector_potential.m + the 'PlotFields'
    overlay of plotfemmproblem.m): filled |B| density from the smoothed
    per-corner reconstruction, optionally with a B-direction quiver
    every ``quiver_step`` elements.

    ``post`` is a ``post.fpproc.MagPostProcessor`` (api.Solution.post).
    """
    import matplotlib.pyplot as plt
    import matplotlib.tri as mtri
    ax = _ax(ax)
    mesh = post.mesh
    nb1, nb2 = post.nodal_B()
    # per-element |B| from the corner average
    b1 = np.real(np.asarray(nb1)).mean(axis=1)
    b2 = np.real(np.asarray(nb2)).mean(axis=1)
    mag = np.hypot(b1, b2)
    tri = mtri.Triangulation(mesh.nodes[:, 0], mesh.nodes[:, 1],
                             mesh.elements)
    if kind == "magnitude":
        m = ax.tripcolor(tri, facecolors=mag, cmap=cmap)
        if colorbar:
            plt.colorbar(m, ax=ax, label="|B| [T]")
    if quiver_step:
        cx = mesh.nodes[mesh.elements, 0].mean(axis=1)
        cy = mesh.nodes[mesh.elements, 1].mean(axis=1)
        s = slice(None, None, int(quiver_step))
        ax.quiver(cx[s], cy[s], b1[s], b2[s], angles="xy", width=2e-3,
                  color="w" if kind == "magnitude" else "k")
    ax.set_aspect("equal")
    return ax


def plot_solution(problem: Problem, mesh: MeshData, sol, ax=None,
                  flux_levels: int = 19):
    """One-call solution view (the FEMM postprocessor's default window):
    |B| density + flux lines for magnetics, T / V density for heat and
    electrostatics."""
    from ..constants import FileType
    ax = _ax(ax)
    ft = problem.filetype
    if ft == FileType.MAGNETICS:
        from ..post.fpproc import MagPostProcessor
        post = MagPostProcessor(problem, mesh, sol.A,
                                getattr(sol, "label_case", None))
        plot_B(post, ax=ax)
        plot_flux_lines(mesh, sol.A, ax=ax, levels=flux_levels,
                        color="w")
    elif ft == FileType.HEATFLOW:
        plot_density(mesh, sol.T, ax=ax, label="T [K]")
    else:
        plot_density(mesh, sol.V, ax=ax, label="V [V]")
    return ax
