"""Solution file (.ans/.anh/.res) reader/writer (numpy only).

The reference's solution files echo the entire input problem file and
append a ``[Solution]`` block (cfemm/fsolver/static2d.cpp:1038-1194
``WriteStatic2D``), making each solution self-contained and restartable.
This module reproduces that format for magnetostatics (the heat-flow and
electrostatics variants differ only in the per-node record). It is the
port's own copy of the JAX package's ``io/ansfile.py``, on the port's
``constants``, ``geometry`` and ``mesh.meshdata``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import FileType
from ..geometry import femfile
from ..geometry.problem import Problem
from ..mesh.meshdata import AirGapElement, MeshData


@dataclass
class SolutionFile:
    problem: Problem
    mesh: MeshData          # node coords in problem units; markers are
                            # point-prop indices (or -1)
    values: np.ndarray      # (N,) nodal A (magnetics, possibly complex),
                            # T (heat), V (electrostatics)
    values_prev: np.ndarray | None = None
    label_case: np.ndarray | None = None   # (L, 2) (case, value) magnetics
    conductor_results: list = field(default_factory=list)


def _fmt(x: float) -> str:
    return f"{x:.17g}"


def _read_scalar_solution(problem: Problem, lines) -> SolutionFile:
    """[Solution] block of .anh/.res: nodes 'x y V Q', elements 4-col,
    then conductor results 'V q' (hsolver.cpp:954-977 WriteResults)."""
    n = int(next(lines).split()[0])
    nodes = np.zeros((n, 2))
    values = np.zeros(n)
    conductor = np.zeros(n, np.int64)
    for i in range(n):
        parts = next(lines).split()
        nodes[i] = [float(parts[0]), float(parts[1])]
        values[i] = float(parts[2])
        conductor[i] = int(parts[3])
    t = int(next(lines).split()[0])
    elements = np.zeros((t, 3), np.int64)
    labels = np.zeros(t, np.int64)
    for i in range(t):
        parts = next(lines).split()
        elements[i] = [int(parts[0]), int(parts[1]), int(parts[2])]
        labels[i] = int(parts[3])
    conductor_results = []
    try:
        ncirc = int(next(lines).split()[0])
        for _ in range(ncirc):
            parts = next(lines).split()
            conductor_results.append((float(parts[0]), float(parts[1])))
    except StopIteration:
        pass
    # store the conductor index in node markers using the raw mesh-file
    # convention high bits so nothing collides with point props
    markers = np.where(conductor >= 0, (conductor + 1) << 16, 0)
    mesh = MeshData(nodes=nodes, node_markers=markers, elements=elements,
                    element_labels=labels,
                    edges=np.zeros((0, 2), np.int64),
                    edge_markers=np.zeros(0, np.int64),
                    pbc_pairs=np.zeros((0, 3), np.int64))
    return SolutionFile(problem=problem, mesh=mesh, values=values,
                        conductor_results=conductor_results)


def write_ans(sol: SolutionFile, path: str, problem_text: str | None = None):
    """Write a magnetics .ans: problem echo + [Solution] block. Complex
    nodal values (harmonic problems) write as re/im column pairs
    (harmonic2d.cpp:926-938 WriteHarmonic2D)."""
    p = sol.problem
    mesh = sol.mesh
    harmonic = p.Frequency != 0
    if problem_text is None:
        problem_text = femfile.dumps(p)
    out = [problem_text.rstrip("\n")]
    w = out.append
    w("[Solution]")
    n = mesh.num_nodes
    w(str(n))
    has_prev = sol.values_prev is not None
    for i in range(n):
        x, y = mesh.nodes[i]
        if harmonic:
            v = complex(sol.values[i])
            row = (f"{_fmt(x)}\t{_fmt(y)}\t{_fmt(v.real)}\t{_fmt(v.imag)}"
                   f"\t{int(mesh.node_markers[i])}")
        else:
            row = (f"{_fmt(x)}\t{_fmt(y)}\t{_fmt(float(sol.values[i]))}\t"
                   f"{int(mesh.node_markers[i])}")
        if has_prev:
            row += f"\t{_fmt(float(sol.values_prev[i]))}"
        w(row)
    w(str(mesh.num_elements))
    for tri, lbl in zip(mesh.elements, mesh.element_labels):
        w(f"{tri[0]}\t{tri[1]}\t{tri[2]}\t{lbl}")
    nlabels = len(sol.label_case) if sol.label_case is not None else 0
    w(str(nlabels))
    if sol.label_case is not None:
        for case, value in sol.label_case:
            if harmonic:
                v = complex(value)
                w(f"{int(case.real if isinstance(case, complex) else case)}"
                  f"\t{_fmt(v.real)}\t{_fmt(v.imag)}")
            else:
                w(f"{int(case)}\t{_fmt(value)}")
    w(str(len(mesh.pbc_pairs)))
    for a, b, t in mesh.pbc_pairs:
        w(f"{a}\t{b}\t{t}")
    w(str(len(mesh.airgaps)))
    for age in mesh.airgaps:
        w(age.name)
        w(f"{age.BdryFormat} {_fmt(age.InnerAngle)} {_fmt(age.OuterAngle)} "
          f"{_fmt(age.ri)} {_fmt(age.ro)} {_fmt(age.totalArcLength)} "
          f"{_fmt(age.agc.real)} {_fmt(age.agc.imag)} "
          f"{age.totalArcElements} {_fmt(age.InnerShift)} "
          f"{_fmt(age.OuterShift)}")
        for qn, qw in zip(age.quad_nodes, age.quad_weights):
            w(f"{qn[0]} {_fmt(qw[0])} {qn[1]} {_fmt(qw[1])} "
              f"{qn[2]} {_fmt(qw[2])} {qn[3]} {_fmt(qw[3])}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")


def read_ans(path: str) -> SolutionFile:
    """Parse a solution file: .ans (magnetics), .anh (heat flow) or .res
    (electrostatics), own output or the reference's."""
    lower = path.lower()
    # exact extension first; fall back to suffixed copies (.anh.golden).
    # Substring matching alone misfires on names like foo.result.ans.
    if lower.endswith(".anh"):
        ftype = FileType.HEATFLOW
    elif lower.endswith(".res"):
        ftype = FileType.ELECTROSTATICS
    elif lower.endswith(".ans"):
        ftype = FileType.MAGNETICS
    elif ".anh." in lower:
        ftype = FileType.HEATFLOW
    elif ".res." in lower:
        ftype = FileType.ELECTROSTATICS
    else:
        ftype = FileType.MAGNETICS
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    head, _, tail = text.partition("[Solution]")
    problem = femfile.loads(head, ftype)
    lines = iter(tail.strip().splitlines())
    if ftype != FileType.MAGNETICS:
        return _read_scalar_solution(problem, lines)

    is_harmonic = problem.Frequency != 0
    n = int(next(lines).split()[0])
    nodes = np.zeros((n, 2))
    markers = np.zeros(n, np.int64)  # converted to raw (idx+2) convention
    has_prev = problem.PrevSoln != ""
    values = np.zeros(n, complex if is_harmonic else float)
    values_prev = np.zeros(n) if has_prev else None
    for i in range(n):
        parts = next(lines).split()
        nodes[i] = [float(parts[0]), float(parts[1])]
        if is_harmonic:
            # harmonic: x y Are Aim marker (WriteHarmonic2D)
            values[i] = complex(float(parts[2]), float(parts[3]))
            markers[i] = int(parts[4])
            if has_prev and len(parts) > 5:
                values_prev[i] = float(parts[5])
        else:
            values[i] = float(parts[2])
            markers[i] = int(parts[3])
            if has_prev and len(parts) > 4:
                values_prev[i] = float(parts[4])

    # .ans node markers are point-prop indices (or -1); MeshData uses the
    # raw mesh-file convention (idx+2, 0 = none) everywhere else
    markers = np.where(markers >= 0, markers + 2, 0)

    t = int(next(lines).split()[0])
    elements = np.zeros((t, 3), np.int64)
    labels = np.zeros(t, np.int64)
    for i in range(t):
        parts = next(lines).split()
        elements[i] = [int(parts[0]), int(parts[1]), int(parts[2])]
        labels[i] = int(parts[3])

    nlab = int(next(lines).split()[0])
    label_case = np.zeros((nlab, 2), complex if is_harmonic else float)
    for i in range(nlab):
        parts = next(lines).split()
        if is_harmonic and len(parts) > 2:
            # harmonic: case, Re(value), Im(value) (WriteHarmonic2D)
            label_case[i] = [int(parts[0]),
                             complex(float(parts[1]), float(parts[2]))]
        else:
            label_case[i] = [int(parts[0]), float(parts[1])]

    pbc = np.zeros((0, 3), np.int64)
    airgaps = []
    try:
        npbc = int(next(lines).split()[0])
        rows = []
        for _ in range(npbc):
            parts = next(lines).split()
            rows.append([int(parts[0]), int(parts[1]), int(parts[2])])
        pbc = np.array(rows, np.int64).reshape(-1, 3)
        nage = int(next(lines).split()[0])
        for _ in range(nage):
            age = AirGapElement()
            age.name = next(lines).strip().strip('"')
            parts = next(lines).split()
            age.BdryFormat = int(parts[0])
            age.InnerAngle = float(parts[1])
            age.OuterAngle = float(parts[2])
            age.ri = float(parts[3])
            age.ro = float(parts[4])
            age.totalArcLength = float(parts[5])
            age.agc = complex(float(parts[6]), float(parts[7]))
            age.totalArcElements = int(parts[8])
            age.InnerShift = float(parts[9])
            age.OuterShift = float(parts[10])
            qn = np.zeros((age.totalArcElements + 1, 4), np.int64)
            qw = np.zeros((age.totalArcElements + 1, 4))
            for k in range(age.totalArcElements + 1):
                parts = next(lines).split()
                qn[k] = [int(parts[0]), int(parts[2]), int(parts[4]),
                         int(parts[6])]
                qw[k] = [float(parts[1]), float(parts[3]), float(parts[5]),
                         float(parts[7])]
            age.quad_nodes = qn
            age.quad_weights = qw
            airgaps.append(age)
    except (StopIteration, ValueError):
        pass

    mesh = MeshData(nodes=nodes, node_markers=markers, elements=elements,
                    element_labels=labels,
                    edges=np.zeros((0, 2), np.int64),
                    edge_markers=np.zeros(0, np.int64),
                    pbc_pairs=pbc, airgaps=airgaps)
    return SolutionFile(problem=problem, mesh=mesh, values=values,
                        values_prev=values_prev, label_case=label_case)


def solution_mesh_from_solver(mesh: MeshData, units: float) -> MeshData:
    """Convert a solver mesh (problem units, raw file markers) into the
    .ans convention: same coords, node markers remapped to point-prop
    indices (fsolver.cpp:382-384: marker>1 -> marker-2, else -1)."""
    mk = mesh.node_markers & 0xFFFF
    remapped = np.where(mk > 1, mk - 2, -1)
    out = MeshData(nodes=mesh.nodes, node_markers=remapped,
                   elements=mesh.elements,
                   element_labels=mesh.element_labels, edges=mesh.edges,
                   edge_markers=mesh.edge_markers, pbc_pairs=mesh.pbc_pairs,
                   airgaps=mesh.airgaps)
    return out


def write_scalar_solution(problem: Problem, mesh: MeshData, values,
                          node_Q, conductor_results, path: str,
                          problem_text: str | None = None) -> None:
    """Write a heat-flow .anh / electrostatics .res: problem echo +
    [Solution] with nodes 'x y V Q', 4-col elements and per-conductor
    '(V, q)' results (hsolver.cpp:954-982 WriteResults)."""
    if problem_text is None:
        problem_text = femfile.dumps(problem)
    out = [problem_text.rstrip("\n")]
    w = out.append
    w("[Solution]")
    w(str(mesh.num_nodes))
    for i in range(mesh.num_nodes):
        x, y = mesh.nodes[i]
        w(f"{_fmt(x)}\t{_fmt(y)}\t{_fmt(float(values[i]))}\t"
          f"{int(node_Q[i])}")
    w(str(mesh.num_elements))
    for tri, lbl in zip(mesh.elements, mesh.element_labels):
        w(f"{tri[0]}\t{tri[1]}\t{tri[2]}\t{lbl}")
    w(str(len(conductor_results)))
    for cv, cq in conductor_results:
        w(f"{_fmt(cv)}\t{_fmt(cq)}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")
