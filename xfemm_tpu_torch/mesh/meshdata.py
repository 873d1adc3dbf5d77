"""Mesh container and FEMM-compatible mesh file I/O.

``MeshData`` is the handoff object between the host-side mesher and the
device solver pipeline; the read/write helpers speak the reference's
.node/.ele/.edge/.pbc formats (triangle's file formats plus the periodic /
air-gap-element records of cfemm/fmesher/writepoly.cpp:1831-1983 and
cfemm/fsolver/fsolver.cpp:394-515) so meshes interchange with the
reference tooling.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class AirGapElement:
    """Air-gap element: an annular ring of 10-node quad elements coupling a
    rotor and stator boundary (cfemm/libfemm/CAirGapElement.h:43)."""

    name: str = ""
    BdryFormat: int = 0        # 0 periodic, 1 antiperiodic
    InnerAngle: float = 0.0
    OuterAngle: float = 0.0
    ri: float = 0.0
    ro: float = 0.0
    totalArcLength: float = 0.0   # angle spanned by the modeled slice [deg]
    agc: complex = 0.0            # annulus center
    totalArcElements: int = 0     # quad elements per modeled slice
    InnerShift: float = 0.0
    OuterShift: float = 0.0
    # (totalArcElements+1, 4) node ids and weights: columns are
    # (inner-left, inner-right, outer-left, outer-right)
    quad_nodes: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.int64))
    quad_weights: np.ndarray = field(default_factory=lambda: np.zeros((0, 4)))


@dataclass
class MeshData:
    """Unstructured first-order triangle mesh in problem units."""

    nodes: np.ndarray            # (N, 2) float64
    node_markers: np.ndarray     # (N,) int: pointprop idx+2 (+conductor<<16)
    elements: np.ndarray         # (T, 3) int, CCW
    element_labels: np.ndarray   # (T,) int: index into non-hole label list
    edges: np.ndarray            # (E, 2) int
    edge_markers: np.ndarray     # (E,) int: -(bdryprop idx+2) or 0
    pbc_pairs: np.ndarray        # (P, 3) int: (node_a, node_b, antiperiodic)
    airgaps: list[AirGapElement] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_elements(self) -> int:
        return len(self.elements)


def resolve_default_labels(problem, mesh: MeshData) -> None:
    """Map elements with no region label (attribute 0 in a reference
    .ele file -> label -1) to the problem's IsDefault block label, the
    way fsolver does on load (fsolver.cpp:541-562 ``elm.lbl--; if <0 ->
    defaultLabel``). Idempotent; mutates ``mesh.element_labels``."""
    unlabeled = mesh.element_labels < 0
    if not unlabeled.any():
        return
    k = 0
    default = -1
    for lab in problem.labellist:
        if lab.is_hole():
            continue
        if lab.IsDefault:
            default = k
        k += 1
    if default < 0:
        raise ValueError(
            "mesh contains regions with no block label and the problem "
            "defines no default label")
    mesh.element_labels[unlabeled] = default


def write_mesh_files(mesh: MeshData, pathbase: str) -> None:
    """Emit .node/.ele/.edge/.pbc next to ``pathbase`` (no extension)."""
    with open(pathbase + ".node", "w") as f:
        f.write(f"{mesh.num_nodes}\t2\t0\t1\n")
        for i, ((x, y), mk) in enumerate(zip(mesh.nodes, mesh.node_markers)):
            f.write(f"{i}\t{x:.17g}\t{y:.17g}\t{int(mk)}\n")
    with open(pathbase + ".ele", "w") as f:
        f.write(f"{mesh.num_elements}\t3\t1\n")
        for i, (tri, lbl) in enumerate(zip(mesh.elements, mesh.element_labels)):
            f.write(f"{i}\t{tri[0]}\t{tri[1]}\t{tri[2]}\t{lbl + 1}\n")
    with open(pathbase + ".edge", "w") as f:
        f.write(f"{len(mesh.edges)}\t1\n")
        for i, ((a, b), mk) in enumerate(zip(mesh.edges, mesh.edge_markers)):
            f.write(f"{i}\t{a}\t{b}\t{int(mk)}\n")
    with open(pathbase + ".pbc", "w") as f:
        f.write(f"{len(mesh.pbc_pairs)}\n")
        for i, (a, b, t) in enumerate(mesh.pbc_pairs):
            f.write(f"{i}\t{a}\t{b}\t{t}\n")
        f.write(f"{len(mesh.airgaps)}\n")
        for age in mesh.airgaps:
            f.write(f'"{age.name}"\n')
            f.write(f"{age.BdryFormat} {age.InnerAngle:.17g} "
                    f"{age.OuterAngle:.17g} {age.ri:.17g} {age.ro:.17g} "
                    f"{age.totalArcLength:.17g} {age.agc.real:.17g} "
                    f"{age.agc.imag:.17g} {age.totalArcElements} "
                    f"{age.InnerShift:.17g} {age.OuterShift:.17g}\n")
            for qn, qw in zip(age.quad_nodes, age.quad_weights):
                f.write(f"{qn[0]} {qw[0]:g} {qn[1]} {qw[1]:g} "
                        f"{qn[2]} {qw[2]:g} {qn[3]} {qw[3]:g}\n")


def save_npz(mesh: MeshData, path: str) -> None:
    """Binary snapshot of a mesh (fast: one compressed npz instead of
    four text files). Air-gap elements serialize as flat per-gap arrays."""
    payload = dict(nodes=mesh.nodes, node_markers=mesh.node_markers,
                   elements=mesh.elements,
                   element_labels=mesh.element_labels,
                   edges=mesh.edges, edge_markers=mesh.edge_markers,
                   pbc_pairs=mesh.pbc_pairs,
                   n_airgaps=np.int64(len(mesh.airgaps)))
    for k, age in enumerate(mesh.airgaps):
        payload[f"age{k}_name"] = np.frombuffer(
            age.name.encode(), np.uint8)
        payload[f"age{k}_scal"] = np.asarray(
            [age.BdryFormat, age.InnerAngle, age.OuterAngle, age.ri,
             age.ro, age.totalArcLength, age.agc.real, age.agc.imag,
             age.totalArcElements, age.InnerShift, age.OuterShift],
            np.float64)
        payload[f"age{k}_qn"] = age.quad_nodes
        payload[f"age{k}_qw"] = age.quad_weights
    np.savez(path, **payload)


def load_npz(path: str) -> MeshData:
    """Inverse of ``save_npz``."""
    z = np.load(path)
    airgaps = []
    for k in range(int(z["n_airgaps"])):
        s = z[f"age{k}_scal"]
        airgaps.append(AirGapElement(
            name=bytes(z[f"age{k}_name"]).decode(),
            BdryFormat=int(s[0]), InnerAngle=float(s[1]),
            OuterAngle=float(s[2]), ri=float(s[3]), ro=float(s[4]),
            totalArcLength=float(s[5]), agc=complex(s[6], s[7]),
            totalArcElements=int(s[8]), InnerShift=float(s[9]),
            OuterShift=float(s[10]),
            quad_nodes=z[f"age{k}_qn"], quad_weights=z[f"age{k}_qw"]))
    return MeshData(nodes=z["nodes"], node_markers=z["node_markers"],
                    elements=z["elements"],
                    element_labels=z["element_labels"],
                    edges=z["edges"], edge_markers=z["edge_markers"],
                    pbc_pairs=z["pbc_pairs"], airgaps=airgaps)


def read_mesh_files(pathbase: str) -> MeshData:
    """Load a mesh from triangle-format files (as written by either this
    package or the reference fmesher)."""
    with open(pathbase + ".node") as f:
        n = int(f.readline().split()[0])
        nodes = np.zeros((n, 2))
        markers = np.zeros(n, np.int64)
        for _ in range(n):
            parts = f.readline().split()
            i = int(parts[0])
            nodes[i] = [float(parts[1]), float(parts[2])]
            markers[i] = int(parts[3])
    with open(pathbase + ".ele") as f:
        header = f.readline().split()
        t = int(header[0])
        elements = np.zeros((t, 3), np.int64)
        labels = np.zeros(t, np.int64)
        for _ in range(t):
            parts = f.readline().split()
            i = int(parts[0])
            elements[i] = [int(parts[1]), int(parts[2]), int(parts[3])]
            labels[i] = (int(float(parts[4])) - 1) if len(parts) > 4 else -1
    edges = np.zeros((0, 2), np.int64)
    edge_markers = np.zeros(0, np.int64)
    try:
        with open(pathbase + ".edge") as f:
            e = int(f.readline().split()[0])
            edges = np.zeros((e, 2), np.int64)
            edge_markers = np.zeros(e, np.int64)
            for _ in range(e):
                parts = f.readline().split()
                i = int(parts[0])
                edges[i] = [int(parts[1]), int(parts[2])]
                edge_markers[i] = int(parts[3]) if len(parts) > 3 else 0
    except FileNotFoundError:
        pass

    pbc = np.zeros((0, 3), np.int64)
    airgaps: list[AirGapElement] = []
    try:
        with open(pathbase + ".pbc") as f:
            npbc = int(f.readline().split()[0])
            rows = []
            for _ in range(npbc):
                parts = f.readline().split()
                rows.append([int(parts[1]), int(parts[2]), int(parts[3])])
            pbc = np.array(rows, np.int64).reshape(-1, 3)
            nage_line = f.readline()
            nage = int(nage_line.split()[0]) if nage_line.strip() else 0
            for _ in range(nage):
                age = AirGapElement()
                age.name = f.readline().strip().strip('"')
                parts = f.readline().split()
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
                    parts = f.readline().split()
                    qn[k] = [int(parts[0]), int(parts[2]),
                             int(parts[4]), int(parts[6])]
                    qw[k] = [float(parts[1]), float(parts[3]),
                             float(parts[5]), float(parts[7])]
                age.quad_nodes = qn
                age.quad_weights = qw
                airgaps.append(age)
    except FileNotFoundError:
        pass

    return MeshData(nodes=nodes, node_markers=markers, elements=elements,
                    element_labels=labels, edges=edges,
                    edge_markers=edge_markers, pbc_pairs=pbc,
                    airgaps=airgaps)


class EdgeMultiplicity:
    """Vectorized (edge -> #adjacent-triangles) lookup. The solvers need
    the multiplicity of a handful of *boundary* edges (Robin / convection
    terms double where a boundary is shared by two elements); building a
    Python dict over every mesh edge is O(3T) interpreter work, so the
    keys are sorted once with numpy and queried by bisection."""

    def __init__(self, tris: np.ndarray):
        t = np.asarray(tris, np.int64)
        ek = np.sort(np.stack([
            np.concatenate([t[:, 0], t[:, 1], t[:, 2]]),
            np.concatenate([t[:, 1], t[:, 2], t[:, 0]])]), axis=0)
        self.keys, self.counts = np.unique(ek[0] << 32 | ek[1],
                                           return_counts=True)

    def get(self, ab, default: int = 1) -> int:
        a, b = sorted(int(v) for v in ab)
        k = a << 32 | b
        i = int(np.searchsorted(self.keys, k))
        if i < len(self.keys) and self.keys[i] == k:
            return int(self.counts[i])
        return default
