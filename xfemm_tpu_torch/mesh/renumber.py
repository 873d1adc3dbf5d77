"""Node renumbering (the reference's Cuthill-McKee stage).

The reference renumbers nodes with a BFS Cuthill-McKee pass before
assembly to shrink the linked-list matrix bandwidth
(cfemm/libfemm/cuthill.cpp:95). The matrix-free/ELLPACK operators do
not need bandwidth, but a reverse-Cuthill-McKee ordering is still what
makes the dense-band SpMV layout and cache-local gathers possible, so
the utility lives here.
"""

from __future__ import annotations

import numpy as np


def rcm_ordering(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Reverse-Cuthill-McKee permutation for a symmetric sparsity pattern
    given as COO row/col index arrays. Returns ``perm`` such that
    A[perm][:, perm] has minimized bandwidth."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    A = sp.coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                      shape=(n, n)).tocsr()
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))


def renumber_mesh(mesh, perm: np.ndarray):
    """Apply a node permutation to a MeshData in place (SortNodes
    semantics, fsolver.cpp SortNodes)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    mesh.nodes = mesh.nodes[perm]
    mesh.node_markers = mesh.node_markers[perm]
    mesh.elements = inv[mesh.elements]
    if len(mesh.edges):
        mesh.edges = inv[mesh.edges]
    if len(mesh.pbc_pairs):
        mesh.pbc_pairs[:, :2] = inv[mesh.pbc_pairs[:, :2]]
    for age in mesh.airgaps:
        age.quad_nodes = inv[age.quad_nodes]
    return mesh
