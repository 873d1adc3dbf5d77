"""First-order triangle pieces shared by the plain references: element
gradients, the (anti)periodic node folding, sparse scatter, and the
sparse direct solve. NumPy and SciPy only."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as sla


def gradients(xy, tris, dtype=np.float64):
    """(b, c, area): the shape-function gradients of every element are
    (b_j, c_j) / (2 area), with b_j = y_{j+1} - y_{j+2} and
    c_j = x_{j+2} - x_{j+1}; ``area`` is the signed area (> 0 for
    counter-clockwise elements)."""
    v = np.asarray(xy, np.float64)[np.asarray(tris)]
    x, y = v[:, :, 0], v[:, :, 1]
    b = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], 1)
    c = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], 1)
    area = (b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0]) / 2.0
    return b.astype(dtype), c.astype(dtype), area.astype(dtype)


def stiffness(b, c, area):
    """(T, 3, 3) Laplacian element matrices (b b^T + c c^T) / (4 area)."""
    return ((b[:, :, None] * b[:, None, :] + c[:, :, None] * c[:, None, :])
            / (4.0 * area)[:, None, None])


def fold(n: int, pairs):
    """Node -> (DOF, sign) under (anti)periodic pairs ``(a, b, anti)``,
    where value[a] = (-1 if anti else 1) * value[b]. Returns (dof, sign,
    number of DOFs)."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 3)
    if len(pairs) == 0:
        return np.arange(n), np.ones(n), n
    parent = np.arange(n)
    sign = np.ones(n)

    def root(i):
        s = 1.0
        while parent[i] != i:
            s *= sign[i]
            i = parent[i]
        return i, s

    for a, b, anti in pairs:
        ra, sa = root(int(a))
        rb, sb = root(int(b))
        if ra == rb:
            continue
        # value[a] = sa v[ra], value[b] = sb v[rb], value[a] = rel value[b]
        rel = -1.0 if anti else 1.0
        parent[rb] = ra
        sign[rb] = sa * rel * sb
    roots = np.empty(n, np.int64)
    sgn = np.empty(n)
    for i in range(n):
        roots[i], sgn[i] = root(i)
    uniq, dof = np.unique(roots, return_inverse=True)
    return dof, sgn, len(uniq)


def scatter_matrix(tris, mats, dof, sgn, m: int, dtype=np.float64):
    """Sum of element matrices ``mats`` (T, k, k) over nodes ``tris``
    (T, k), folded onto ``m`` DOFs, as CSR."""
    tris = np.asarray(tris)
    k = tris.shape[1]
    d = dof[tris]
    s = sgn[tris]
    vals = (mats * s[:, :, None] * s[:, None, :]).astype(dtype)
    rows = np.repeat(d, k, axis=1).ravel()
    cols = np.tile(d, (1, k)).ravel()
    return sp.csr_matrix((vals.ravel(), (rows, cols)), shape=(m, m))


def scatter_vector(tris, vecs, dof, sgn, m: int, dtype=np.float64):
    """Sum of element vectors ``vecs`` (T, k) folded onto ``m`` DOFs."""
    out = np.zeros(m, dtype)
    np.add.at(out, dof[np.asarray(tris)].ravel(),
              (vecs * sgn[np.asarray(tris)]).ravel().astype(dtype))
    return out


def solve(M, r):
    """x with M x = r by a sparse LU (SuperLU, COLAMD ordering), in the
    matrix's own precision."""
    return sla.splu(sp.csc_matrix(M), permc_spec="COLAMD").solve(
        np.asarray(r, M.dtype))
