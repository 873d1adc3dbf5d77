"""The work a kernel must do, counted from the problem and not from the
program's data structures, and the card's published peaks.

``csr_apply_bytes`` is what one application of the Dirichlet-eliminated
operator needs, whatever format holds it: float32 values and int32
column indices of its nonzeros, int32 row pointers, x read once and y
written once. Its nonzeros are the distinct node pairs of the elements
between free nodes, plus one unit diagonal per fixed node.

``sweep_bytes`` is what one block-tridiagonal sweep launch reads and
writes: its factor blocks once and its vectors once.
"""

from __future__ import annotations

import numpy as np

#: published peaks by card name (NVIDIA H100 SXM data sheet, dense, at
#: the 700 W power limit): HBM bytes/s and float32 (non-tensor-core) FLOP/s
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12}}


def peak(device_name: str) -> dict | None:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def csr_nnz(elements, n_nodes: int, fixed) -> int:
    """Nonzeros of the Dirichlet-eliminated operator on ``n_nodes``."""
    tris = np.asarray(elements, np.int64)
    fixed = np.asarray(fixed, bool)
    i = np.repeat(tris, 3, axis=1).ravel()
    j = np.tile(tris, (1, 3)).ravel()
    keep = ~fixed[i] & ~fixed[j]
    pairs = np.unique(i[keep] * n_nodes + j[keep])
    return int(len(pairs) + fixed.sum())


def csr_apply_bytes(elements, n_nodes: int, fixed) -> int:
    nnz = csr_nnz(elements, n_nodes, fixed)
    return 8 * nnz + 4 * (n_nodes + 1) + 8 * n_nodes


def sweep_bytes(blocks, vectors) -> int:
    """Bytes of the tensors a sweep reads or writes once each."""
    return int(sum(t.numel() * t.element_size() for t in blocks)
               + sum(t.numel() * t.element_size() for t in vectors))
