"""Host helpers of the band hierarchy's setup (numpy / scipy only).

The port's own copy of the host-side pieces of the JAX package's
``ops/amg.py`` that the band-AMG setup uses: the damped-Jacobi weight,
the Gershgorin bound on lambda_max(D^-1 A), and the scaled dense inverse
of the coarsest level. The JAX package's ELLPACK AMG (the small-problem
path) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

JACOBI_OMEGA = 0.67      # damping relative to lambda_max(D^-1 A)


def lambda_max_est(A: sp.csr_matrix, invd: np.ndarray, iters: int = 12):
    """Certified upper bound on lambda_max(D^-1 A) via Gershgorin row
    sums of the Jacobi-scaled matrix (host, f64). A power iteration
    converges from below, and an undershoot makes the damped-Jacobi
    smoother amplify the top modes; the row-sum bound is always above
    lambda_max and tight on FEM operators. ``iters`` is unused (kept
    for the JAX package's signature)."""
    absA = A.copy()
    absA.data = np.abs(absA.data)
    rowsum = absA @ np.ones(A.shape[0])
    lam = float(np.max(rowsum * np.abs(invd)))
    return max(lam, 1.0)


def scaled_inv(Ad: np.ndarray) -> np.ndarray:
    """Dense coarsest-level inverse through symmetric Jacobi scaling,
    lightly regularized: the D^-1/2 scaling makes the rows O(1) (raw
    coarsest Galerkin matrices can be near-singular in their units), and
    the Tikhonov term bounds the inverse when a floating null mode
    remains."""
    d = np.sqrt(np.abs(np.diag(Ad)))
    d[d == 0] = 1.0
    As = Ad / d[:, None] / d[None, :]
    As = As + np.eye(As.shape[0]) * 1e-10
    return np.linalg.inv(As) / d[None, :] / d[:, None]
