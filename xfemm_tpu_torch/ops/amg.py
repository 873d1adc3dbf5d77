"""Smoothed-aggregation algebraic multigrid (the ELL-AMG engine).

The port of the JAX package's ``ops/amg.py``. Setup runs on the host in
f64 with scipy, line for line as there: coordinate-bucketing
aggregation, the smoothed prolongator, Galerkin triple products and the
dense coarsest inverse. The cycle (``vcycle``) runs on the tensors'
device as plain PyTorch: padded ELLPACK products (a gather and a row
sum), damped-Jacobi smoothing, the prolongation as an ELLPACK gather,
the restriction as an ``index_add_`` of P's entries, and a dense bottom
product. The engine has no Pallas kernel in the JAX package and no
hand-written kernel here. It preconditions the problems too small for
the band engine and the plans with no band storage tier, and it is the
engine a session falls back to when the band V-cycle stops contracting
(``solver.solve``).

The band-AMG setup (``band.setup_band_amg``) shares the host helpers:
the damped-Jacobi weight, the Gershgorin bound on lambda_max(D^-1 A)
and the scaled dense inverse of the coarsest level.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

AGG_TARGET = 32          # DOFs per aggregate (per level)
COARSE_MAX = 1500        # dense-inverse threshold
JACOBI_OMEGA = 0.67      # damping relative to lambda_max(D^-1 A)


class EllMatrix(NamedTuple):
    """Padded ELLPACK: ``y[i] = sum_k vals[i,k] * x[cols[i,k]]``."""

    vals: np.ndarray     # (n, D)
    cols: np.ndarray     # (n, D) int32, padded entries point at row i
    shape: tuple


def csr_to_ell(A: sp.csr_matrix, dtype=np.float32) -> EllMatrix:
    n = A.shape[0]
    deg = np.diff(A.indptr)
    D = max(int(deg.max()), 1)
    rows = np.repeat(np.arange(n), deg)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
    cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, D))
    vals = np.zeros((n, D), dtype)
    cols[rows, pos] = A.indices.astype(np.int32)
    vals[rows, pos] = A.data.astype(dtype)
    return EllMatrix(vals=vals, cols=cols, shape=A.shape)


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


class HostLevel(NamedTuple):
    A: sp.csr_matrix
    invd: np.ndarray       # 1/diag
    omega: np.ndarray      # scalar damped-Jacobi weight
    P: sp.csr_matrix | None
    R: sp.csr_matrix | None


def _aggregate(coords: np.ndarray, active: np.ndarray,
               target: int = AGG_TARGET) -> np.ndarray:
    """Spatial-cell aggregation: returns (n,) aggregate id, -1 for
    inactive (Dirichlet) DOFs. Cell size is chosen so the mean aggregate
    holds ~``target`` active DOFs."""
    n = len(coords)
    agg = np.full(n, -1, np.int64)
    act = np.nonzero(active)[0]
    if len(act) == 0:
        return agg
    c = coords[act]
    span = c.max(axis=0) - c.min(axis=0)
    span = np.where(span <= 0, 1.0, span)
    ncells = max(1, len(act) // target)
    # split cells proportional to the spans
    aspect = span[0] / span[1] if span[1] > 0 else 1.0
    ny = max(1, int(round(np.sqrt(ncells / max(aspect, 1e-9)))))
    nx = max(1, int(np.ceil(ncells / ny)))
    ix = np.clip(((c[:, 0] - c[:, 0].min()) / span[0] * nx).astype(int),
                 0, nx - 1)
    iy = np.clip(((c[:, 1] - c[:, 1].min()) / span[1] * ny).astype(int),
                 0, ny - 1)
    cell = ix * ny + iy
    _, ids = np.unique(cell, return_inverse=True)
    agg[act] = ids
    return agg


def setup(A: sp.csr_matrix, coords: np.ndarray | None,
          fixed: np.ndarray) -> list[HostLevel] | None:
    """Build the multigrid hierarchy on the host (f64).

    ``A`` must already have identity rows/columns at Dirichlet DOFs.
    Returns the level list (coarsest last, with its dense inverse in
    ``A``), or None when coordinates are unavailable (the caller falls
    back to Jacobi preconditioning). At or below COARSE_MAX unknowns the
    list holds the coarsest level alone."""
    if coords is None:
        return None
    levels: list[HostLevel] = []
    active = ~np.asarray(fixed, bool)
    cur_coords = np.asarray(coords, np.float64)
    while A.shape[0] > COARSE_MAX and len(levels) < 6:
        d = np.asarray(A.diagonal())
        d[d == 0] = 1.0
        invd = 1.0 / d
        lam = lambda_max_est(A, invd)
        omega = JACOBI_OMEGA * 2.0 / lam

        agg = _aggregate(cur_coords, active)
        nc = int(agg.max()) + 1
        if nc <= 0 or nc >= A.shape[0]:
            break
        rows = np.nonzero(agg >= 0)[0]
        P0 = sp.csr_matrix((np.ones(len(rows)), (rows, agg[rows])),
                           shape=(A.shape[0], nc))
        # smoothed aggregation: P = (I - omega D^-1 A) P0
        P = P0 - sp.diags(omega * invd) @ (A @ P0)
        R = P.T.tocsr()
        Ac = (R @ A @ P).tocsr()
        levels.append(HostLevel(A=A, invd=invd, omega=np.float64(omega),
                                P=P.tocsr(), R=R))
        # next-level coords: aggregate centroids; all coarse DOFs active
        cnt = np.maximum(np.asarray(P0.sum(axis=0)).ravel(), 1.0)
        cx = (P0.T @ cur_coords[:, 0]) / cnt
        cy = (P0.T @ cur_coords[:, 1]) / cnt
        cur_coords = np.stack([cx, cy], axis=1)
        active = np.ones(nc, bool)
        A = Ac
    # coarsest level: dense inverse
    d = np.asarray(A.diagonal())
    d[d == 0] = 1.0
    levels.append(HostLevel(A=A, invd=1.0 / d, omega=np.float64(1.0),
                            P=None, R=None))
    return levels


class DeviceLevel(NamedTuple):
    ell_vals: torch.Tensor
    ell_cols: torch.Tensor
    invd: torch.Tensor
    omega: torch.Tensor
    # prolongation (ELLPACK rows over fine DOFs) and restriction
    # (scatter form: same arrays, transposed application)
    p_vals: torch.Tensor
    p_cols: torch.Tensor


class DeviceAMG(NamedTuple):
    levels: tuple              # tuple[DeviceLevel, ...] (fine..second-coarsest)
    coarse_inv: torch.Tensor   # (nc, nc) dense inverse of the last level


def to_device(levels: list[HostLevel], dtype=np.float32,
              device="cpu") -> DeviceAMG:
    """The host hierarchy as tensors on ``device`` (values in ``dtype``,
    column indices int64)."""
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32

    def t(a, dt=tdt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    dev_levels = []
    for lv in levels[:-1]:
        ell = csr_to_ell(lv.A, dtype)
        pell = csr_to_ell_rect(lv.P, dtype)
        dev_levels.append(DeviceLevel(
            ell_vals=t(ell.vals), ell_cols=t(ell.cols, torch.int64),
            invd=t(lv.invd), omega=t(lv.omega),
            p_vals=t(pell.vals), p_cols=t(pell.cols, torch.int64)))
    cinv = scaled_inv(levels[-1].A.toarray())
    return DeviceAMG(levels=tuple(dev_levels),
                     coarse_inv=t(cinv.astype(dtype)))


def csr_to_ell_rect(P: sp.csr_matrix, dtype=np.float32) -> EllMatrix:
    """ELLPACK for rectangular P; padding points at column 0 with value
    0 so padded terms vanish."""
    n = P.shape[0]
    deg = np.diff(P.indptr)
    D = max(int(deg.max()), 1)
    rows = np.repeat(np.arange(n), deg)
    pos = np.arange(P.nnz) - np.repeat(P.indptr[:-1], deg)
    cols = np.zeros((n, D), np.int32)
    vals = np.zeros((n, D), dtype)
    cols[rows, pos] = P.indices.astype(np.int32)
    vals[rows, pos] = P.data.astype(dtype)
    return EllMatrix(vals=vals, cols=cols, shape=P.shape)


# ---------------------------------------------------------------------- #
# device-side application                                                #
# ---------------------------------------------------------------------- #

def _take(x, cols):
    """x[cols]; with a leading part axis (x (P, n), cols (P, m, D)) each
    part gathers from its own slice."""
    if x.dim() == 1:
        return x[cols]
    return torch.gather(x, 1, cols.reshape(x.shape[0], -1)).view(cols.shape)


def ell_matvec(vals, cols, x):
    return (vals * _take(x, cols)).sum(dim=-1)


def p_apply(lv: DeviceLevel, xc):
    """z = P xc (fine <- coarse): ELLPACK gather over fine rows."""
    return (lv.p_vals * _take(xc, lv.p_cols)).sum(dim=-1)


def pt_apply(lv: DeviceLevel, r, nc: int):
    """rc = P^T r (coarse <- fine): scatter-add of P's entries (atomic on
    the card, so its sums vary by rounding from run to run)."""
    contrib = lv.p_vals * r[..., None]
    if r.dim() == 1:
        return torch.zeros(nc, dtype=r.dtype, device=r.device).index_add_(
            0, lv.p_cols.reshape(-1), contrib.reshape(-1))
    P = r.shape[0]
    return torch.zeros((P, nc), dtype=r.dtype, device=r.device).scatter_add_(
        1, lv.p_cols.reshape(P, -1), contrib.reshape(P, -1))


def vcycle(amg: DeviceAMG, r):
    """Symmetric V(1,1) cycle over the level list; with no levels (a
    problem at or below COARSE_MAX unknowns) it is the bottom product
    alone. Coarse sizes come from the next level's shapes. A hierarchy
    whose tensors carry a leading part axis (``parallel.schwarz``: one
    hierarchy per part, ``omega`` of shape (P, 1)) cycles every part at
    once on an (P, n) residual; its bottom products run part by part, so
    a part's result does not depend on how many parts share the call
    (a batched product rounds by its batch)."""
    from .kernels import fp32_matmul
    L = len(amg.levels)

    def cycle(l, r):
        if l == L:
            with fp32_matmul():
                if r.dim() == 1:
                    return amg.coarse_inv @ r
                return torch.stack([amg.coarse_inv[p] @ r[p]
                                    for p in range(r.shape[0])])
        lv = amg.levels[l]
        nc = (amg.levels[l + 1].ell_vals.shape[-2] if l + 1 < L
              else amg.coarse_inv.shape[-1])
        z = lv.omega * lv.invd * r
        d = r - ell_matvec(lv.ell_vals, lv.ell_cols, z)
        zc = cycle(l + 1, pt_apply(lv, d, nc))
        z = z + p_apply(lv, zc)
        z = z + lv.omega * lv.invd * (
            r - ell_matvec(lv.ell_vals, lv.ell_cols, z))
        return z

    return cycle(0, r)
