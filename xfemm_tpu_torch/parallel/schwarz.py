"""Additive-Schwarz AMG preconditioning for the distributed solve: the
JAX package's ``parallel/schwarz.py``.

The distributed CG of :mod:`halo` preconditions with Jacobi; that is
robust but iteration counts grow with problem size. This module builds a
smoothed-aggregation AMG hierarchy over each part's OWNED diagonal block
(halo couplings dropped: one-level additive Schwarz / block-Jacobi) and
applies the V-cycle per part with no communication, and a small GLOBAL
coarse problem over contiguous per-part aggregates (two-level Schwarz,
one all-gather per application).

The host half is the JAX package's, line for line (f64 scipy): the
hierarchies have part-uniform shapes (every part has the same padded
size ``nmax``, aggregation is uniform and contiguous, the level count is
forced identical, ELLPACK widths are padded to the per-level maximum
over parts), so they stack into one ``amg.DeviceAMG`` whose tensors carry
a leading part axis; ``amg.vcycle`` cycles every part at once. Every
process builds every part's host hierarchy (the widths are maxima over
the parts) and uploads its communicator's parts only (``comm.local``);
the global coarse inverse is replicated, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.amg import (JACOBI_OMEGA, DeviceAMG, DeviceLevel,
                       lambda_max_est, scaled_inv)
from .comm import STACKED
from .partition import PartitionedSystem

AGG = 8
COARSE_MAX = 512
MAX_LEVELS = 4


def local_csr(ps: PartitionedSystem, d: int) -> sp.csr_matrix:
    """Owned-block CSR of shard ``d`` (halo couplings dropped, Dirichlet
    and padding rows as identity)."""
    n = ps.nmax
    h = ps.hmax
    rows = []
    cols = []
    vals = []
    for idx, sign, mat in ps.blocks:
        li = idx[d]          # (E, K) extended-local indices
        ls = sign[d]
        lm = mat[d]
        K = li.shape[1]
        own = li >= h        # owned-slot entries only
        for i in range(K):
            for j in range(K):
                keep = own[:, i] & own[:, j]
                if not keep.any():
                    continue
                rows.append(li[keep, i] - h)
                cols.append(li[keep, j] - h)
                vals.append(ls[keep, i] * ls[keep, j] * lm[keep, i, j])
    if rows:
        A = sp.csr_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))
        A.sum_duplicates()
    else:
        A = sp.csr_matrix((n, n))
    # identity rows for Dirichlet + padding slots
    fix = ps.fixed_mask[d] | ~ps.valid[d]
    keep = (~fix).astype(np.float64)
    A = sp.diags(keep) @ A @ sp.diags(keep)
    diag = A.diagonal()
    add = np.where(fix | (diag == 0.0), 1.0, 0.0)
    A = (A + sp.diags(add)).tocsr()
    return A


def _ell_pad(A: sp.csr_matrix, D: int, dtype):
    n = A.shape[0]
    deg = np.diff(A.indptr)
    rows = np.repeat(np.arange(n), deg)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
    cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, D))
    vals = np.zeros((n, D), dtype)
    cols[rows, pos] = A.indices.astype(np.int32)
    vals[rows, pos] = A.data.astype(dtype)
    return vals, cols


def _ell_pad_rect(Pm: sp.csr_matrix, D: int, dtype):
    n = Pm.shape[0]
    deg = np.diff(Pm.indptr)
    rows = np.repeat(np.arange(n), deg)
    pos = np.arange(Pm.nnz) - np.repeat(Pm.indptr[:-1], deg)
    cols = np.zeros((n, D), np.int32)
    vals = np.zeros((n, D), dtype)
    cols[rows, pos] = Pm.indices.astype(np.int32)
    vals[rows, pos] = Pm.data.astype(dtype)
    return vals, cols


def build_schwarz_amg(ps: PartitionedSystem, dtype=np.float32,
                      device="cpu", comm=STACKED) -> DeviceAMG:
    """Stacked per-part hierarchies of ``comm``'s parts: every tensor
    gains a leading part axis (``omega`` is (P, 1), so it broadcasts over
    each part's rows)."""
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32

    def t(a, dt=tdt):
        return torch.as_tensor(np.ascontiguousarray(comm.local(a)),
                               dtype=dt, device=device)

    # host hierarchies with identical level structure
    per_shard: list[list[tuple]] = []
    coarse_mats = []
    sizes = None
    for d in range(ps.ndev):
        A = local_csr(ps, d)
        levels = []
        cur_sizes = []
        while A.shape[0] > COARSE_MAX and len(levels) < MAX_LEVELS - 1:
            n = A.shape[0]
            dd = np.asarray(A.diagonal())
            dd[dd == 0] = 1.0
            invd = 1.0 / dd
            lam = lambda_max_est(A, invd)
            omega = JACOBI_OMEGA * 2.0 / lam
            nc = (n + AGG - 1) // AGG
            agg = np.arange(n) // AGG
            P0 = sp.csr_matrix((np.ones(n), (np.arange(n), agg)),
                               shape=(n, nc))
            Pm = (P0 - sp.diags(omega * invd) @ (A @ P0)).tocsr()
            Ac = (Pm.T @ A @ Pm).tocsr()
            Ac.sum_duplicates()
            levels.append((A, invd, omega, Pm))
            cur_sizes.append(n)
            A = Ac
        coarse_mats.append(A)
        per_shard.append(levels)
        if sizes is None:
            sizes = cur_sizes
        elif sizes != cur_sizes:
            raise ValueError("part hierarchies must align")

    nlev = len(per_shard[0])
    dev_levels = []
    for l in range(nlev):
        DA = max(max(int(np.diff(sh[l][0].indptr).max()), 1)
                 for sh in per_shard)
        DP = max(max(int(np.diff(sh[l][3].indptr).max()), 1)
                 for sh in per_shard)
        ev, ec, iv, om, pv, pc = [], [], [], [], [], []
        for sh in per_shard:
            A, invd, omega, Pm = sh[l]
            v, c = _ell_pad(A, DA, dtype)
            ev.append(v)
            ec.append(c)
            iv.append(invd.astype(dtype))
            om.append(np.asarray(omega, dtype))
            v2, c2 = _ell_pad_rect(Pm, DP, dtype)
            pv.append(v2)
            pc.append(c2)
        dev_levels.append(DeviceLevel(
            ell_vals=t(np.stack(ev)),
            ell_cols=t(np.stack(ec), torch.int64),
            invd=t(np.stack(iv)),
            omega=t(np.stack(om)[:, None]),
            p_vals=t(np.stack(pv)),
            p_cols=t(np.stack(pc), torch.int64)))
    cinv = np.stack([scaled_inv(A.toarray())
                     for A in comm.local(coarse_mats)])
    return DeviceAMG(levels=tuple(dev_levels),
                     coarse_inv=torch.as_tensor(cinv.astype(dtype),
                                                dtype=tdt, device=device))


COARSE_AGG_TARGET = 64   # coarse DOFs per shard for the global level


def build_global_coarse(ps: PartitionedSystem, device="cpu"):
    """Two-level Schwarz: a small GLOBAL coarse problem assembled from
    the full operator (including cross-shard couplings) over contiguous
    per-shard aggregates. Returns (coarse_inv (replicated), aggc) where
    aggc is the per-shard aggregation factor. One-level Schwarz is not
    scalable (no global information exchange in the preconditioner);
    the coarse solve is a small dense inverse (f64 on ``device``),
    applied with a single all-gather of ~ndev*64 values."""
    n = ps.nreduced
    aggc = max(1, (ps.nmax + COARSE_AGG_TARGET - 1) // COARSE_AGG_TARGET)
    m = (ps.nmax + aggc - 1) // aggc       # coarse DOFs per shard
    nc = ps.ndev * m

    # global fine CSR from the partitioned blocks: map extended-local
    # indices back to reduced DOFs
    gslot = np.full((ps.ndev, ps.nmax), -1, np.int64)
    gslot[ps.dof_dev, ps.dof_slot] = np.arange(n)
    rows, cols, vals = [], [], []
    for idx, sign, mat in ps.blocks:
        for d in range(ps.ndev):
            li = idx[d]
            ls = sign[d]
            lm = mat[d]
            # extended slot -> reduced dof (halo = left neighbor's tail)
            ext = np.empty(ps.hmax + ps.nmax, np.int64)
            if d > 0:
                ext[:ps.hmax] = gslot[d - 1, ps.nmax - ps.hmax:]
            else:
                ext[:ps.hmax] = 0     # unused (halo zeroed on dev 0)
            ext[ps.hmax:] = gslot[d]
            gi = ext[li]
            K = li.shape[1]
            ok = gi >= 0
            for i in range(K):
                for j in range(K):
                    keep = ok[:, i] & ok[:, j]
                    if not keep.any():
                        continue
                    rows.append(gi[keep, i])
                    cols.append(gi[keep, j])
                    vals.append(ls[keep, i] * ls[keep, j]
                                * lm[keep, i, j])
    At = sp.csr_matrix((np.concatenate(vals),
                        (np.concatenate(rows), np.concatenate(cols))),
                       shape=(n, n))
    At.sum_duplicates()
    fixed = ps.fixed_mask[ps.dof_dev, ps.dof_slot]
    keep = (~fixed).astype(np.float64)
    At = sp.diags(keep) @ At @ sp.diags(keep)
    At = (At + sp.diags(np.where(fixed | (At.diagonal() == 0.0),
                                 1.0, 0.0))).tocsr()

    # plain-aggregation coarse basis over (dev, slot // aggc)
    cid = ps.dof_dev * m + ps.dof_slot // aggc
    P0 = sp.csr_matrix((np.ones(n), (np.arange(n), cid)), shape=(n, nc))
    Ac = (P0.T @ At @ P0).toarray()
    # empty aggregates (padding-only): identity rows
    empty = np.asarray(P0.sum(axis=0)).ravel() == 0
    Ac[empty, :] = 0.0
    Ac[:, empty] = 0.0
    Ac[empty, empty] = 1.0
    d0 = np.diag(Ac).copy()
    d0[d0 == 0] = 1.0
    np.fill_diagonal(Ac, d0)
    return torch.as_tensor(scaled_inv(Ac), dtype=torch.float64,
                           device=device), aggc
