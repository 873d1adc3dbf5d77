"""Host-side mesh partitioning for domain decomposition (host numpy,
line for line the JAX package's ``parallel/partition.py``).

Elements are split into per-part slabs by coordinate bisection, reduced
DOFs are renumbered so each part owns a contiguous range with its
inter-part boundary DOFs packed at the tail of its slot range, and the
operator's halo exchange becomes a single ring shift per application
(``parallel/halo.py`` through ``parallel/comm.py``).

Ownership rule: a DOF shared between slab d and slab d+1 is owned by d, so
every part has only a LEFT halo (DOFs owned by its left neighbor); the
element-to-part assignment promotes stragglers so no element ever spans
more than two adjacent slabs.

Part-local vector layout (width ``hmax + nmax``)::

    [ left halo (hmax) | interior DOFs ... pad ... | boundary tail ]
      received from d-1  owned slots (nmax total, tail at the end)

The last ``hmax`` owned slots always contain the (padded) boundary tail,
so the exchanged strips are static slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class PartitionedSystem:
    ndev: int
    nmax: int                  # owned slots per device (padded)
    hmax: int                  # halo strip width (padded)
    nreduced: int
    counts: np.ndarray         # (ndev,) owned DOFs
    blocks: list               # [(idx (D,E,K), sign, mat)] local-indexed
    fixed_mask: np.ndarray     # (D, nmax)
    fixed_vals: np.ndarray     # (D, nmax)
    valid: np.ndarray          # (D, nmax)
    # vectorized old-reduced-DOF <-> (device, slot) maps
    dof_dev: np.ndarray = field(default=None)
    dof_slot: np.ndarray = field(default=None)

    def to_devices(self, x: np.ndarray, comm=None) -> np.ndarray:
        """Reduced-DOF vector -> (D, nmax) part layout; with a
        communicator, only the rows its process holds (``comm.local``)."""
        out = np.zeros((self.ndev, self.nmax), x.dtype)
        out[self.dof_dev, self.dof_slot] = x
        return out if comm is None else comm.local(out)

    def from_devices(self, xd, comm=None) -> np.ndarray:
        """The inverse: a (D, nmax) array, or with a communicator the
        process's part tensor, gathered through ``comm.all_gather``."""
        if comm is not None:
            xd = comm.all_gather(xd).view(self.ndev, self.nmax).cpu()
        return np.asarray(xd)[self.dof_dev, self.dof_slot]


def partition(blocks, nreduced: int, fixed_mask: np.ndarray,
              fixed_vals: np.ndarray, coords: np.ndarray,
              ndev: int) -> PartitionedSystem:
    """Partition assembled element blocks into ``ndev`` parts.

    ``blocks``: [(idx (E,K), sign (E,K), mat (E,K,K))] in reduced DOF
    numbering; ``coords``: (nreduced, 2) representative coordinates per
    reduced DOF (bisection axis data).
    """
    span = coords.max(axis=0) - coords.min(axis=0)
    axis = int(np.argmax(span))
    order = np.argsort(coords[:, axis], kind="stable")
    owner = np.zeros(nreduced, np.int64)
    for d, ids in enumerate(np.array_split(order, ndev)):
        owner[ids] = d

    # element device = max owner among its DOFs; promote DOF owners until
    # no element spans more than two adjacent slabs
    for _ in range(ndev):
        promoted = False
        for idx, sign, mat in blocks:
            ed = owner[idx].max(axis=1)
            gap = ed[:, None] - owner[idx]
            bad = gap > 1
            if bad.any():
                rows, cols = np.nonzero(bad)
                np.maximum.at(owner, idx[rows, cols], ed[rows] - 1)
                promoted = True
        if not promoted:
            break

    elem_dev = [owner[idx].max(axis=1) for idx, sign, mat in blocks]

    # DOFs shared with the next slab (touched by a higher-device element)
    shared_next = np.zeros(nreduced, bool)
    for (idx, sign, mat), ed in zip(blocks, elem_dev):
        for k in range(idx.shape[1]):
            sel = ed > owner[idx[:, k]]
            shared_next[idx[sel, k]] = True

    counts = np.zeros(ndev, np.int64)
    tails = np.zeros(ndev, np.int64)
    dof_dev = owner.copy()
    dof_rel = np.zeros(nreduced, np.int64)   # rank within the device
    interior_counts = np.zeros(ndev, np.int64)
    for d in range(ndev):
        own = np.nonzero(owner == d)[0]
        interior = own[~shared_next[own]]
        tail = own[shared_next[own]]
        counts[d] = len(own)
        tails[d] = len(tail)
        interior_counts[d] = len(interior)
        dof_rel[interior] = np.arange(len(interior))
        dof_rel[tail] = len(interior) + np.arange(len(tail))

    nmax = max(int(counts.max()), 1)
    hmax = max(int(tails.max()), 1)

    # slot of an owned DOF: interior at the front, tail packed at the end
    def owned_slot(dofs):
        d = dof_dev[dofs]
        rel = dof_rel[dofs]
        is_tail = rel >= interior_counts[d]
        return np.where(is_tail, nmax - counts[d] + rel, rel)

    dof_slot = owned_slot(np.arange(nreduced))

    # local index in the extended vector [halo (hmax) | owned (nmax)]
    def local_index(dofs, on_dev):
        d = dof_dev[dofs]
        rel = dof_rel[dofs]
        loc_own = hmax + owned_slot(dofs)
        loc_halo = hmax - tails[d] + (rel - interior_counts[d])
        return np.where(on_dev == d, loc_own, loc_halo)

    out_blocks = []
    for (idx, sign, mat), ed in zip(blocks, elem_dev):
        E, K = idx.shape
        loc = local_index(idx.reshape(-1),
                          np.repeat(ed, K)).reshape(E, K)
        emax = max(max((int((ed == d).sum()) for d in range(ndev)),
                       default=0), 1)
        bidx = np.zeros((ndev, emax, K), np.int64)
        bsign = np.zeros((ndev, emax, K))
        bmat = np.zeros((ndev, emax, K, K))
        for d in range(ndev):
            sel = np.nonzero(ed == d)[0]
            bidx[d, :len(sel)] = loc[sel]
            bsign[d, :len(sel)] = sign[sel]
            bmat[d, :len(sel)] = mat[sel]
        out_blocks.append((bidx, bsign, bmat))

    fm = np.zeros((ndev, nmax), bool)
    fv = np.zeros((ndev, nmax))
    valid = np.zeros((ndev, nmax), bool)
    fm[dof_dev, dof_slot] = fixed_mask
    fv[dof_dev, dof_slot] = fixed_vals
    valid[dof_dev, dof_slot] = True

    return PartitionedSystem(
        ndev=ndev, nmax=nmax, hmax=hmax, nreduced=nreduced, counts=counts,
        blocks=out_blocks, fixed_mask=fm, fixed_vals=fv, valid=valid,
        dof_dev=dof_dev, dof_slot=dof_slot)
