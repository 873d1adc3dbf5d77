"""Dense-band SpMV engine (fine level) on PyTorch tensors.

After a reverse-Cuthill-McKee reordering the FEM matrix is banded
(bandwidth ~sqrt(N) for 2-D meshes); rows are tiled in blocks of R and
each tile's band is stored DENSE over a window of K column chunks, so
the matvec is a batched dense product with no gathers:

    y[t] = dense[t] @ x[(t + shift0) * cchunk : ... + W]

``band_matvec`` runs the hand-written CUDA kernel (ops/kernels.py,
K1) on the card and its plain PyTorch version on CPU tensors.

This module holds the fine level only: the coarse band-AMG hierarchy
(V-cycle, prolongators, sidecar split, symmetric triu storage) of the
JAX package belongs to the 1M-class slice of the port; the band +
block-tridiagonal regime the 250k main path runs does not touch it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from . import kernels

LATER = ("is not ported yet: it belongs to the 1M-class slice of the "
         "PyTorch port (symmetric triu band, sidecar, band-AMG V-cycle)")

ROW_TILE = 512           # rows per band tile (planner's storage estimate)


@dataclass
class BandMatrix:
    """Banded (possibly rectangular) matrix: row tile t multiplies the
    column window starting at chunk (t + shift0) of size cchunk."""

    dense: torch.Tensor      # (NT, R, W)
    shift0: int
    cchunk: int
    ncols: int


def band_matvec(bm: BandMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x; x is the logical (ncols,) vector. The product is
    accumulated in f32 whatever the band's storage dtype."""
    return kernels.band_mv(bm.dense, x.float().contiguous(), bm.shift0,
                           bm.cchunk, bm.ncols)


def pack_band_layout(A: sp.csr_matrix, row_tile: int, cchunk: int):
    """Band geometry only -- the slot (tile, rloc, wloc) of every CSR
    entry -- without materializing the dense band on host. Large fine
    levels are filled on the device from these slots
    (``fill_band_device``)."""
    n, ncols = A.shape
    R = row_tile
    NT = (n + R - 1) // R
    deg = np.diff(A.indptr)
    rows = np.repeat(np.arange(n), deg)
    tile = rows // R
    rloc = rows - tile * R
    cmin = np.full(NT, 2 ** 62, np.int64)
    cmax = np.full(NT, -1, np.int64)
    np.minimum.at(cmin, tile, A.indices)
    np.maximum.at(cmax, tile, A.indices)
    empty = cmax < 0
    cmin[empty] = 0
    cmax[empty] = 0
    lo_chunk = cmin // cchunk
    shift = lo_chunk - np.arange(NT)
    shift0 = int(shift.min())
    hi_chunk = cmax // cchunk
    K = int((hi_chunk - (np.arange(NT) + shift0)).max()) + 1
    K = max(K, 1)
    W = K * cchunk
    wloc = A.indices - (tile + shift0) * cchunk
    assert wloc.min() >= 0 and wloc.max() < W, (wloc.min(), wloc.max(), W)
    return (tile, rloc, wloc, shift0, NT, R, W, ncols)


def fill_band_device(layout, data, cchunk: int, dtype=torch.float32,
                     device="cpu") -> BandMatrix:
    """Scatter CSR values into the dense band on the device instead of
    filling and uploading a multi-GB host array. Indexing is 2-D
    (row = tile*R + rloc, col = wloc) so it stays within int32 for
    1M-node bands."""
    tile, rloc, wloc, shift0, NT, R, W, ncols = layout
    rows = torch.as_tensor((tile * R + rloc).astype(np.int64), device=device)
    cols = torch.as_tensor(wloc.astype(np.int64), device=device)
    vals = torch.as_tensor(np.asarray(data, np.float32), device=device)
    dense = torch.zeros((NT * R, W), dtype=dtype, device=device)
    dense[rows, cols] = vals.to(dtype)
    return BandMatrix(dense=dense.view(NT, R, W), shift0=shift0,
                      cchunk=cchunk, ncols=ncols)


def pack_band(A: sp.csr_matrix, row_tile: int, cchunk: int,
              dtype=np.float32) -> "tuple":
    """Host-side band packing of a CSR matrix. Returns (layout, dense)
    where layout = (tile, rloc, wloc, shift0, NT, R, W, ncols) gives the
    slot of every CSR entry for value-only device rebuilds."""
    layout = pack_band_layout(A, row_tile, cchunk)
    tile, rloc, wloc, shift0, NT, R, W, ncols = layout
    dense = np.zeros((NT, R, W), dtype)
    dense[tile, rloc, wloc] = A.data.astype(dtype)
    return layout, dense


_ROW_TILES = (128, 256, 512)


def _band_W(cut: int, R: int, sym: bool) -> int:
    """Exact worst-case window width of ``pack_band_layout`` for a band
    of half-width ``cut`` at row tile/chunk R: a tile's rows span
    columns [tR - cut, tR + R - 1 + cut] (triu: [tR, tR + R - 1 + cut]),
    so K = 2*ceil(cut/R) + 1 chunks (sym: ceil(cut/R) + 1)."""
    kc = (cut + R - 1) // R
    K = (kc + 1) if sym else (2 * kc + 1)
    return K * R


def pick_row_tile(cut: int, sym: bool) -> int:
    """Row-tile size minimizing the band window W (the matvec is bound
    by the band's bytes); ties prefer larger tiles."""
    return min(_ROW_TILES, key=lambda R: (_band_W(cut, R, sym), -R))


def _band_est(n: int, cut: int, R: int, sym: bool,
              itemsize: int = 4) -> float:
    NT = (n + R - 1) // R
    return float(NT) * R * _band_W(cut, R, sym) * itemsize


#: byte-equivalent cost of one sidecar entry per operator application
#: and the fixed cost of a sidecar apply, as the JAX package's planner
#: models them (band.py SIDECAR_*): the planner's decisions must match
SIDECAR_EQ_BYTES = 2200
SIDECAR_FIXED_BYTES = 2.0e8
SIDECAR_MAX = 4_000_000
SIDECAR_FRAC_MAX = 0.02


def plan_level(dist: np.ndarray, n: int, sym: bool,
               sidecar_eq: int = SIDECAR_EQ_BYTES,
               tail_cap: int = SIDECAR_MAX):
    """Choose (R, cut) for a band level from its |row-col| distances:
    minimizes dense band bytes at the cut plus the sidecar's modeled
    cost for the strict tail. Returns (R, cut, split); split=False keeps
    every entry in the band."""
    if dist.size == 0:
        return _ROW_TILES[-1], 0, False
    qs = np.sort(dist)
    bw = int(qs[-1])
    mirror = 2 if sym else 1
    max_tail = int(min(tail_cap // mirror,
                       SIDECAR_FRAC_MAX * dist.size,
                       dist.size - 1))
    tails = np.unique(np.geomspace(1, max(max_tail, 1),
                                   num=48).astype(np.int64))
    cands = {bw} | {int(qs[dist.size - 1 - t]) for t in tails
                    if t < dist.size}
    best = (np.inf, _ROW_TILES[-1], bw, False)
    for cut in sorted(cands):
        tail = int(dist.size - np.searchsorted(qs, cut, side="right"))
        if tail > max_tail:
            continue
        R = pick_row_tile(cut, sym)
        cost = _band_est(n, cut, R, sym) \
            + float(tail) * mirror * sidecar_eq \
            + (SIDECAR_FIXED_BYTES if tail > 0 else 0.0)
        if cost < best[0]:
            best = (cost, R, cut, tail > 0)
    return best[1], best[2], best[3]


class FineLayout(NamedTuple):
    """Slot map for value-only refreshes of the fine band level. The
    selection fields serve symmetric / split storage and are None in
    this slice."""

    tile: np.ndarray
    rloc: np.ndarray
    wloc: np.ndarray
    shift0: int
    NT: int
    R: int
    W: int
    ncols: int
    upper_sel: "np.ndarray | None" = None
    diag_pos: "np.ndarray | None" = None
    keep_sel: "np.ndarray | None" = None
    oob_src: "np.ndarray | None" = None


@dataclass
class BandLevel:
    A: BandMatrix
    invd: torch.Tensor       # (n,) f32 inverse diagonal


@dataclass
class BandAMG:
    """The band hierarchy. In this slice it holds the fine level only
    (the block-tridiagonal factor is the whole preconditioner)."""

    levels: tuple
    n: int


def band_apply(A: BandMatrix, dvec, x: torch.Tensor, oob=None):
    """y = A x for square levels (plain band storage)."""
    if dvec is not None:
        raise NotImplementedError("band_apply with symmetric (triu) "
                                  "storage " + LATER)
    if oob is not None:
        raise NotImplementedError("band_apply with an out-of-band COO "
                                  "sidecar " + LATER)
    return band_matvec(A, x)[:x.shape[0]]


def setup_fine_band(At: sp.csr_matrix, dtype=torch.float32,
                    device="cpu"):
    """Fine level of the band hierarchy with its COMPLETE band kept (the
    JAX package's ``setup_band_amg`` first pass with ``fine_full=True``,
    no symmetric storage): the block-tridiagonal factor built next must
    cover the whole operator band. ``At`` is RCM-ordered with Dirichlet
    identity rows. Returns (BandAMG with one level, FineLayout)."""
    from ..utils import profiling

    with profiling.phase("band fine setup"):
        A = At.astype(np.float32)
        n = A.shape[0]
        d = np.asarray(A.diagonal(), np.float64)
        d[d == 0] = 1.0
        invd = 1.0 / d
        rowsA = np.repeat(np.arange(n), np.diff(A.indptr))
        dist = np.abs(A.indices - rowsA)
        cut = int(dist.max()) if dist.size else 0
        R = pick_row_tile(cut, False)
        lay = pack_band_layout(A, R, R)
        fine_layout = FineLayout(*lay)
        Adev = fill_band_device(lay, At.data, R, dtype, device)
    level = BandLevel(A=Adev, invd=torch.as_tensor(invd, dtype=dtype,
                                                   device=device))
    return BandAMG(levels=(level,), n=n), fine_layout


def update_fine_values(amg: BandAMG, fine_layout: FineLayout, data,
                       idx_dev=None) -> BandAMG:
    """New fine-level matrix values (same pattern), written IN PLACE
    into the existing band (an ``index_put_``: no multi-GB transient);
    returns ``amg`` itself."""
    lay = fine_layout
    lv0 = amg.levels[0]
    dense = lv0.A.dense
    if idx_dev is None:
        idx_dev = fine_slot_index(lay, dense.device)
    vals = torch.as_tensor(np.asarray(data, np.float32), device=dense.device)
    dense.view(lay.NT * lay.R, lay.W).index_put_(idx_dev, vals.to(dense.dtype))
    return amg


def fine_slot_index(lay: FineLayout, device) -> tuple:
    """Device (row, col) slot indices of every fine band entry."""
    return (torch.as_tensor((lay.tile * lay.R + lay.rloc).astype(np.int64),
                            device=device),
            torch.as_tensor(lay.wloc.astype(np.int64), device=device))


#: iterations between true-residual checks inside a band CG pass: the
#: f32 three-term recurrence drifts from the TRUE residual on long
#: passes, so every CG_CHECK_EVERY iterations the pass recomputes
#: b - A x (one extra apply) and restarts on drift
CG_CHECK_EVERY = 48


def _chunked_pcg(op, prec, invd, b, tol, x0, max_iter,
                 stall_window: int, check_every: int = CG_CHECK_EVERY):
    """Preconditioned CG with drift-guarded chunks (the JAX package's
    band._chunked_pcg, same semantics).

    Runs up to ``check_every`` recurrence iterations, then recomputes
    the true residual b - A x. The pass ends when the TRUE metric
    reaches ``tol``, or when the recurrence has reached ``tol`` while
    the true metric stagnates across checks (the f32 floor), or on the
    iteration/stall limits. When the recurrence claims a much better
    norm than the truth (or has converged while the truth has not) the
    recurrence restarts from the fresh residual. Returns
    ``(x, true relative metric, iterations)`` as host numbers for the
    last two.

    The JAX ``while_loop`` becomes a host loop over device tensors. The
    stopping state stays on the device: an iteration past the stopping
    point is masked (its step scale is zero, so x, r, p and the
    counters do not move), which keeps the result identical to the
    early exit. The host reads the scalars with one blocking copy per
    check; between checks it only polls, without blocking, the CUDA
    event behind each iteration's "still active" flag and ends the
    chunk once the device has reported it finished."""
    dev = b.device
    f32 = torch.float32
    x0 = x0.to(f32)
    tol = torch.as_tensor(tol, dtype=f32, device=dev)
    res0 = torch.dot(invd * b, b)
    res0 = torch.where(res0 == 0.0, torch.ones_like(res0), res0)

    r = b - op(x0)
    z = prec(r)
    p = z
    res = torch.dot(z, r)
    stop = torch.dot(invd * r, r)
    x = x0.clone()
    it = torch.zeros((), dtype=torch.int32, device=dev)
    best = res.abs()
    since = torch.zeros((), dtype=torch.int32, device=dev)
    stop_prev = torch.full((), float("inf"), dtype=f32, device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        flags = torch.empty(check_every, dtype=torch.bool, pin_memory=True)

    while True:
        pending = []
        for j in range(check_every):
            active = ((torch.sqrt(stop.abs() / res0) > tol)
                      & (it < max_iter) & (since < stall_window))
            if cuda:
                flags[j].copy_(active, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
                pending.append((j, ev))
            elif not bool(active):
                break
            u = op(p)
            delta = torch.where(active, res / torch.dot(p, u),
                                torch.zeros_like(res))
            x = x + delta * p
            r = r - delta * u
            z = prec(r)
            res_new = torch.dot(z, r)
            stop = torch.where(active, torch.dot(invd * r, r), stop)
            p = torch.where(active, z + (res_new / res) * p, p)
            improved = active & (res_new.abs() < 0.99 * best)
            best = torch.where(improved, res_new.abs(), best)
            since = torch.where(active & ~improved, since + 1,
                                torch.where(improved, 0, since))
            res = torch.where(active, res_new, res)
            it = it + active.to(torch.int32)
            if cuda:
                done_early = False
                while pending and pending[0][1].query():
                    k, _ = pending.pop(0)
                    if not bool(flags[k]):
                        done_early = True
                        break
                if done_early:
                    break

        rec_ok = torch.sqrt(stop.abs() / res0) <= tol
        rt = b - op(x)
        stop_t = torch.dot(invd * rt, rt)
        true_ok = torch.sqrt(stop_t / res0) <= tol
        stagnant = stop_t > 0.25 * stop_prev
        done = (true_ok | (rec_ok & stagnant)
                | (it >= max_iter) | (since >= stall_window))
        drift = stop_t > 2.25 * stop.abs()
        restart = ~done & (drift | rec_ok)
        stop_prev = stop_t
        flags_h = torch.stack([done, restart]).cpu()
        if bool(flags_h[0]):
            break
        if bool(flags_h[1]):
            # the whole carried stopping state resets to the truth
            r = rt
            p = prec(rt)
            res = torch.dot(p, rt)
            stop = stop_t
            best = res.abs()
            since = torch.zeros_like(since)
    return x, float(torch.sqrt(stop_t / res0)), int(it)
