"""Dense-band SpMV engine and its band-AMG hierarchy on PyTorch tensors.

After a reverse-Cuthill-McKee reordering the FEM matrix is banded
(bandwidth ~sqrt(N) for 2-D meshes); rows are tiled in blocks of R and
each tile's band is stored DENSE over a window of K column chunks, so
the matvec is a batched dense product with no gathers:

    y[t] = dense[t] @ x[(t + shift0) * cchunk : ... + W]

``band_matvec`` runs the hand-written CUDA kernel K1 (ops/kernels.py) on
the card and its plain PyTorch version on CPU tensors; a level stored
as its upper triangle ("triu", ``dvec`` set) is applied by the fused
symmetric kernel K5 (``kernels.band_sym``). A partitioned ordering
leaves a few cross-part couplings far off the diagonal: they ride a COO
``Sidecar`` applied with ``index_add_``.

The AMG hierarchy reuses the banding at every level: aggregates are
runs of AGG consecutive DOFs in the band ordering, so the smoothed
prolongator and the Galerkin coarse matrices are banded too, and the
V-cycle (``band_vcycle``) is dense-band products, damped-Jacobi or
block-tridiagonal smoothing, and a dense (or block-tridiagonal) bottom
solve. Setup runs on the host with scipy (``setup_band_amg``). The AC
solvers (``band_csym_*``) apply a complex-symmetric operator as two
two-column K1 products, one on the band of its real part and one on
that of its imaginary part, each times (xr, xi): float32 (re, im)
pairs, each band streamed once per apply.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.profiling import phase
from . import kernels, loop
from .amg import JACOBI_OMEGA, lambda_max_est


class Sidecar(NamedTuple):
    """Out-of-band COO entries accompanying a BandMatrix.

    A partitioned ordering (``partition_order``) makes 99%+ of entries
    tightly banded but leaves a few cross-part couplings at arbitrary
    distance from the diagonal; they live here and are applied as one
    gather + ``index_add_``. For symmetric (triu) band storage the
    mirror copies are materialized, so one application covers both
    triangles."""

    rows: torch.Tensor       # (M,) int64
    cols: torch.Tensor       # (M,) int64
    vals: torch.Tensor       # (M,) f32


ROW_TILE = 512           # rows per band tile (planner's storage estimate)
AGG = 4                  # fine DOFs per aggregate (contiguous runs in the
                         # band ordering; small aggregates make a strong
                         # coarse space)
COARSE_MAX = 1500        # dense-inverse threshold
BF16_SMOOTH_MIN = 32 * 2 ** 20   # bf16 copy for smoothing products when a
                                 # level's f32 band exceeds this (bytes)
BF16_SMOOTH_MAX = 3 * 10 ** 9    # ...but no copy for giant levels, whose
                                 # f32 band already fills the budget
P_MAX_BYTES = 10 ** 9            # smoothed-prolongator bands (bf16) above
                                 # this fall back to aggregation transfers


@dataclass
class BandMatrix:
    """Banded (possibly rectangular) matrix: row tile t multiplies the
    column window starting at chunk (t + shift0) of size cchunk."""

    dense: torch.Tensor      # (NT, R, W)
    shift0: int
    cchunk: int
    ncols: int


def band_matvec(bm: BandMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x; x is the logical (ncols,) vector, or an (ncols, C)
    block of C <= 2 columns multiplied in one stream of the band (y is
    then (NT*R, C)). The product is accumulated in f32 whatever the
    band's storage dtype."""
    return kernels.band_mv(bm.dense, x.float().contiguous(), bm.shift0,
                           bm.cchunk, bm.ncols)


def band_rmatvec(bm: BandMatrix, y: torch.Tensor) -> torch.Tensor:
    """x = A^T y from the SAME dense band as ``band_matvec`` (the
    prolongator's restriction): plain PyTorch, a batched contraction
    and K shifted slice-adds (the JAX package's XLA code, no kernel)."""
    return kernels.band_rmatvec_plain(bm.dense, y.float(), bm.shift0,
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
SIDECAR_MAX = 4_000_000          # hard cap (memory + refresh maps)
#: per-COARSE-level sidecar entry cap: a Galerkin level's halo tail is
#: large but tiny in magnitude; only the largest entries ride the
#: sidecar, the rest are discarded (the level is preconditioner-internal)
COARSE_SIDECAR_MAX = 65536
#: the sidecar as a fraction of nnz is capped too: a larger split would
#: leave a band that no longer approximates the operator
SIDECAR_FRAC_MAX = 0.02
#: byte cap for any single coarse level's dense band (budget enforcement
#: in ``setup_band_amg``)
COARSE_LEVEL_MAX_BYTES = 1.5e9


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


def pick_parts(n: int, min_part: int = 48_000, max_parts: int = 16) -> int:
    """Number of RCB parts for ``partition_order``: halve while parts
    stay comfortably larger than ``min_part`` rows."""
    parts = 1
    while parts < max_parts and n // (2 * parts) >= min_part:
        parts *= 2
    return parts


def partition_order(At: sp.csr_matrix, coords: np.ndarray,
                    parts: int) -> np.ndarray:
    """Recursive-coordinate-bisection parts, reverse-Cuthill-McKee
    WITHIN each part, concatenated. In-part bandwidth scales with the
    part diameter (~sqrt(n/parts) for 2-D meshes) instead of the domain
    diameter; the cross-part couplings (<1% of nnz for FEM meshes)
    overflow into the Sidecar."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = At.shape[0]
    idxs = [np.arange(n)]
    while len(idxs) < parts:
        nxt = []
        for idx in idxs:
            if len(idx) < 4:
                nxt.append(idx)
                continue
            xy = coords[idx]
            ax = int(np.argmax(xy.max(axis=0) - xy.min(axis=0)))
            order = np.argsort(xy[:, ax], kind="stable")
            h = len(idx) // 2
            nxt.append(idx[order[:h]])
            nxt.append(idx[order[h:]])
        idxs = nxt
    out = []
    for idx in idxs:
        sub = At[idx][:, idx].tocsr()
        p = np.asarray(reverse_cuthill_mckee(sub, symmetric_mode=True))
        out.append(idx[p])
    return np.concatenate(out)


#: relative drop tolerance for coarse Galerkin matrices: smoothed
#: aggregation over contiguous aggregates densifies each level ~9x per
#: product; dropping |a_ij| < eps * sqrt(|a_ii a_jj|) keeps every coarse
#: level sparse and banded (pure dropping, no lumping: it only increases
#: diagonal dominance, so the levels stay SPD)
FILTER_EPS = 0.02


def _filter_galerkin(Ac: sp.csr_matrix, eps: float) -> sp.csr_matrix:
    """Drop |a_ij| < eps*sqrt(|a_ii a_jj|) off-diagonal entries."""
    n = Ac.shape[0]
    d = np.abs(np.asarray(Ac.diagonal(), np.float64))
    d[d == 0] = 1.0
    rows = np.repeat(np.arange(n), np.diff(Ac.indptr))
    scale = np.sqrt(d[rows] * d[Ac.indices])
    keep = (np.abs(Ac.data) >= eps * scale) | (rows == Ac.indices)
    if bool(keep.all()):
        return Ac
    Af, _dropped = _split_csr(Ac, keep)
    return Af


def _split_csr(A: sp.csr_matrix, keep: np.ndarray):
    """(A_kept, dropped_sel): the CSR holding only ``keep`` entries plus
    the positions of the dropped ones in A's data order."""
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    deg = np.bincount(rows[keep], minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(A.indptr.dtype)
    Ak = sp.csr_matrix((A.data[keep], A.indices[keep], indptr),
                       shape=A.shape)
    return Ak, np.nonzero(~keep)[0]


class FineLayout(NamedTuple):
    """Slot map for value-only refreshes of the fine band level: the
    dense-band slot of every kept entry plus the selections that carve
    the permuted CSR data into (triu ->) in-band + sidecar."""

    tile: np.ndarray
    rloc: np.ndarray
    wloc: np.ndarray
    shift0: int
    NT: int
    R: int
    W: int
    ncols: int
    upper_sel: "np.ndarray | None" = None   # triu selection (sym storage)
    diag_pos: "np.ndarray | None" = None    # diag slots in post-triu data
    keep_sel: "np.ndarray | None" = None    # in-band slots, post-triu data
    oob_src: "np.ndarray | None" = None     # post-triu slot per sidecar entry


@dataclass
class BandLevel:
    """One level of the band hierarchy. ``A`` is the operator band (the
    upper triangle when ``dvec`` holds the diagonal), ``oob`` its
    sidecar; ``P`` the smoothed prolongator band (bf16, None: aggregation
    transfers) with its sidecar ``P_oob``; ``Abf`` a bf16 copy of ``A``
    for the smoothing residuals; ``bts`` a bf16 block-tridiagonal factor
    of a split coarse level's kept band, its smoother in place of damped
    Jacobi (``setup_band_amg(coarse_bt_smooth=True)``); ``cperm``/
    ``ciperm`` bridge to the next level when that level lives in its own
    ordering."""

    A: BandMatrix
    invd: torch.Tensor                      # (n,) f32 inverse diagonal
    omega: "torch.Tensor | None" = None     # damped-Jacobi weight (f32)
    P: "BandMatrix | None" = None
    Abf: "BandMatrix | None" = None
    dvec: "torch.Tensor | None" = None      # diagonal of a triu level
    oob: "Sidecar | None" = None
    P_oob: "Sidecar | None" = None
    bts: "object | None" = None             # bf16 BTFactor of the kept band
    cperm: "torch.Tensor | None" = None
    ciperm: "torch.Tensor | None" = None


@dataclass
class BandAMG:
    """The band hierarchy: its levels and the bottom solve -- a dense
    inverse ``coarse_inv`` or a block-tridiagonal ``bt_coarse``
    (blocktri.BTCoarse, the two-grid form). A fine-level-only hierarchy
    (``setup_fine_band``, the bt-alone regime) has neither."""

    levels: tuple
    n: int
    coarse_inv: "torch.Tensor | None" = None
    bt_coarse: "object | None" = None


def band_apply(A: BandMatrix, dvec, x: torch.Tensor, oob=None):
    """y = A x for square levels: the band product (K1), or the fused
    symmetric product U x + U^T x - d x of a triu level (K5) when
    ``dvec`` is present; ``oob`` adds the out-of-band COO sidecar of a
    partitioned ordering."""
    n = x.shape[0]
    if dvec is not None:
        y = kernels.band_sym(A.dense, dvec, x.float().contiguous(),
                             A.shift0, A.cchunk, A.ncols)[:n]
    else:
        y = band_matvec(A, x)[:n]
    if oob is not None:
        y = y.index_add(0, oob.rows, oob.vals * x[oob.cols].float())
    return y


def setup_fine_band(At: sp.csr_matrix, dtype=torch.float32,
                    device="cpu"):
    """Fine level of the band hierarchy with its COMPLETE band kept (the
    first pass of ``setup_band_amg`` with ``fine_full=True``, no
    symmetric storage, no coarse levels): the bt-alone regime, whose
    block-tridiagonal factor built next covers the whole operator band
    and is the whole preconditioner. ``At`` is RCM-ordered with
    Dirichlet identity rows. Returns (BandAMG with one level,
    FineLayout)."""

    with phase("band fine setup"):
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


SYM_MIN_BYTES = 256 * 2 ** 20    # store levels above this as triu


def _cut_for_budget(qs: np.ndarray, n: int, bytes_allow: float,
                    sym: bool) -> tuple[int, int]:
    """Largest (R, cut) whose dense band fits ``bytes_allow``, scanning
    the level's sorted |row-col| distance quantiles (~64 probes). The
    dtype rule of ``setup_band_amg`` (bf16 above 1 GB f32) participates.
    Returns (R, cut); cut may be 0 (the diagonal-only band)."""
    best = (pick_row_tile(0, sym), 0)
    probe = np.unique(qs[np.linspace(0, qs.size - 1, 64).astype(np.int64)])
    for cut in probe:
        cut = int(cut)
        R = pick_row_tile(cut, sym)
        est = _band_est(n, cut, R, sym)
        itemsize = 2 if est > 1e9 else 4
        if est * itemsize / 4 <= bytes_allow and cut > best[1]:
            best = (R, cut)
    return best


def _sidecar(rows, cols, vals, device) -> Sidecar:
    return Sidecar(rows=torch.as_tensor(rows.astype(np.int64), device=device),
                   cols=torch.as_tensor(cols.astype(np.int64), device=device),
                   vals=torch.as_tensor(vals.astype(np.float32),
                                        device=device))


def setup_band_amg(At: sp.csr_matrix, dtype=torch.float32, sym: bool = False,
                   fine_dtype=None, bt_coarse_budget: float = 0.0,
                   bt_transient_budget: float | None = None,
                   coords: "np.ndarray | None" = None,
                   budget_bytes: float | None = None,
                   plan_only: bool = False,
                   fine_full: bool = False,
                   band_key: "np.ndarray | None" = None,
                   fine_abf: bool = True, coarse_bt_smooth: bool = False,
                   device="cpu"):
    """Build the band hierarchy (host f32 Galerkin products -> device
    bands), the JAX package's ``band.setup_band_amg``. ``At`` is already
    band-ordered with Dirichlet identity rows. Returns (BandAMG,
    fine_layout); the layout serves ``update_fine_values``.

    ``sym``: store square levels above SYM_MIN_BYTES as their upper
    triangle (applied by K5). ``fine_dtype`` (torch.bfloat16 or "bf16")
    stores the fine operator in bf16. ``coords``/``band_key`` (aligned
    with ``At``): when a level's ordering is partitioned (sidecar
    split), the next level is reordered by the aggregate-min of
    ``band_key`` (the fine global-RCM position), else re-partitioned by
    RCB on the aggregate centroids, else re-RCM'd. ``bt_coarse_budget``
    (> 0 enables): block-tridiagonal factor the FIRST Galerkin coarse
    matrix and stop there (two-grid); ``bt_transient_budget`` bounds its
    build peak. ``budget_bytes``: hard cap on the hierarchy's device
    residency -- coarse levels beyond it are truncated (the widest cut
    that fits, the largest dropped couplings in a capped sidecar, the
    rest discarded). ``fine_full`` keeps the fine level's complete band
    (no split). ``fine_abf=False`` skips the fine level's bf16 copy (the
    caller smooths it with a block-tridiagonal factor).
    ``coarse_bt_smooth`` gives every split coarse level that is not
    stored triu a bf16 block-tridiagonal factor of its kept band (the
    sidecar stays outside), its smoother in ``band_vcycle``, where the
    factor's bytes fit 1.6 GB and the budget. ``plan_only=True`` does no
    device work and returns (report, None): per-level dicts plus a
    totals entry."""
    from . import blocktri as bt_mod
    from .amg import scaled_inv

    if fine_dtype == "bf16":
        fine_dtype = torch.bfloat16
    levels = []
    bt_coarse = None
    A = At.astype(np.float32)
    fine_layout = None
    first = True
    used = 0.0                  # device bytes committed so far
    report: list[dict] = []     # plan_only output
    while A.shape[0] > COARSE_MAX and len(levels) < 6:
        n = A.shape[0]
        d = np.asarray(A.diagonal(), np.float64)
        d[d == 0] = 1.0
        invd = 1.0 / d
        lam = lambda_max_est(A, invd)
        omega = JACOBI_OMEGA * 2.0 / lam

        # uniform contiguous aggregation in the band ordering
        nc = (n + AGG - 1) // AGG
        agg = np.arange(n) // AGG
        with phase("band galerkin"):
            P0 = sp.csr_matrix((np.ones(n, np.float32),
                                (np.arange(n), agg)), shape=(n, nc))
            P = (P0 - sp.diags((omega * invd).astype(np.float32))
                 @ (A @ P0)).tocsr()
            Ac = (P.T @ A @ P).tocsr()
            Ac.sum_duplicates()
            if FILTER_EPS > 0.0:
                Ac = _filter_galerkin(Ac, FILTER_EPS)

        rowsA = np.repeat(np.arange(n), np.diff(A.indptr))
        dist = np.abs(A.indices - rowsA)
        R_f, cut_f, split_f = plan_level(dist, n, sym=False)
        if first and fine_full:
            cut_f = int(dist.max()) if dist.size else 0
            R_f, split_f = pick_row_tile(cut_f, False), False
        use_sym = sym and _band_est(n, cut_f, R_f, False) > SYM_MIN_BYTES
        Astore = A
        upper_sel = diag_pos = None
        if use_sym:
            usel = np.nonzero(A.indices >= rowsA)[0]
            Astore = sp.triu(A, k=0, format="csr")
            upper_sel = usel
            diag_pos = Astore.indptr[:-1].astype(np.int64)
            dist_s = dist[usel]
            R_l, cut_l, split_l = plan_level(dist_s, n, sym=True)
            if first and fine_full:
                cut_l = int(dist_s.max()) if dist_s.size else 0
                R_l, split_l = pick_row_tile(cut_l, True), False
        else:
            dist_s = dist
            R_l, cut_l, split_l = R_f, cut_f, split_f

        # hard budget for coarse (preconditioner-internal) levels: a
        # planned band beyond the remaining budget, or beyond the
        # per-level cap, is truncated to the widest cut that fits
        truncated = False
        trunc_cap = 0
        if budget_bytes is not None and not first:
            remaining = min(max(budget_bytes - used, 0.0),
                            COARSE_LEVEL_MAX_BYTES)

            def _lvl_bytes(cut, R):
                est = _band_est(n, cut, R, use_sym)
                return est * (0.5 if est > 1e9 else 1.0)  # bf16 rule

            tail_b = 0.0
            if split_l:          # the planned sidecar's bytes count too
                tail_b = 12.0 * (2 if use_sym else 1) \
                    * int((dist_s > cut_l).sum())
            if _lvl_bytes(cut_l, R_l) + tail_b > remaining:
                R_l, cut_l = _cut_for_budget(
                    np.sort(dist_s), n,
                    max(remaining - SIDECAR_MAX * 12.0, 0.0), use_sym)
                split_l = True
                truncated = True
                mirror = 2 if use_sym else 1
                spare = remaining - _lvl_bytes(cut_l, R_l)
                trunc_cap = min(SIDECAR_MAX // mirror,
                                int(max(spare, 0.0) // (12 * mirror)))

        # a split level's ordering is partitioned: the NEXT level is
        # rebuilt in its own order (band_vcycle bridges with
        # cperm/ciperm); P keeps its pre-perm column space
        cperm_dev = ciperm_dev = None
        p1 = None
        ccoords = None
        ckey = None
        if coords is not None:
            pad = nc * AGG - n
            ccoords = np.pad(coords, ((0, pad), (0, 0)), mode="edge") \
                .reshape(nc, AGG, -1).mean(axis=1)
        if band_key is not None:
            pad = nc * AGG - n
            ckey = np.pad(band_key, (0, pad), mode="edge") \
                .reshape(nc, AGG).min(axis=1)
        if split_l:
            if ckey is not None:
                p1 = np.argsort(ckey, kind="stable")
            else:
                parts_c = pick_parts(nc, min_part=12_000)
                if ccoords is not None and parts_c > 1:
                    p1 = partition_order(Ac, ccoords, parts_c)
                else:
                    from scipy.sparse.csgraph import reverse_cuthill_mckee
                    p1 = np.asarray(reverse_cuthill_mckee(
                        Ac, symmetric_mode=True))
            Ac = Ac[p1][:, p1].tocsr()
            Ac.sum_duplicates()
            if ccoords is not None:
                ccoords = ccoords[p1]
            if ckey is not None:
                ckey = ckey[p1]
            if not plan_only:
                cperm_dev = torch.as_tensor(p1.astype(np.int64),
                                            device=device)
                ciperm_dev = torch.as_tensor(
                    np.argsort(p1).astype(np.int64), device=device)

        force_agg_P = False
        P_extra_budget = 0.0
        if first and bt_coarse_budget > 0.0:
            # two-grid: factor the coarse Galerkin matrix now, before the
            # fine band exists on the device. Candidates, strongest
            # first: smoothed-P Galerkin Ac re-RCM'd, Ac as ordered, then
            # the unsmoothed P0^T A P0 (which needs aggregation
            # transfers) re-RCM'd and as ordered
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            cands = []
            pc = np.asarray(reverse_cuthill_mckee(Ac, symmetric_mode=True))
            cands.append((Ac[pc][:, pc].tocsr(), pc, False))
            cands.append((Ac, None, False))
            A0c = (P0.T @ A @ P0).tocsr()
            if p1 is not None:
                A0c = A0c[p1][:, p1].tocsr()
            p0c = np.asarray(reverse_cuthill_mckee(A0c,
                                                   symmetric_mode=True))
            cands.append((A0c[p0c][:, p0c].tocsr(), p0c, True))
            cands.append((A0c, None, True))
            transient = (bt_transient_budget
                         if bt_transient_budget else bt_coarse_budget)
            for cand, cperm, needs_agg in cands:
                bsize = bt_mod.pick_block(bt_mod.bandwidth(cand))
                if bsize is None:
                    continue
                fb = bt_mod.factor_bytes(cand.shape[0], bsize)
                if fb > bt_coarse_budget or 2.0 * fb > transient:
                    continue
                cand.sum_duplicates()
                if plan_only:
                    bt_coarse = {"plan_bt_bytes": fb, "n": cand.shape[0],
                                 "block": bsize}
                else:
                    with phase("bt coarse factor"):
                        lay_c = bt_mod.pack_layout(cand, bsize)
                        factor = bt_mod.build_factor(
                            bt_mod.device_maps(lay_c, device), cand.data,
                            b=bsize, NB=lay_c.NB)
                    bt_coarse = bt_mod.BTCoarse(
                        factor, n=cand.shape[0],
                        perm=None if cperm is None else torch.as_tensor(
                            cperm.astype(np.int64), device=device),
                        iperm=None if cperm is None else torch.as_tensor(
                            np.argsort(cperm).astype(np.int64),
                            device=device))
                used += fb
                force_agg_P = needs_agg
                # what the factor leaves of its budget may hold the
                # smoothed-P band (bf16)
                P_extra_budget = bt_coarse_budget - fb
                break

        # out-of-band split: the far entries of a partitioned ordering
        # go to a COO sidecar so the window tracks the in-part bandwidth
        keep_sel = oob_src = None
        pack_target = Astore
        n_discard = 0
        if split_l:
            keep = dist_s <= cut_l
            pack_target, dropped = _split_csr(Astore, keep)
            keep_sel = np.nonzero(keep)[0]
            # sidecar entry cap: the truncation's byte-derived cap, and
            # COARSE_SIDECAR_MAX on every coarse level; only the largest
            # dropped couplings (by magnitude) ride the sidecar, the rest
            # are discarded -- legal for preconditioner-internal levels
            cap = trunc_cap if truncated else None
            if not first:
                cap = COARSE_SIDECAR_MAX if cap is None \
                    else min(cap, COARSE_SIDECAR_MAX)
            if cap is not None and dropped.size > cap:
                n_discard = int(dropped.size - cap)
                if cap == 0:
                    dropped = dropped[:0]
                else:
                    mag = np.abs(np.asarray(Astore.data)[dropped])
                    sel = np.argpartition(
                        mag, dropped.size - cap)[dropped.size - cap:]
                    dropped = dropped[np.sort(sel)]
            rows_store = np.repeat(np.arange(n), np.diff(Astore.indptr))
            r_oob = rows_store[dropped]
            c_oob = Astore.indices[dropped]
            if use_sym:
                # mirror the dropped triu entries (the diagonal has
                # distance 0 and is never dropped)
                rows_full = np.concatenate([r_oob, c_oob])
                cols_full = np.concatenate([c_oob, r_oob])
                oob_src = np.concatenate([dropped, dropped])
            else:
                rows_full, cols_full, oob_src = r_oob, c_oob, dropped
        layA = pack_band_layout(pack_target, R_l, R_l)
        if first:
            fine_layout = FineLayout(*layA, upper_sel=upper_sel,
                                     diag_pos=diag_pos,
                                     keep_sel=keep_sel, oob_src=oob_src)

        # storage: the fine operator stays f32 unless overridden; large
        # coarse (preconditioner-internal) levels store bf16 only
        lvl_dtype = fine_dtype if fine_dtype is not None else dtype
        A_dtype = lvl_dtype if first else (
            torch.bfloat16 if layA[4] * layA[5] * layA[6] * 4 > 1e9
            else dtype)
        if first:
            Adata_all = At.data[upper_sel] if use_sym else At.data
        else:
            Adata_all = Astore.data
        Adata = Adata_all if keep_sel is None else Adata_all[keep_sel]
        NT_l, R_b, W_l = layA[4], layA[5], layA[6]
        bytes_A = float(NT_l) * R_b * W_l \
            * (2 if A_dtype == torch.bfloat16 else 4)
        used += bytes_A
        if oob_src is not None:
            used += oob_src.size * 12.0
        cch_p = max(R_l // AGG, 8)
        # the smoothed prolongator inherits A's cross-part outliers
        # (scaled diagonal distance |i - AGG j|): split them the same way
        rowsP = np.repeat(np.arange(n), np.diff(P.indptr))
        distP = np.abs(rowsP - P.indices.astype(np.int64) * AGG)
        cutP = cut_l + 2 * AGG
        Pstore = P
        pdropped = None
        p_drop = distP > cutP
        ndropP = int(p_drop.sum())
        if ndropP and ndropP <= max(0.01 * P.nnz, 32768):
            Pstore, pdropped = _split_csr(P, ~p_drop)
        layP = pack_band_layout(Pstore, R_l, cch_p)
        bytes_P = float(layP[4]) * layP[5] * layP[6] * 2
        p_side = 0.0 if pdropped is None else pdropped.size * 12.0
        use_P = (not force_agg_P
                 and bytes_P <= max(P_MAX_BYTES, P_extra_budget)
                 and (budget_bytes is None
                      or used + bytes_P + p_side <= budget_bytes))
        if use_P:
            used += bytes_P + p_side
        abf_bytes = 0.0
        use_abf = (A_dtype != torch.bfloat16
                   and BF16_SMOOTH_MIN < bytes_A <= BF16_SMOOTH_MAX
                   and (fine_abf or not first))
        if use_abf:
            abf_bytes = bytes_A / 2.0
            use_abf = (budget_bytes is None
                       or used + abf_bytes <= budget_bytes)
        if use_abf:
            used += abf_bytes
        if plan_only:
            report.append({
                "level": len(report), "n": n, "R": R_l, "cut": int(cut_l),
                "NT": NT_l, "W": W_l, "sym": bool(use_sym),
                "dtype": ("bf16" if A_dtype == torch.bfloat16 else "f32"),
                "bytes_A": bytes_A,
                "bytes_P": bytes_P if use_P else 0.0,
                "bytes_Abf": abf_bytes if use_abf else 0.0,
                "split": bool(split_l),
                "truncated": bool(truncated), "discarded": n_discard,
                "sidecar": 0 if oob_src is None else int(oob_src.size)})
        else:
            Adev = fill_band_device(layA, Adata, R_l, A_dtype, device)
            bts = None
            if (coarse_bt_smooth and not first and not use_sym
                    and oob_src is not None):
                bs_c = bt_mod.pick_block(int(cut_l))
                fb_c = (0 if bs_c is None
                        else bt_mod.factor_bytes(n, bs_c, 2))
                if (bs_c is not None and 0 < fb_c <= 1.6e9
                        and (budget_bytes is None
                             or used + fb_c <= budget_bytes)):
                    with phase("bt coarse smoother"):
                        lay_c2 = bt_mod.pack_layout(pack_target, bs_c)
                        bts = bt_mod.build_factor(
                            bt_mod.device_maps(lay_c2, device),
                            pack_target.data, b=bs_c, NB=lay_c2.NB,
                            store_dtype=torch.bfloat16)
                    used += fb_c
            levels.append(BandLevel(
                A=Adev,
                invd=torch.as_tensor(invd, dtype=dtype, device=device),
                omega=torch.tensor(omega, dtype=dtype, device=device),
                P=(fill_band_device(layP, Pstore.data, cch_p,
                                    torch.bfloat16, device)
                   if use_P else None),
                Abf=(BandMatrix(dense=Adev.dense.to(torch.bfloat16),
                                shift0=Adev.shift0, cchunk=Adev.cchunk,
                                ncols=Adev.ncols) if use_abf else None),
                dvec=(torch.as_tensor(np.asarray(A.diagonal(), np.float32),
                                      device=device) if use_sym else None),
                oob=(_sidecar(rows_full, cols_full, Adata_all[oob_src],
                              device) if oob_src is not None else None),
                P_oob=(_sidecar(rowsP[pdropped], P.indices[pdropped],
                                P.data[pdropped], device)
                       if use_P and pdropped is not None else None),
                bts=bts, cperm=cperm_dev, ciperm=ciperm_dev))
        A = Ac
        coords = ccoords
        band_key = ckey
        first = False
        if bt_coarse is not None:
            break

    if plan_only:
        report.append({"total_bytes": used,
                       "bt_coarse": (bt_coarse or {}),
                       "budget": budget_bytes})
        return report, None
    cinv = None
    if bt_coarse is None:
        cinv = torch.as_tensor(
            scaled_inv(A.toarray().astype(np.float64)).astype(np.float32),
            dtype=dtype, device=device)
    return (BandAMG(levels=tuple(levels), n=At.shape[0], coarse_inv=cinv,
                    bt_coarse=bt_coarse), fine_layout)


def update_fine_values(amg: BandAMG, fine_layout: FineLayout, data,
                       idx_dev=None) -> BandAMG:
    """New fine-level matrix values (same pattern), written IN PLACE:
    the band by an ``index_put_`` (no multi-GB transient), its bf16
    copy, the triu level's diagonal and the sidecar values; the coarse
    hierarchy stays frozen. ``data`` is the permuted CSR data of the
    full operator. Returns ``amg`` itself."""
    lay = fine_layout
    lv0 = amg.levels[0]
    dense = lv0.A.dense
    if lay.upper_sel is not None:
        data = np.ascontiguousarray(data[lay.upper_sel])
    band_data = data if lay.keep_sel is None else data[lay.keep_sel]
    if idx_dev is None:
        idx_dev = fine_slot_index(lay, dense.device)
    vals = torch.as_tensor(np.asarray(band_data, np.float32),
                           device=dense.device)
    dense.view(lay.NT * lay.R, lay.W).index_put_(idx_dev, vals.to(dense.dtype))
    if lv0.Abf is not None:
        lv0.Abf.dense.copy_(dense)
    if lv0.dvec is not None:
        lv0.dvec.copy_(torch.as_tensor(
            np.asarray(data[lay.diag_pos], np.float32)))
    if lv0.oob is not None:
        lv0.oob.vals.copy_(torch.as_tensor(
            np.asarray(data[lay.oob_src], np.float32)))
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
#: end a pass whose recurrence has drifted from a true residual that no
#: longer improves (the pass's f32 floor). The JAX package has no such
#: exit: its passes restart there until their iteration cap
FLOOR_EXIT = True


def _chunked_pcg(op, prec, invd, b, tol, x0, max_iter,
                 stall_window: int, check_every: int = CG_CHECK_EVERY,
                 engine: str = "band"):
    """Preconditioned CG with drift-guarded chunks (the JAX package's
    band._chunked_pcg, plus one exit).

    Runs up to ``check_every`` recurrence iterations, then recomputes
    the true residual b - A x. The pass ends when the TRUE metric
    reaches ``tol``, or when the true metric stagnates across checks
    while the recurrence has reached ``tol`` or drifted from it (the
    f32 floor; the JAX package ends only on the first), or on the
    iteration/stall limits. When the recurrence claims a much better
    norm than the truth (or has converged while the truth has not) the
    recurrence restarts from the fresh residual. Returns
    ``(x, true relative metric, iterations)`` as host numbers for the
    last two.

    The JAX ``while_loop`` becomes a host loop over device tensors: each
    chunk's recurrence iterations run through ``loop.masked_loop`` (an
    iteration past the stopping point is masked: its step scale is
    zero, so x, r, p and the counters do not move, which keeps the
    result identical to the early exit), counted under ``engine``. The
    host reads the chunk-end check with one blocking copy."""
    dev = b.device
    f32 = torch.float32
    x0 = x0.to(f32)
    tol = torch.as_tensor(tol, dtype=f32, device=dev)
    res0 = torch.dot(invd * b, b)
    res0 = torch.where(res0 == 0.0, torch.ones_like(res0), res0)

    r = b - op(x0)
    z = prec(r)
    res = torch.dot(z, r)
    st = dict(x=x0.clone(), r=r, p=z, res=res, stop=torch.dot(invd * r, r),
              it=torch.zeros((), dtype=torch.int32, device=dev),
              best=res.abs(),
              since=torch.zeros((), dtype=torch.int32, device=dev))
    stop_prev = torch.full((), float("inf"), dtype=f32, device=dev)

    def running():
        return ((torch.sqrt(st["stop"].abs() / res0) > tol)
                & (st["it"] < max_iter) & (st["since"] < stall_window))

    def step(active):
        res, p = st["res"], st["p"]
        u = op(p)
        delta = torch.where(active, res / torch.dot(p, u),
                            torch.zeros_like(res))
        st["x"] = st["x"] + delta * p
        r = st["r"] = st["r"] - delta * u
        z = prec(r)
        res_new = torch.dot(z, r)
        st["stop"] = torch.where(active, torch.dot(invd * r, r), st["stop"])
        st["p"] = torch.where(active, z + (res_new / res) * p, p)
        improved = active & (res_new.abs() < 0.99 * st["best"])
        st["best"] = torch.where(improved, res_new.abs(), st["best"])
        st["since"] = torch.where(active & ~improved, st["since"] + 1,
                                  torch.where(improved, 0, st["since"]))
        st["res"] = torch.where(active, res_new, res)
        st["it"] = st["it"] + active.to(torch.int32)

    launched, starts = 0, 1
    while True:
        launched += loop.masked_loop(running, step, engine, check_every)
        stop, it, since = st["stop"], st["it"], st["since"]
        rec_ok = torch.sqrt(stop.abs() / res0) <= tol
        rt = b - op(st["x"])
        stop_t = torch.dot(invd * rt, rt)
        true_ok = torch.sqrt(stop_t / res0) <= tol
        stagnant = stop_t > 0.25 * stop_prev
        drift = stop_t > 2.25 * stop.abs()
        # the pass also ends when the recurrence has drifted from a truth
        # that no longer improves: the f32 floor of this pass, which a
        # restart inside the pass cannot pass (on an H100 at 4.47M nodes
        # the first pass restarted until its 2500-iteration cap), while
        # the host's f64 restart contracts it at once
        floor = drift & stagnant if FLOOR_EXIT else torch.zeros_like(drift)
        done = (true_ok | (rec_ok & stagnant) | floor
                | (it >= max_iter) | (since >= stall_window))
        restart = ~done & (drift | rec_ok)
        stop_prev = stop_t
        flags_h = torch.stack([done, restart]).cpu()
        if bool(flags_h[0]):
            break
        if bool(flags_h[1]):
            # the whole carried stopping state resets to the truth; the
            # next chunk's window starts from it
            st["r"] = rt
            st["p"] = prec(rt)
            st["res"] = torch.dot(st["p"], rt)
            st["stop"] = stop_t
            st["best"] = st["res"].abs()
            st["since"] = torch.zeros_like(since)
            starts += 1
    n_it = int(st["it"])
    loop.tally(engine, launched, n_it, starts)
    return st["x"], float(torch.sqrt(stop_t / res0)), n_it


#: Chebyshev smoothing degree for the band V-cycle; degree 1 is plain
#: damped Jacobi (the JAX package's default)
CHEBY_DEGREE = 1


def _cheby_smooth(lv: BandLevel, As: BandMatrix, r: torch.Tensor):
    """Smoother application for A z = r from z = 0: damped Jacobi at
    degree 1, else degree-CHEBY_DEGREE Jacobi-preconditioned Chebyshev
    on [lmax/4, 1.1 lmax] (``lv.omega`` = 2*JACOBI_OMEGA/lmax)."""
    if CHEBY_DEGREE <= 1:
        return lv.omega * lv.invd * r
    lam = 2.0 * JACOBI_OMEGA / lv.omega
    lmax = 1.1 * lam
    lmin = 0.25 * lam
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    z = lv.invd * r / theta
    d = z
    for _ in range(CHEBY_DEGREE - 1):
        rk = r - band_apply(As, lv.dvec, z, lv.oob)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (lv.invd * rk)
        z = z + d
        rho = rho_new
    return z


def band_vcycle(amg: BandAMG, r: torch.Tensor, bt=None) -> torch.Tensor:
    """Symmetric V-cycle with pre/post smoothing, all dense-band
    products. Grid transfers use the smoothed prolongator: its bf16 band
    where the level stores one, else applied matrix-free from the level
    operator (two extra level products per visit). ``bt`` (optional): a block-tridiagonal factor of the FINE
    level's kept (in-band) entries, used as the level-0 smoother in
    place of damped Jacobi: for a partitioned ordering the kept band is
    block-diagonal over the parts, so this smoother solves every part
    exactly while the coarse levels supply the cross-part correction --
    a two-level domain-decomposition preconditioner."""
    from .blocktri import bt_apply, bt_coarse_apply
    L = len(amg.levels)

    def smooth(lv, As, r, l):
        if l == 0 and bt is not None:
            return bt_apply(bt, r)
        if lv.bts is not None:
            return bt_apply(lv.bts, r)
        return _cheby_smooth(lv, As, r)

    def cycle(l, r):
        if l == L:
            if amg.bt_coarse is not None:
                return bt_coarse_apply(amg.bt_coarse, r)
            with kernels.fp32_matmul():
                return amg.coarse_inv @ r
        lv = amg.levels[l]
        # the bf16 copy serves cheap Jacobi residuals; next to an exact
        # fine smoother its rounding error would dominate the coarse
        # correction, so block-tridiagonal smoothing pairs with f32
        As = lv.Abf if lv.Abf is not None \
            and not (l == 0 and bt is not None) else lv.A
        z = smooth(lv, As, r, l)
        d = r - band_apply(As, lv.dvec, z, lv.oob)
        rc_len = (amg.levels[l + 1].A.ncols if l + 1 < L
                  else (amg.coarse_inv.shape[0] if amg.bt_coarse is None
                        else amg.bt_coarse.n))
        if lv.P is not None:
            rc = band_rmatvec(lv.P, d)[:rc_len]
            if lv.P_oob is not None:
                rc = rc.index_add(0, lv.P_oob.cols,
                                  lv.P_oob.vals * d[lv.P_oob.rows])
        else:
            # the smoothed prolongator P = (I - omega D^-1 A) P0 whose
            # band was not stored, applied matrix-free: P^T d =
            # P0^T (d - A (omega D^-1 d)), P0 the aggregation (segment
            # sum). The coarse matrix is P^T A P, so the transfers must
            # be P's: the JAX package's plain aggregation transfers here
            # do not match it, and its CG stalls at 4.47M nodes
            d = d - band_apply(lv.A, lv.dvec, lv.omega * lv.invd * d,
                               lv.oob)
            pad = rc_len * AGG - d.shape[0]
            rc = torch.nn.functional.pad(d, (0, pad)).view(rc_len, AGG) \
                .sum(dim=1)
        if lv.cperm is not None:
            rc = rc[lv.cperm]
        zc = cycle(l + 1, rc)
        if lv.cperm is not None:
            zc = zc[lv.ciperm]
        if lv.P is not None:
            z = z + band_matvec(lv.P, zc)[:r.shape[0]]
            if lv.P_oob is not None:
                z = z.index_add(0, lv.P_oob.rows,
                                lv.P_oob.vals * zc[lv.P_oob.cols])
        else:
            zf = zc.repeat_interleave(AGG)[:r.shape[0]]
            z = z + zf - lv.omega * lv.invd * band_apply(lv.A, lv.dvec, zf,
                                                         lv.oob)
        # post-smooth with the same smoother (a symmetric preconditioner)
        z = z + smooth(lv, As, r - band_apply(As, lv.dvec, z, lv.oob), l)
        return z

    return cycle(0, r)


def band_pcg(amg: BandAMG, b: torch.Tensor, tol, x0: torch.Tensor,
             max_iter: int, stall_window: int = 120, bt=None):
    """CG on the fine band operator preconditioned by the band V-cycle,
    stopping on the Jacobi-weighted residual (the host refinement
    driver's metric), drift-guarded in chunks (``_chunked_pcg``). ``bt``
    upgrades the V-cycle's fine smoother to the in-part block-
    tridiagonal solve. Returns (x, true metric, iterations)."""
    lv0 = amg.levels[0]

    def op(x):
        return band_apply(lv0.A, lv0.dvec, x, lv0.oob)

    def prec(r):
        return band_vcycle(amg, r, bt=bt)

    return _chunked_pcg(op, prec, lv0.invd, b, tol, x0, max_iter,
                        stall_window, engine="band")


def band_fgmres(amg: BandAMG, b: torch.Tensor, m: int = 16):
    """One GMRES(m) cycle, right-preconditioned by the band V-cycle.

    The bf16 fine operator perturbs A by ~4e-3 of its norm -- more than
    the smallest eigenvalues of an ill-conditioned FEM system, so the
    perturbed operator is effectively indefinite and CG diverges (three-
    term recurrences have no residual-minimization safety net). GMRES
    minimizes the residual of the perturbed system, contracting until
    the bf16 floor; the mixed-precision refinement driver then restarts
    it from the true f64 residual, exactly as it restarts CG passes.

    The Arnoldi basis (two-pass classical Gram-Schmidt) runs in true
    fp32 products, TF32 off: reduced-precision passes corrupt H so that
    it stops describing the Krylov space. The (m+1) x m least-squares
    problem is solved on the host in f64 by numpy's SVD-based routine
    (gelsd), with the JAX package's cutoff (f32 eps times m+1): like its
    ``jnp.linalg.lstsq`` it tolerates a rank-deficient H after a
    breakdown (a zero new basis norm), which the card's QR-based
    ``torch.linalg.lstsq`` does not. One blocking copy of H per cycle.
    Returns ``(x, relative least-squares residual, m)``."""
    lv0 = amg.levels[0]
    n = b.shape[0]
    dev = b.device

    def op(x):
        return band_apply(lv0.A, lv0.dvec, x, lv0.oob)

    beta = torch.linalg.vector_norm(b)
    bsafe = torch.clamp_min(beta, 1e-30)
    V = torch.zeros((m + 1, n), dtype=torch.float32, device=dev)
    V[0] = b / bsafe
    Z = torch.zeros((m, n), dtype=torch.float32, device=dev)
    H = torch.zeros((m + 1, m), dtype=torch.float32, device=dev)
    with kernels.fp32_matmul():
        for j in range(m):
            z = band_vcycle(amg, V[j])
            w = op(z)
            # classical Gram-Schmidt, two passes, over the j+1 basis
            # vectors built so far (the JAX package masks the zero rows)
            Vj = V[:j + 1]
            h1 = Vj @ w
            w = w - h1 @ Vj
            h2 = Vj @ w
            w = w - h2 @ Vj
            wn = torch.linalg.vector_norm(w)
            V[j + 1] = w / torch.clamp_min(wn, 1e-30)
            Z[j] = z
            H[:j + 1, j] = h1 + h2
            H[j + 1, j] = wn
    Hh = H.double().cpu().numpy()
    beta_h = float(beta)
    e1 = np.zeros(m + 1)
    e1[0] = beta_h
    y, _res, _rank, _sv = np.linalg.lstsq(
        Hh, e1, rcond=float(np.finfo(np.float32).eps) * (m + 1))
    with kernels.fp32_matmul():
        x = torch.as_tensor(y, dtype=torch.float32, device=dev) @ Z
    rel = float(np.linalg.norm(e1 - Hh @ y) / max(beta_h, 1e-30))
    return x, rel, m


# ---------------------------------------------------------------------- #
# complex-symmetric (AC) solvers on (re, im) pairs                        #
# ---------------------------------------------------------------------- #

def _complex_op(Aop: BandMatrix, Ai: BandMatrix, n: int):
    """(Ar + i Ai)(xr + i xi) as two two-column K1 products on the real
    bands (one launch and one stream of each band): P = Ar [xr, xi],
    Q = Ai [xr, xi], yr = P[:, 0] - Q[:, 1], yi = P[:, 1] + Q[:, 0]. On
    the card this is bitwise the four one-column products of the JAX
    package's apply (a two-column column is the one-column product)."""
    def opc(xr, xi):
        X = torch.stack([xr, xi], dim=1)
        P = band_matvec(Aop, X)[:n]
        Q = band_matvec(Ai, X)[:n]
        return P[:, 0] - Q[:, 1], P[:, 1] + Q[:, 0]
    return opc


def band_csym_fgmres(amg: BandAMG, Aop: BandMatrix, Ai: BandMatrix,
                     br, bi, m: int = 24, bt=None):
    """One complex GMRES(m) cycle for (Ar + i Ai) x = b, right-
    preconditioned by the shifted-real band-AMG V-cycle, on float32
    (re, im) pairs. GMRES minimizes the residual monotonically, which
    the complex-symmetric CG recurrence does not guarantee. ``bt``
    (optional): a block-tridiagonal factor of the SAME shifted real
    matrix, a much stronger preconditioner, applied to re and im
    separately (one ``bt_fwd`` and one ``bt_qbwd`` launch each).

    The Arnoldi basis (Hermitian two-pass classical Gram-Schmidt) runs
    in true fp32 products, TF32 off, as ``band_fgmres``. The (m+1) x m
    Hessenberg least-squares problem is copied to the host (one blocking
    read per cycle) and solved in complex128 by numpy's SVD-based gelsd
    with the JAX package's cutoff (f32 eps times m+1), so a rank-
    deficient H after a breakdown is tolerated; the JAX package keeps it
    on the device only because its TPU could not transfer complex
    buffers. Returns ``(xr, xi, relative least-squares residual, m)``."""
    from .blocktri import bt_apply

    n = br.shape[0]
    dev = br.device
    opc = _complex_op(Aop, Ai, n)
    beta = torch.sqrt(torch.sum(br * br + bi * bi))
    bsafe = torch.clamp_min(beta, 1e-30)
    Vr = torch.zeros((m + 1, n), dtype=torch.float32, device=dev)
    Vi = torch.zeros((m + 1, n), dtype=torch.float32, device=dev)
    Vr[0] = br / bsafe
    Vi[0] = bi / bsafe
    Zr = torch.zeros((m, n), dtype=torch.float32, device=dev)
    Zi = torch.zeros((m, n), dtype=torch.float32, device=dev)
    Hr = torch.zeros((m + 1, m), dtype=torch.float32, device=dev)
    Hi = torch.zeros((m + 1, m), dtype=torch.float32, device=dev)
    with kernels.fp32_matmul():
        for j in range(m):
            if bt is None:
                zr = band_vcycle(amg, Vr[j])
                zi = band_vcycle(amg, Vi[j])
            else:
                zr = bt_apply(bt, Vr[j])
                zi = bt_apply(bt, Vi[j])
            wr, wi = opc(zr, zi)
            # Hermitian <v, w> = sum(conj(v) w) over the j+1 basis
            # vectors built so far (the JAX package masks the zero rows)
            Pr, Pi = Vr[:j + 1], Vi[:j + 1]
            h1r = Pr @ wr + Pi @ wi
            h1i = Pr @ wi - Pi @ wr
            wr = wr - (h1r @ Pr - h1i @ Pi)
            wi = wi - (h1r @ Pi + h1i @ Pr)
            h2r = Pr @ wr + Pi @ wi
            h2i = Pr @ wi - Pi @ wr
            wr = wr - (h2r @ Pr - h2i @ Pi)
            wi = wi - (h2r @ Pi + h2i @ Pr)
            wn = torch.sqrt(torch.sum(wr * wr + wi * wi))
            wsafe = torch.clamp_min(wn, 1e-30)
            Vr[j + 1] = wr / wsafe
            Vi[j + 1] = wi / wsafe
            Zr[j] = zr
            Zi[j] = zi
            Hr[:j + 1, j] = h1r + h2r
            Hi[:j + 1, j] = h1i + h2i
            Hr[j + 1, j] = wn
    Hh = torch.stack([Hr, Hi]).double().cpu().numpy()
    H = Hh[0] + 1j * Hh[1]
    beta_h = float(beta)
    e1 = np.zeros(m + 1, np.complex128)
    e1[0] = beta_h
    y, _res, _rank, _sv = np.linalg.lstsq(
        H, e1, rcond=float(np.finfo(np.float32).eps) * (m + 1))
    yr = torch.as_tensor(y.real, dtype=torch.float32, device=dev)
    yi = torch.as_tensor(y.imag, dtype=torch.float32, device=dev)
    with kernels.fp32_matmul():
        xr = yr @ Zr - yi @ Zi
        xi = yr @ Zi + yi @ Zr
    rel = float(np.linalg.norm(e1 - H @ y) / max(beta_h, 1e-30))
    return xr, xi, rel, m


def band_csym_fgmres_fused(amg: BandAMG, Aop: BandMatrix, Ai: BandMatrix,
                           br, bi, tol, m: int = 24, cycles: int = 8,
                           bt=None):
    """Restarted GMRES(m) for (Ar + i Ai) x = b: up to ``cycles`` cycles
    (``band_csym_fgmres``), each restarted from the TRUE f32 residual
    recomputed on the device, ending once the relative l2 residual is at
    most ``tol``. The JAX package runs the cycles in one device
    ``while_loop``; here the host loops, with one blocking read of the
    residual per cycle. Each cycle applies the complex operator m + 1
    times (2(m + 1) K1 launches): the residual a cycle ends with is the
    next cycle's start, where the JAX loop recomputes it from the same
    x (bitwise the same inputs). The driver still measures the f64
    contract metric on the host afterwards. Returns ``(xr, xi, relative
    l2 residual, iterations)``."""
    n = br.shape[0]
    opc = _complex_op(Aop, Ai, n)
    b2 = max(float(torch.sum(br * br + bi * bi)), 1e-30)
    xr = torch.zeros_like(br)
    xi = torch.zeros_like(bi)
    rr, ri = br, bi
    rn = float("inf")
    its = 0
    for _ in range(cycles):
        if not rn > tol:
            break
        dr, di, _rel, it = band_csym_fgmres(amg, Aop, Ai, rr, ri, m=m, bt=bt)
        xr = xr + dr
        xi = xi + di
        ar, ai = opc(xr, xi)
        rr, ri = br - ar, bi - ai
        rn = float(torch.sqrt(torch.sum(rr * rr + ri * ri) / b2))
        its += it
    return xr, xi, rn, its
