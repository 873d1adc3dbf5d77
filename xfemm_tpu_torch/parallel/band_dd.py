"""Sharded dense-band engine: the domain decomposition's fast path (the
JAX package's ``parallel/band_dd.py``).

The first-generation path (``halo.py``'s element-block product with the
``schwarz.py`` AMG) scales correctness, not throughput. This module
splits the band engine itself:

* DOFs are split into ``ndev`` coordinate parts (recursive bisection),
  each part is reverse-Cuthill-McKee ordered, and every part's in-part
  matrix is packed as a dense band with ONE common (NT, R, W, shift0)
  geometry: a (P, NT, R, W) tensor whose part p is streamed by the band
  kernel K1 (``band.band_matvec``, ops/csrc/band_mv.cu) as ``dense[p]``.
* Cross-part couplings (a ~1% fringe on 2-D meshes) live in a padded
  per-part COO sidecar applied against the all-gathered vector
  (``comm.all_gather``), one ``index_add_`` for all parts.
* The preconditioner is additive Schwarz with EXACT local solves: each
  part's band is factored block-tridiagonally (``blocktri``) and applied
  by the sweep kernels K2 and K3+K4 (``blocktri.bt_apply``).

The host structure is the JAX package's, bit for bit, and every process
computes all of it. The device tensors hold the parts of the
communicator's process (``comm.local``): all P parts under the stacked
communicator, whose K1 and sweep launches run one after another on the
current stream (the sweeps are cooperative persistent launches that
each want every SM of the card), or the rank's own part under a process
group (``comm.GroupComm``), on its own card. The CG is f32 (as the JAX
package's), a masked host loop (``solver._masked_loop``; masked
iterations in ``solver.MASKED["dd-band"]``) inside the driver's f64
refinement.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse import csgraph

from ..ops import blocktri
from ..ops import solver as solver_mod
from ..ops.band import BandMatrix, band_matvec
from ..ops.blocktri import BTFactor
from .comm import STACKED

CCHUNK = 128
ROW_TILE = 128


class BandDDState(NamedTuple):
    """Host maps and device tensors of a sharded band system (its
    pattern frozen; values refresh per solve). The host maps cover all
    ``ndev`` parts; the device tensors and the factor maps cover the
    ``nl`` parts ``lo .. lo+nl-1`` that this process holds."""
    ndev: int
    n: int                    # logical (reduced) dimension
    nloc: int                 # padded per-part size (multiple of b)
    perm: np.ndarray          # global permuted order (part-major)
    iperm: np.ndarray
    part_of: np.ndarray       # (n,) part of each PERMUTED position
    loc_of: np.ndarray        # (n,) local slot of each permuted position
    # band geometry (common across parts)
    shift0: int
    W: int
    NT: int
    # device fill maps (flattened over all in-part entries)
    fill_pos: torch.Tensor    # flat position into (nl*NT*R*W)
    fill_sel: torch.Tensor    # source position in Ap.data
    pad_pos: torch.Tensor     # unit-diagonal band slots for padding rows
    # sidecar (padded per part): (nl, M)
    oob_rows: torch.Tensor
    oob_cols: torch.Tensor    # global padded index part*nloc + loc
    oob_sel: torch.Tensor     # source in Ap.data (0 for padding)
    oob_w: torch.Tensor       # 1.0 real, 0.0 padding
    # block-tridiagonal factor structure per part
    b: int
    NB: int
    bt_maps: list             # per local part BTDeviceMaps
    bt_lsel: list             # per local part Ap.data positions (-1 -> 1.0)
    # CSR entry map At order -> Ap order
    data_map: np.ndarray
    Ap_pattern: object        # Ap with pattern only (indices/indptr)
    lo: int                   # global index of the first local part
    nl: int                   # local parts
    comm: object              # the parts' communicator (``comm.py``)


def _rcb_parts(coords: np.ndarray, ndev: int) -> np.ndarray:
    """Recursive coordinate bisection into ndev equal parts (ndev is a
    power of two for clean halving; others fall back to slab split)."""
    n = coords.shape[0]
    part = np.zeros(n, np.int64)
    if ndev & (ndev - 1):
        order = np.argsort(coords[:, 0], kind="stable")
        for d, ids in enumerate(np.array_split(order, ndev)):
            part[ids] = d
        return part

    def rec(ids, lo, k):
        if k == 1:
            part[ids] = lo
            return
        c = coords[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = ids[np.argsort(c[:, axis], kind="stable")]
        half = order.size // 2
        rec(order[:half], lo, k // 2)
        rec(order[half:], lo + k // 2, k // 2)

    rec(np.arange(n), 0, ndev)
    return part


def setup_band_dd(At: sp.csr_matrix, coords: np.ndarray, ndev: int,
                  device="cpu", comm=STACKED) -> "BandDDState | None":
    """Build the sharded band structure from the (Dirichlet-eliminated)
    assembled CSR, the maps of ``comm``'s parts as tensors on
    ``device``. Returns None when ineligible (a part's bandwidth exceeds
    the largest block size). The host arrays are the JAX package's, bit
    for bit."""
    n = At.shape[0]
    local = comm.local(np.arange(ndev))
    p0, nl = int(local[0]), len(local)
    part = _rcb_parts(np.asarray(coords, np.float64), ndev)

    # per-part RCM, part-major global permutation
    perm_parts = []
    for p in range(ndev):
        ids = np.nonzero(part == p)[0]
        sub = At[ids][:, ids]
        r = csgraph.reverse_cuthill_mckee(sub, symmetric_mode=True)
        perm_parts.append(ids[r])
    sizes = np.array([len(x) for x in perm_parts])
    perm = np.concatenate(perm_parts)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(n)
    offs = np.concatenate([[0], np.cumsum(sizes)])

    Ap = At[perm][:, perm].tocsr()
    Ap.sum_duplicates()

    rows = np.repeat(np.arange(n), np.diff(Ap.indptr)).astype(np.int64)
    cols = Ap.indices.astype(np.int64)
    rpart = np.searchsorted(offs, rows, side="right") - 1
    cpart = np.searchsorted(offs, cols, side="right") - 1
    rloc_g = rows - offs[rpart]
    cloc_g = cols - offs[cpart]
    inpart = rpart == cpart

    # common block size from the max in-part bandwidth
    bw = int(np.abs(rloc_g[inpart] - cloc_g[inpart]).max()) if \
        inpart.any() else 0
    b = blocktri.pick_block(bw)
    if b is None:
        return None
    nloc = int(-(-sizes.max() // b) * b)
    NT = nloc // ROW_TILE

    # ---- unified band geometry over parts ---------------------------
    tile = rloc_g // ROW_TILE
    lo = np.full((ndev, NT), 2 ** 62, np.int64)
    hi = np.full((ndev, NT), -1, np.int64)
    ti = tile[inpart]
    pi = rpart[inpart]
    np.minimum.at(lo, (pi, ti), cloc_g[inpart])
    np.maximum.at(hi, (pi, ti), cloc_g[inpart])
    # empty tiles (padding region of smaller parts) must follow the
    # band diagonal, NOT column 0: lo=0 at tile t gives shift=-t, and a
    # single empty trailing tile then drags shift0 to -NT and the
    # unified window W to the full matrix width (a 50k-wide 20 GB
    # "band" at 100k DOF / 2 parts)
    empty = hi < 0
    tdiag = np.broadcast_to(np.arange(NT)[None, :] * CCHUNK, hi.shape)
    lo[empty] = tdiag[empty]
    hi[empty] = tdiag[empty]
    shift = lo // CCHUNK - np.arange(NT)[None, :]
    shift0 = int(shift.min())
    K = int((hi // CCHUNK - (np.arange(NT)[None, :] + shift0)).max()) + 1
    K = max(K, 1)
    W = K * CCHUNK

    # padding rows' unit diagonals must stay inside the window
    # (wloc = r - (tile+shift0)*cchunk for col == row)
    # r in [0, nloc): wloc = r - (r//R + shift0)*cchunk
    padr = np.concatenate([np.arange(sizes[p], nloc) for p in
                           range(ndev)]) if (sizes < nloc).any() else \
        np.zeros(0, np.int64)
    padp = np.concatenate([np.full(nloc - sizes[p], p, np.int64)
                           for p in range(ndev)]) if padr.size else \
        np.zeros(0, np.int64)
    wl_pad = padr - (padr // ROW_TILE + shift0) * CCHUNK
    while padr.size and (wl_pad.min() < 0 or wl_pad.max() >= W):
        if wl_pad.min() < 0:
            shift0 -= 1
        K += 1
        W = K * CCHUNK
        wl_pad = padr - (padr // ROW_TILE + shift0) * CCHUNK

    wloc = cloc_g - (tile + shift0) * CCHUNK
    ok = inpart & (wloc >= 0) & (wloc < W)
    if not bool(ok[inpart].all()):
        return None   # geometry failed to unify (pathological part)
    rr = rloc_g - tile * ROW_TILE
    fill_pos = (((rpart[inpart] * NT + tile[inpart]) * ROW_TILE
                 + rr[inpart]) * W + wloc[inpart])
    fill_sel = np.nonzero(inpart)[0]
    pad_pos = (((padp * NT + padr // ROW_TILE) * ROW_TILE
                + padr % ROW_TILE) * W + wl_pad)
    # the local parts' slots, offset to the first local part's band
    mine = (rpart[inpart] >= p0) & (rpart[inpart] < p0 + nl)
    off = p0 * NT * ROW_TILE * W
    fill_pos, fill_sel = fill_pos[mine] - off, fill_sel[mine]
    pad_pos = pad_pos[(padp >= p0) & (padp < p0 + nl)] - off

    # K1 streams part p's band as dense[p] of the (P, NT, R, W) tensor:
    # its rows (and so every part's offset) must be 16-byte multiples
    if (W * 4) % 16:
        raise ValueError(f"band_dd: window {W} gives rows that are not "
                         "16-byte multiples")

    # ---- sidecar ------------------------------------------------------
    osel = np.nonzero(~inpart)[0]
    orows = rloc_g[osel]
    ocols = cpart[osel] * nloc + cloc_g[osel]
    opart = rpart[osel]
    M = max(int(np.bincount(opart, minlength=ndev).max()), 1)
    oob_rows = np.zeros((ndev, M), np.int32)
    oob_cols = np.zeros((ndev, M), np.int32)
    oob_sel = np.zeros((ndev, M), np.int64)
    oob_w = np.zeros((ndev, M), np.float32)
    slot = np.zeros(ndev, np.int64)
    order = np.argsort(opart, kind="stable")
    for k in order:
        p = opart[k]
        j = slot[p]
        slot[p] = j + 1
        oob_rows[p, j] = orows[k]
        oob_cols[p, j] = ocols[k]
        oob_sel[p, j] = osel[k]
        oob_w[p, j] = 1.0

    # ---- per-part blocktri layouts -----------------------------------
    bt_maps = []
    bt_lsel = []
    NB = nloc // b
    for p in local:
        sel_p = np.nonzero(inpart & (rpart == p))[0]
        lr = rloc_g[sel_p]
        lc = cloc_g[sel_p]
        # padded local CSR pattern (+ unit diagonal padding rows)
        pr = np.arange(sizes[p], nloc)
        rows_l = np.concatenate([lr, pr])
        cols_l = np.concatenate([lc, pr])
        src = np.concatenate([sel_p, np.full(pr.size, -1, np.int64)])
        order_l = np.lexsort((cols_l, rows_l))
        A_l = sp.csr_matrix(
            (np.ones(order_l.size), (rows_l[order_l], cols_l[order_l])),
            shape=(nloc, nloc))
        # rebuild src in the CSR's canonical order (coo_matrix sums
        # duplicates; the assembled pattern has none)
        if A_l.nnz != order_l.size:
            raise ValueError("band_dd: a part's pattern repeats an entry")
        lay = blocktri.pack_layout(A_l, b)
        bt_maps.append(blocktri.device_maps(lay, device))
        bt_lsel.append(src[order_l])

    part_of = np.searchsorted(offs, np.arange(n), side="right") - 1
    loc_of = np.arange(n) - offs[part_of]

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return BandDDState(
        ndev=ndev, n=n, nloc=nloc, perm=perm, iperm=iperm,
        part_of=part_of, loc_of=loc_of,
        shift0=shift0, W=W, NT=NT,
        fill_pos=dev(fill_pos), fill_sel=dev(fill_sel),
        pad_pos=dev(pad_pos),
        oob_rows=dev(comm.local(oob_rows)),
        oob_cols=dev(comm.local(oob_cols)),
        oob_sel=dev(comm.local(oob_sel)),
        oob_w=dev(comm.local(oob_w), torch.float32),
        b=b, NB=NB, bt_maps=bt_maps, bt_lsel=bt_lsel,
        data_map=None, Ap_pattern=Ap, lo=p0, nl=nl, comm=comm)


def device_values(st: BandDDState, Ap: sp.csr_matrix):
    """Per-solve value refresh of the local parts: the (nl, NT, R, W) f32
    band (one ``index_add_`` of the in-part values and the padding rows'
    unit diagonals, whose slots are all distinct), the sidecar values and
    the Jacobi stopping weights, all from the permuted CSR."""
    dev = st.fill_pos.device
    data = torch.as_tensor(np.asarray(Ap.data, np.float32), device=dev)
    size = st.nl * st.NT * ROW_TILE * st.W
    dense = torch.zeros(size, dtype=torch.float32, device=dev).index_add_(
        0, torch.cat([st.fill_pos, st.pad_pos]),
        torch.cat([data[st.fill_sel],
                   torch.ones(st.pad_pos.shape[0], device=dev)]))
    dense = dense.view(st.nl, st.NT, ROW_TILE, st.W)
    oob_vals = data[st.oob_sel] * st.oob_w
    dg = np.asarray(Ap.diagonal())
    dg[dg == 0.0] = 1.0
    invd = np.ones((st.ndev, st.nloc), np.float32)
    invd[st.part_of, st.loc_of] = 1.0 / dg
    return dense, oob_vals, torch.as_tensor(invd[st.lo:st.lo + st.nl],
                                            device=dev)


def build_factors(st: BandDDState, Ap_data: np.ndarray) -> BTFactor:
    """The local parts' block-Thomas factors, stacked: Sinv (nl, NB, b, b),
    G (nl, NB-1, b, b), s (nl, NB*b), built part by part on the maps'
    device into the stacked tensors."""
    Sinv = G = s = None
    for p in range(st.nl):
        lsel = st.bt_lsel[p]
        vals = np.where(lsel >= 0, Ap_data[np.maximum(lsel, 0)], 1.0)
        f = blocktri.build_factor(st.bt_maps[p], vals, b=st.b, NB=st.NB)
        if Sinv is None:
            Sinv = f.Sinv.new_empty((st.nl,) + tuple(f.Sinv.shape))
            G = f.G.new_empty((st.nl,) + tuple(f.G.shape))
            s = f.s.new_empty((st.nl,) + tuple(f.s.shape))
        Sinv[p], G[p], s[p] = f.Sinv, f.G, f.s
        del f
    return BTFactor(Sinv=Sinv, G=G, s=s)


def part_factor(bt: BTFactor, p: int) -> BTFactor:
    """Local part p's factor: contiguous, aligned slices of the stacked
    one."""
    return BTFactor(Sinv=bt.Sinv[p], G=bt.G[p], s=bt.s[p])


def dd_operator(st: BandDDState, dense, oob_vals):
    """op(x) for (nl, nloc) local part vectors: K1 on every local part's
    band, plus the sidecar rows against the all-gathered x (one
    ``index_add_``; its rows index the local y, its columns the global
    x)."""
    P, nloc = st.nl, st.nloc
    bands = [BandMatrix(dense[p], st.shift0, CCHUNK, nloc) for p in range(P)]
    rows = (st.oob_rows
            + nloc * torch.arange(P, device=dense.device)[:, None]).view(-1)
    cols = st.oob_cols.view(-1)
    ovals = oob_vals.view(-1)

    def op(x):
        y = torch.stack([band_matvec(bands[p], x[p])[:nloc]
                         for p in range(P)])
        xg = st.comm.all_gather(x)
        return y.view(-1).index_add(0, rows, ovals * xg[cols]).view(P, nloc)

    return op


def dd_preconditioner(bt: BTFactor):
    """prec(r) for (P, nloc) part vectors: every part's exact local
    block-Thomas solve (K2, then K3+K4), one part after another."""
    parts = [part_factor(bt, p) for p in range(bt.Sinv.shape[0])]

    def prec(r):
        return torch.stack([blocktri.bt_apply(f, r[p])
                            for p, f in enumerate(parts)])

    return prec


def _pcg_dd(op, prec, rhs, invd, x0, tol, max_iter: int,
            comm=STACKED):
    """The JAX ``_pcg_dd`` for the local parts at once: CG with the
    per-part factors as preconditioner, stopping on the Jacobi-weighted
    residual sqrt(r.D^-1.r / res0) <= tol, at ``max_iter``, or after 60
    iterations without a 1% gain in |z.r|. Every decision comes from
    ``comm``'s sums, so the ranks of a group take the same steps.
    Returns (x, relative residual, iterations)."""
    zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    res0 = comm.pdot(invd * rhs, rhs)
    res0 = torch.where(res0 == 0.0, torch.ones_like(res0), res0)
    tol = torch.as_tensor(tol, dtype=rhs.dtype, device=rhs.device)
    r = rhs - op(x0)
    z = prec(r)
    res = comm.pdot(z, r)
    st = dict(x=x0.clone(), r=r, p=z, res=res,
              stop=comm.pdot(invd * r, r), best=res.abs(),
              it=torch.zeros((), dtype=torch.int32, device=rhs.device),
              since=torch.zeros((), dtype=torch.int32, device=rhs.device))

    def running():
        return ((torch.sqrt(st["stop"].abs() / res0) > tol)
                & (st["it"] < max_iter) & (st["since"] < 60))

    def step(active):
        res, p = st["res"], st["p"]
        u = op(p)
        delta = torch.where(active, res / comm.pdot(p, u), zero)
        st["x"] = st["x"] + delta * p
        r = st["r"] = st["r"] - delta * u
        z = prec(r)
        res_new = comm.pdot(z, r)
        st["stop"] = torch.where(active, comm.pdot(invd * r, r), st["stop"])
        st["p"] = torch.where(active, z + (res_new / res) * p, p)
        improved = active & (res_new.abs() < 0.99 * st["best"])
        st["best"] = torch.where(improved, res_new.abs(), st["best"])
        st["since"] = torch.where(
            active, torch.where(improved, 0, st["since"] + 1), st["since"])
        st["res"] = torch.where(active, res_new, res)
        st["it"] = st["it"] + active.to(torch.int32)

    launched = solver_mod._masked_loop(running, step,
                                       rhs.device.type == "cuda",
                                       lockstep=comm.lockstep)
    n_it = int(st["it"])
    solver_mod.MASKED["dd-band"] += launched - n_it
    return st["x"], float(torch.sqrt(st["stop"].abs() / res0)), n_it


def make_dd_pcg(st: BandDDState, max_iter: int = 20000):
    """``solve(dense, oob_vals, bt, rhs, invd, x0, tol) -> (x, relres,
    iterations)`` on (nl, nloc) local part tensors, over ``st.comm``."""
    def solve(dense, oob_vals, bt: BTFactor, rhs, invd, x0, tol):
        return _pcg_dd(dd_operator(st, dense, oob_vals),
                       dd_preconditioner(bt), rhs, invd, x0, tol, max_iter,
                       st.comm)

    return solve
