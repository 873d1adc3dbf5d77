"""Block-tridiagonal factorization: a near-exact CG preconditioner.

After the reverse-Cuthill-McKee reordering the FEM matrix has bandwidth
``bw ~ 2 sqrt(N)``; whenever ``bw <= b`` for a block size ``b`` the
matrix is EXACTLY block-tridiagonal with dense ``b x b`` blocks:

    A = [D_0  L_0^T           ]
        [L_0  D_1   L_1^T     ]
        [     L_1   D_2   ... ]

The block-Thomas factorization is dense linear algebra,

    S_0 = D_0;  G_i = L_i S_i^{-1};  S_{i+1} = D_{i+1} - G_i L_i^T

(``torch.linalg.inv`` and ``torch.matmul`` in true fp32, TF32 off), and
applying the factor is two sweeps of ``b``-sized matvecs (forward
``y_i = r_i - G_{i-1} y_{i-1}``, backward
``x_i = S_i^{-1} y_i - G_i^T x_{i+1}``) that run as the hand-written
CUDA kernels of ops/kernels.py on the card (``bt_fwd``, and ``bt_qbwd``
for the Sinv products and the backward sweep in one launch). With symmetric Jacobi
scaling one application contracts the residual by ~1e3-1e4, so the
band CG converges in a handful of iterations and the factor stays
frozen across Newton iterations until the session's staleness rule
refactors it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from . import kernels
from .band import BandMatrix, band_apply

#: supported block sizes: multiples of 128 up to 2048. The finer steps
#: matter: a bandwidth-1037 matrix pays 5.35 GB at the next power of two
#: (2048) but only 3.0 GB at 1152. The Hopper sweep kernels serve every
#: size here.
BLOCK_SIZES = (256, 384, 512, 640, 768, 896, 1024, 1152, 1280,
               1536, 1792, 2048)


class BTFactor(NamedTuple):
    """Frozen block-tridiagonal factorization of the (Jacobi-scaled)
    operator. ``Sinv`` is (NB, b, b), ``G`` is (NB-1, b, b), ``s`` the
    (npad,) symmetric scaling so that prec(r) = s * apply(s * r)."""
    Sinv: torch.Tensor
    G: torch.Tensor
    s: torch.Tensor


class BTSmoother(NamedTuple):
    """A block-tridiagonal factor in the SMOOTHER role: the same fields
    as BTFactor (``bt_apply`` takes either), but the distinct type tells
    the solve to compose it with the band-AMG coarse correction (the
    V-cycle's level-0 smoother, band.band_vcycle) instead of using it as
    the standalone CG preconditioner. It factors only the KEPT in-part
    band of a partitioned ordering."""
    Sinv: torch.Tensor
    G: torch.Tensor
    s: torch.Tensor


class BTCoarse(NamedTuple):
    """A block-tridiagonal factor serving as the (near-)exact bottom
    solve of a two-grid band hierarchy, with the ordering in which it
    was factored (``perm``/``iperm`` None: hierarchy order). ``n`` is
    the coarse dimension."""
    factor: BTFactor
    n: int
    perm: "torch.Tensor | None" = None
    iperm: "torch.Tensor | None" = None


def bt_coarse_apply(btc: BTCoarse, rc: torch.Tensor) -> torch.Tensor:
    """Near-exact coarse solve in hierarchy ordering."""
    rcp = rc if btc.perm is None else rc[btc.perm]
    z = bt_apply(btc.factor, rcp)
    return z if btc.iperm is None else z[btc.iperm]


class BTLayout(NamedTuple):
    """Host scatter maps from permuted-CSR entry order into the D/L
    block buffers (value-only refreshes reuse them)."""
    b: int
    NB: int
    n: int
    keep: np.ndarray          # entries kept (diag + lower blocks)
    tgt_is_L: np.ndarray      # of kept: True -> L, False -> D
    blk: np.ndarray           # of kept: block index into D or L
    rloc: np.ndarray
    cloc: np.ndarray
    rows: np.ndarray          # of kept: global row (for scaling)
    cols: np.ndarray
    diag_pos: np.ndarray      # position of each diagonal entry (n,)


def bandwidth(Ap: sp.csr_matrix) -> int:
    rows = np.repeat(np.arange(Ap.shape[0]), np.diff(Ap.indptr))
    if Ap.nnz == 0:
        return 0
    return int(np.abs(Ap.indices - rows).max())


def pick_block(bw: int) -> int | None:
    for b in BLOCK_SIZES:
        if bw <= b:
            return b
    return None


def factor_bytes(n: int, b: int, itemsize: int = 4) -> int:
    """Device bytes held by a finished factor (Sinv + G)."""
    NB = (n + b - 1) // b
    return (2 * NB - 1) * b * b * itemsize


def bt_build_transient_bytes(n: int, b: int) -> int:
    """Device bytes the factor BUILD transiently needs on top of the
    finished factor: the fused build fills full f32 (D, L) buffers, the
    chunked build (factors over 2 GB) bounds the fill to ~2 GB."""
    fb = factor_bytes(n, b)
    return fb if fb <= 2e9 else int(2e9)


def pack_layout(Ap: sp.csr_matrix, b: int) -> BTLayout:
    """Slot of every kept CSR entry of the RCM-permuted matrix in the
    (D, L) block buffers. Upper-block entries (bi == bj - 1) are
    redundant by symmetry and dropped."""
    n = Ap.shape[0]
    NB = (n + b - 1) // b
    rows = np.repeat(np.arange(n), np.diff(Ap.indptr)).astype(np.int64)
    cols = Ap.indices.astype(np.int64)
    bi = rows // b
    bj = cols // b
    assert np.abs(bi - bj).max() <= 1, "matrix is not block-tridiagonal"
    keep = bi >= bj
    bik = bi[keep]
    bjk = bj[keep]
    is_L = bik == bjk + 1
    blk = np.where(is_L, bjk, bik)
    rloc = rows[keep] - bik * b
    cloc = cols[keep] - bjk * b
    dpos = np.nonzero(rows == cols)[0]
    assert dpos.size == n
    return BTLayout(b=b, NB=NB, n=n,
                    keep=np.nonzero(keep)[0].astype(np.int64),
                    tgt_is_L=is_L,
                    blk=blk.astype(np.int32),
                    rloc=rloc.astype(np.int32),
                    cloc=cloc.astype(np.int32),
                    rows=rows[keep].astype(np.int32),
                    cols=cols[keep].astype(np.int32),
                    diag_pos=dpos.astype(np.int64))


class BTDeviceMaps(NamedTuple):
    """Device-resident scatter maps (built once per pattern)."""
    sel: torch.Tensor         # kept-entry positions in the full data
    d_flat: torch.Tensor      # of kept: flat index into D (or 0)
    l_flat: torch.Tensor      # of kept: flat index into L (or 0)
    is_L: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    diag_pos: torch.Tensor
    pad_diag: torch.Tensor    # flat indices into D for identity padding


def device_maps(lay: BTLayout, device="cpu") -> BTDeviceMaps:
    b, NB, n = lay.b, lay.NB, lay.n
    d_flat = (lay.blk.astype(np.int64) * b + lay.rloc) * b + lay.cloc
    pad = np.arange(n, NB * b, dtype=np.int64)
    pblk = pad // b
    ploc = pad - pblk * b
    pad_diag = (pblk * b + ploc) * b + ploc

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return BTDeviceMaps(
        sel=dev(lay.keep),
        d_flat=dev(np.where(lay.tgt_is_L, 0, d_flat)),
        l_flat=dev(np.where(lay.tgt_is_L, d_flat, 0)),
        is_L=dev(lay.tgt_is_L),
        rows=dev(lay.rows.astype(np.int64)),
        cols=dev(lay.cols.astype(np.int64)),
        diag_pos=dev(lay.diag_pos),
        pad_diag=dev(pad_diag))


def _thomas(Sprev: torch.Tensor, D: torch.Tensor, L: torch.Tensor,
            Sinv: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """The factorization recurrence over len(D) steps from the Schur
    carry ``Sprev``, writing the Sinv and G blocks (in their storage
    dtype) into the given slices; returns the last carry."""
    S = Sprev
    with kernels.fp32_matmul():
        for i in range(D.shape[0]):
            Si = torch.linalg.inv(S)
            Gi = L[i] @ Si
            S = D[i] - Gi @ L[i].T
            Sinv[i] = Si.to(Sinv.dtype)
            G[i] = Gi.to(G.dtype)
    return S


def _fill_and_factor(maps: BTDeviceMaps, data: torch.Tensor, b: int,
                     NB: int, store_dtype=torch.float32) -> BTFactor:
    """Scatter the permuted CSR values into (D, L), symmetric-Jacobi
    scale, and run the block-Thomas factorization in fp32 (no TF32: the
    factor must resolve the small eigenvalues of an ill-conditioned FEM
    operator). ``store_dtype=torch.bfloat16`` halves the bytes every
    apply streams, but doubles the CG iterations on the 250k problem in
    the JAX package's measurements; production stores f32."""
    dev = data.device
    n = maps.diag_pos.shape[0]
    npad = NB * b
    diag = data[maps.diag_pos]
    safe = torch.where(diag == 0.0, torch.ones_like(diag), diag)
    s = torch.ones(npad, dtype=torch.float32, device=dev)
    s[:n] = torch.rsqrt(safe.abs().float())

    vals = data[maps.sel].float() * s[maps.rows] * s[maps.cols]
    zero = torch.zeros_like(vals)
    dvals = torch.where(maps.is_L, zero, vals)
    lvals = torch.where(maps.is_L, vals, zero)
    D = torch.zeros(NB * b * b, dtype=torch.float32, device=dev)
    D.index_put_((maps.d_flat,), dvals, accumulate=True)
    D.index_put_((maps.pad_diag,),
                 torch.ones(maps.pad_diag.shape[0], device=dev),
                 accumulate=True)
    D = D.view(NB, b, b)
    L = torch.zeros(max(NB - 1, 1) * b * b, dtype=torch.float32, device=dev)
    L.index_put_((maps.l_flat,), lvals, accumulate=True)
    L = L.view(max(NB - 1, 1), b, b)

    Sinv = torch.empty((NB, b, b), dtype=store_dtype, device=dev)
    G = torch.empty((NB - 1, b, b), dtype=store_dtype, device=dev)
    Slast = _thomas(D[0], D[1:], L[:NB - 1], Sinv, G)
    with kernels.fp32_matmul():
        Sinv[NB - 1] = torch.linalg.inv(Slast).to(store_dtype)
    return BTFactor(Sinv=Sinv, G=G, s=s)


def build_factor(maps: BTDeviceMaps, data_p: np.ndarray, b: int,
                 NB: int, store_dtype=torch.float32) -> BTFactor:
    """Factor from the permuted CSR values (host array, any dtype)."""
    data = torch.as_tensor(np.asarray(data_p, np.float32),
                           device=maps.sel.device)
    return _fill_and_factor(maps, data, b=b, NB=NB, store_dtype=store_dtype)


def _fill_blocks(dv, dflat, lv, lflat, pv, pflat, nb: int, b: int, device):
    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    D = torch.zeros(nb * b * b, dtype=torch.float32, device=device)
    D.index_put_((t(dflat, torch.int64),), t(dv, torch.float32),
                 accumulate=True)
    D.index_put_((t(pflat, torch.int64),), t(pv, torch.float32),
                 accumulate=True)
    L = torch.zeros(nb * b * b, dtype=torch.float32, device=device)
    L.index_put_((t(lflat, torch.int64),), t(lv, torch.float32),
                 accumulate=True)
    return D.view(nb, b, b), L.view(nb, b, b)


def build_factor_chunked(lay: BTLayout, data_p: np.ndarray,
                         store_dtype=torch.float32,
                         chunk: int | None = None,
                         device="cpu") -> BTFactor:
    """Block-Thomas factor built in CHUNKS of blocks: the fused
    ``_fill_and_factor`` materializes the full (D, L) buffers next to
    the (Sinv, G) outputs, a 2x-factor-bytes f32 transient. Here the
    host drives ceil(NB/chunk) fill + factor rounds threading the b x b
    Schur carry into preallocated outputs, so the transient is one chunk
    (2 * chunk * b^2 f32) whatever NB is. The recurrence and its fp32
    products are unchanged; the Jacobi scaling is computed on host in
    f64."""
    b, NB, n = lay.b, lay.NB, lay.n
    if chunk is None:
        chunk = max(8, int(1e9 // (b * b * 8)))
    data64 = np.asarray(data_p, np.float64)
    diag = data64[lay.diag_pos]
    safe = np.where(diag == 0.0, 1.0, diag)
    s_host = np.ones(NB * b, np.float32)
    s_host[:n] = (1.0 / np.sqrt(np.abs(safe))).astype(np.float32)
    vals = (data64[lay.keep] * s_host[lay.rows] * s_host[lay.cols]) \
        .astype(np.float32)
    isL = lay.tgt_is_L
    blk = lay.blk.astype(np.int64)
    rloc = lay.rloc.astype(np.int64)
    cloc = lay.cloc.astype(np.int64)
    pad = np.arange(n, NB * b, dtype=np.int64)
    pblk = pad // b
    ploc = pad - pblk * b
    empty = np.zeros(0, np.float32)
    empty_i = np.zeros(0, np.int64)

    # S_0 = D_0; then chunks of recurrence steps i in [1, NB)
    m0 = (~isL) & (blk == 0)
    D0, _ = _fill_blocks(vals[m0], rloc[m0] * b + cloc[m0], empty, empty_i,
                         np.ones(int((pblk == 0).sum()), np.float32),
                         ploc[pblk == 0] * b + ploc[pblk == 0],
                         nb=1, b=b, device=device)
    carry = D0[0]
    Sinv = torch.empty((NB, b, b), dtype=store_dtype, device=device)
    G = torch.empty((NB - 1, b, b), dtype=store_dtype, device=device)
    s0 = 1
    while s0 < NB:
        s1 = min(s0 + chunk, NB)
        nb = s1 - s0
        dm = (~isL) & (blk >= s0) & (blk < s1)
        dflat = ((blk[dm] - s0) * b + rloc[dm]) * b + cloc[dm]
        lm = isL & (blk >= s0 - 1) & (blk < s1 - 1)
        lflat = ((blk[lm] - (s0 - 1)) * b + rloc[lm]) * b + cloc[lm]
        pm = (pblk >= s0) & (pblk < s1)
        pflat = ((pblk[pm] - s0) * b + ploc[pm]) * b + ploc[pm]
        D, L = _fill_blocks(vals[dm], dflat, vals[lm], lflat,
                            np.ones(int(pm.sum()), np.float32), pflat,
                            nb=nb, b=b, device=device)
        carry = _thomas(carry, D, L, Sinv[s0 - 1:s1 - 1], G[s0 - 1:s1 - 1])
        del D, L
        s0 = s1
    with kernels.fp32_matmul():
        Sinv[NB - 1] = torch.linalg.inv(carry).to(store_dtype)
    return BTFactor(Sinv=Sinv, G=G,
                    s=torch.as_tensor(s_host, device=device))


def bt_build(maps_or_lay, vals, b: int, NB: int, store_dtype=torch.float32,
             device="cpu") -> BTFactor:
    """Build a factor through either path: BTDeviceMaps -> the fused
    fill + factor, BTLayout -> the chunked build (large factors whose
    fill transient should stay bounded)."""
    if isinstance(maps_or_lay, BTLayout):
        return build_factor_chunked(maps_or_lay, vals,
                                    store_dtype=store_dtype, device=device)
    return build_factor(maps_or_lay, vals, b=b, NB=NB,
                        store_dtype=store_dtype)


def bt_apply(bt: BTFactor, r: torch.Tensor) -> torch.Tensor:
    """z ~= A^{-1} r, through the sweep kernels (bt_fwd, then bt_qbwd) on
    the card and their plain versions on CPU tensors."""
    NB, b, _ = bt.Sinv.shape
    n = r.shape[0]
    rs = torch.zeros(NB * b, dtype=torch.float32, device=r.device)
    rs[:n] = bt.s[:n] * r
    rs = rs.view(NB, b)
    ys = kernels.bt_fwd(bt.G, rs)
    zs = kernels.bt_qbwd(bt.Sinv, bt.G, ys)
    return bt.s[:n] * zs.view(-1)[:n]


def bt_pcg(Aop: BandMatrix, dvec, invd, bt: BTFactor, rhs, tol, x0,
           max_iter, stall_window: int = 40, oob=None):
    """CG on the dense-band operator preconditioned by the (possibly
    frozen) block-tridiagonal factor. Stopping metric: Jacobi-weighted
    residual norm relative to ``rhs``, drift-guarded in chunks
    (band._chunked_pcg). Returns (x, true metric, iterations)."""
    from .band import _chunked_pcg

    def op(x):
        return band_apply(Aop, dvec, x, oob)

    def prec(r):
        return bt_apply(bt, r)

    return _chunked_pcg(op, prec, invd, rhs, tol, x0, max_iter,
                        stall_window, engine="bt")
