"""Distributed PCG on element blocks with one ring halo exchange per
operator application: the JAX package's ``parallel/halo.py``.

Each part applies its slab's element blocks to its extended local vector
``[left halo | owned]`` (``partition.py``), receives its left neighbour's
boundary strip before the product and returns the halo's contributions
after it (``comm.ring_shift`` both ways), and reduces dot products over
the parts (``comm.psum``). The JAX package runs the iteration as one
``while_loop`` inside ``shard_map``; here the parts a process holds are
the slices of a (P, ...) tensor (all of them under the stacked
communicator, the rank's own under a process group: ``comm.py``) and
the loop is the port's masked host loop (``loop.masked_loop``): an
iteration enqueued past the stop leaves the state unchanged, so the
result equals the early exit, and such masked iterations are counted in
``loop.MASKED["dd-halo"]`` / ``["dd-halo-csym"]``.

The path is float64, as in the JAX package (its element blocks, the
Schwarz hierarchy and the coarse solve are f64), on the card too: it is
bound by gathers and scatters, not by arithmetic (ROADMAP C.18). It runs
no Pallas kernel in the JAX package and no hand-written kernel here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import loop
from ..ops import solver as solver_mod
from .comm import STACKED
from .partition import PartitionedSystem


class DeviceArrays(NamedTuple):
    """Per-part tensors, the parts on the leading axis."""

    blocks_idx: tuple          # (P, E, K) int64 extended-local indices
    blocks_sign: tuple         # (P, E, K)
    blocks_mat: tuple          # (P, E, K, K)
    fixed_mask: torch.Tensor   # (P, nmax) bool
    fixed_vals: torch.Tensor   # (P, nmax)
    valid: torch.Tensor        # (P, nmax) bool


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def device_arrays(ps: PartitionedSystem, dtype=torch.float64,
                  device="cpu", comm=STACKED) -> DeviceArrays:
    """The part tensors of ``comm``'s parts (``comm.local``)."""
    def t(a, dt):
        return _t(comm.local(a), dt, device)

    return DeviceArrays(
        blocks_idx=tuple(t(b[0], torch.int64) for b in ps.blocks),
        blocks_sign=tuple(t(b[1], dtype) for b in ps.blocks),
        blocks_mat=tuple(t(b[2], dtype) for b in ps.blocks),
        fixed_mask=t(ps.fixed_mask, torch.bool),
        fixed_vals=t(ps.fixed_vals, dtype),
        valid=t(ps.valid, torch.bool))


def _gather(x_ext, idx):
    """x_ext[p, idx[p]] for every part: (P, L), (P, E, K) -> (P, E, K)."""
    P = idx.shape[0]
    return torch.gather(x_ext, 1, idx.reshape(P, -1)).view(idx.shape)


def _scatter_add(y_ext, idx, vals):
    P = idx.shape[0]
    return y_ext.scatter_add(1, idx.reshape(P, -1), vals.reshape(P, -1))


def _with_halo(x_own, hmax: int, comm):
    """[left neighbour's tail | owned] for every part (part 0's halo 0)."""
    nmax = x_own.shape[-1]
    halo = comm.ring_shift(x_own[..., nmax - hmax:], 1)
    return torch.cat([halo, x_own], dim=-1)


def _return_halo(y_ext, hmax: int, comm):
    """Owned slots with the halo's contributions added back to their
    owner's tail (right-to-left shift; the last part sends nothing)."""
    nmax = y_ext.shape[-1] - hmax
    back = comm.ring_shift(y_ext[..., :hmax], -1)
    return torch.cat([y_ext[..., hmax:nmax], y_ext[..., nmax:] + back],
                     dim=-1)


def _local_matvec(da: DeviceArrays, x_own, hmax: int, comm):
    """One distributed operator application on owned slots, (P, nmax)."""
    x_ext = _with_halo(x_own, hmax, comm)
    y_ext = torch.zeros_like(x_ext)
    for idx, sign, mat in zip(da.blocks_idx, da.blocks_sign, da.blocks_mat):
        xe = sign * _gather(x_ext, idx)
        ye = torch.einsum("pekl,pel->pek", mat, xe)
        y_ext = _scatter_add(y_ext, idx, sign * ye)
    y_own = _return_halo(y_ext, hmax, comm)
    return torch.where(da.valid, y_own, torch.zeros_like(y_own))


def _pcg_shard(da: DeviceArrays, b, x0, diag, tol, max_iter: int,
               hmax: int, amg=None, coarse=None, comm=STACKED):
    """The JAX ``_pcg_shard`` for all parts at once: Jacobi, the
    additive-Schwarz V-cycle (``amg``, one hierarchy per part, no
    communication) and the global coarse correction (``coarse`` =
    (coarse_inv, aggc), one all-gather). Stops on sqrt(|z.r| / res0) <=
    tol, at ``max_iter``, or after 500 iterations without a 10% gain in
    |z.r| (a preconditioner that does not contract: the driver latches
    it off). Returns (x, relative |z.r|, iterations)."""
    from ..ops.amg import vcycle

    fixed = da.fixed_mask
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    def op(x):
        y = _local_matvec(da, torch.where(fixed, zero, x), hmax, comm)
        return torch.where(fixed, x, y)

    invd = torch.where(da.valid, 1.0 / diag, zero)

    if amg is None:
        def prec_local(r):
            return invd * r
    else:
        def prec_local(r):
            # additive Schwarz: each part's V-cycle on its owned block
            # (identity rows at Dirichlet and padding slots)
            return torch.where(da.valid, vcycle(amg, r), zero)

    if coarse is None:
        prec = prec_local
    else:
        coarse_inv, aggc = coarse
        P, nmax = fixed.shape
        m = (nmax + aggc - 1) // aggc

        def prec(r):
            # two-level additive Schwarz: a global coarse correction over
            # per-part contiguous aggregates, one all-gather of P*m values
            # (the replicated coarse solve, then the local parts' rows)
            z = prec_local(r)
            rm = torch.where(fixed | ~da.valid, zero, r)
            rc = torch.nn.functional.pad(rm, (0, m * aggc - nmax)) \
                .view(P, m, aggc).sum(dim=2)
            zc = comm.local((coarse_inv @ comm.all_gather(rc)).view(-1, m))
            zfine = zc.repeat_interleave(aggc, dim=1)[:, :nmax]
            return z + torch.where(fixed | ~da.valid, zero, zfine)

    res0 = comm.pdot(invd * b, b)
    res0 = torch.where(res0 == 0.0, torch.ones_like(res0), res0)
    tol = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    r = b - op(x0)
    z = prec(r)
    res = comm.pdot(z, r)
    st = dict(x=x0.clone(), r=r, p=z, res=res, best=res.abs(),
              it=torch.zeros((), dtype=torch.int32, device=b.device),
              since=torch.zeros((), dtype=torch.int32, device=b.device))
    stall_window = 500

    def running():
        return ((torch.sqrt(st["res"].abs() / res0) > tol)
                & (st["it"] < max_iter) & (st["since"] < stall_window))

    def step(active):
        res, p = st["res"], st["p"]
        u = op(p)
        delta = torch.where(active, res / comm.pdot(p, u), zero)
        st["x"] = st["x"] + delta * p
        r = st["r"] = st["r"] - delta * u
        z = prec(r)
        res_new = comm.pdot(z, r)
        st["p"] = torch.where(active, z + (res_new / res) * p, p)
        improved = res_new.abs() < 0.9 * st["best"]
        st["best"] = torch.where(active,
                                 torch.minimum(st["best"], res_new.abs()),
                                 st["best"])
        st["since"] = torch.where(
            active, torch.where(improved, 0, st["since"] + 1), st["since"])
        st["res"] = torch.where(active, res_new, res)
        st["it"] = st["it"] + active.to(torch.int32)

    launched = loop.masked_loop(running, step, "dd-halo")
    n_it = int(st["it"])
    loop.tally("dd-halo", launched, n_it)
    return st["x"], float(torch.sqrt(st["res"].abs() / res0)), n_it


def make_distributed_pcg(hmax: int, max_iter: int = 200000, amg=None,
                         coarse=None, comm=STACKED):
    """``solve(da, b, diag, tol, x0) -> (x, relres, iterations)`` on
    (P, nmax) part tensors, with the optional per-part Schwarz hierarchy
    ``amg`` (``schwarz.build_schwarz_amg``) and global coarse solve
    ``coarse`` (``schwarz.build_global_coarse``)."""
    def solve(da: DeviceArrays, b, diag, tol, x0):
        return _pcg_shard(da, b, x0, diag, tol, max_iter, hmax, amg=amg,
                          coarse=coarse, comm=comm)

    return solve


def distributed_diag(da: DeviceArrays, hmax: int, comm=STACKED):
    """Assembled operator diagonal in part layout (for Jacobi)."""
    P, nmax = da.fixed_mask.shape
    d_ext = torch.zeros((P, hmax + nmax), dtype=da.blocks_mat[0].dtype,
                        device=da.fixed_mask.device)
    for idx, mat in zip(da.blocks_idx, da.blocks_mat):
        d_ext = _scatter_add(d_ext, idx,
                             torch.diagonal(mat, dim1=-2, dim2=-1))
    d_own = _return_halo(d_ext, hmax, comm)
    one = torch.ones_like(d_own)
    d_own = torch.where(da.fixed_mask, one, d_own)
    return torch.where(da.valid, d_own, one)


class DeviceArraysC(NamedTuple):
    """Per-part tensors of the complex-symmetric path: (re, im) pairs,
    the element matrices as separate real and imaginary parts."""

    blocks_idx: tuple
    blocks_sign: tuple
    blocks_mre: tuple
    blocks_mim: tuple
    fixed_mask: torch.Tensor
    valid: torch.Tensor


def _local_matvec_c(dc: DeviceArraysC, xr_own, xi_own, hmax: int, comm):
    """(Ar + i Ai)(xr + i xi) on owned slots, one halo exchange of the
    stacked (re, im) boundary strip each way."""
    x_ext = _with_halo(torch.stack([xr_own, xi_own], dim=1), hmax, comm)
    xr_ext, xi_ext = x_ext[:, 0], x_ext[:, 1]
    yr_ext = torch.zeros_like(xr_ext)
    yi_ext = torch.zeros_like(xi_ext)
    for idx, sign, mr, mi in zip(dc.blocks_idx, dc.blocks_sign,
                                 dc.blocks_mre, dc.blocks_mim):
        ger = sign * _gather(xr_ext, idx)
        gei = sign * _gather(xi_ext, idx)
        er = (torch.einsum("pekl,pel->pek", mr, ger)
              - torch.einsum("pekl,pel->pek", mi, gei))
        ei = (torch.einsum("pekl,pel->pek", mr, gei)
              + torch.einsum("pekl,pel->pek", mi, ger))
        yr_ext = _scatter_add(yr_ext, idx, sign * er)
        yi_ext = _scatter_add(yi_ext, idx, sign * ei)
    y = _return_halo(torch.stack([yr_ext, yi_ext], dim=1), hmax, comm)
    zero = torch.zeros_like(y[:, 0])
    return (torch.where(dc.valid, y[:, 0], zero),
            torch.where(dc.valid, y[:, 1], zero))


def _pcg_csym_shard(dc: DeviceArraysC, br, bi, x0r, x0i, dr_, di_, tol,
                    max_iter: int, hmax: int, comm=STACKED):
    """Distributed complex-symmetric Jacobi-PCG in the bilinear z.r form
    (the reference's PBCGSolve, cspars.cpp:822) on (re, im) pairs, psum
    reductions; stops on sqrt(|z.r| / res0) <= tol or at ``max_iter``.
    Returns (xr, xi, relative |z.r|, iterations)."""
    fixed = dc.fixed_mask
    zero = torch.zeros((), dtype=br.dtype, device=br.device)

    def op(xr, xi):
        yr, yi = _local_matvec_c(dc, torch.where(fixed, zero, xr),
                                 torch.where(fixed, zero, xi), hmax, comm)
        return torch.where(fixed, xr, yr), torch.where(fixed, xi, yi)

    def cdot(ar, ai, br_, bi_):
        return (comm.psum((ar * br_ - ai * bi_).sum(dim=1)),
                comm.psum((ar * bi_ + ai * br_).sum(dim=1)))

    dmag2 = dr_ * dr_ + di_ * di_
    dmag2 = torch.where(dmag2 == 0.0, torch.ones_like(dmag2), dmag2)
    invd_r = torch.where(dc.valid, dr_ / dmag2, zero)
    invd_i = torch.where(dc.valid, -di_ / dmag2, zero)

    def prec(rr, ri):
        return invd_r * rr - invd_i * ri, invd_r * ri + invd_i * rr

    bb_r = br * br - bi * bi
    bb_i = 2.0 * br * bi
    s_r = comm.psum((invd_r * bb_r - invd_i * bb_i).sum(dim=1))
    s_i = comm.psum((invd_i * bb_r + invd_r * bb_i).sum(dim=1))
    res0 = torch.hypot(s_r, s_i)
    res0 = torch.where(res0 == 0.0, torch.ones_like(res0), res0)
    tol = torch.as_tensor(tol, dtype=br.dtype, device=br.device)

    ar0, ai0 = op(x0r, x0i)
    rr, ri = br - ar0, bi - ai0
    zr, zi = prec(rr, ri)
    res_r, res_i = cdot(zr, zi, rr, ri)
    st = dict(xr=x0r.clone(), xi=x0i.clone(), rr=rr, ri=ri, pr=zr, pi=zi,
              res_r=res_r, res_i=res_i,
              it=torch.zeros((), dtype=torch.int32, device=br.device))

    def running():
        return ((torch.sqrt(torch.hypot(st["res_r"], st["res_i"]) / res0)
                 > tol) & (st["it"] < max_iter))

    def step(active):
        pr, pi, res_r, res_i = st["pr"], st["pi"], st["res_r"], st["res_i"]
        ur, ui = op(pr, pi)
        pap_r, pap_i = cdot(pr, pi, ur, ui)
        a_r, a_i = solver_mod._cdiv(res_r, res_i, pap_r, pap_i)
        a_r = torch.where(active, a_r, zero)
        a_i = torch.where(active, a_i, zero)
        st["xr"] = st["xr"] + a_r * pr - a_i * pi
        st["xi"] = st["xi"] + a_r * pi + a_i * pr
        rr = st["rr"] = st["rr"] - (a_r * ur - a_i * ui)
        ri = st["ri"] = st["ri"] - (a_r * ui + a_i * ur)
        zr, zi = prec(rr, ri)
        nres_r, nres_i = cdot(zr, zi, rr, ri)
        b_r, b_i = solver_mod._cdiv(nres_r, nres_i, res_r, res_i)
        st["pr"] = torch.where(active, zr + b_r * pr - b_i * pi, pr)
        st["pi"] = torch.where(active, zi + b_r * pi + b_i * pr, pi)
        st["res_r"] = torch.where(active, nres_r, res_r)
        st["res_i"] = torch.where(active, nres_i, res_i)
        st["it"] = st["it"] + active.to(torch.int32)

    launched = loop.masked_loop(running, step, "dd-halo-csym")
    n_it = int(st["it"])
    loop.tally("dd-halo-csym", launched, n_it)
    rel = float(torch.sqrt(torch.hypot(st["res_r"], st["res_i"]) / res0))
    return st["xr"], st["xi"], rel, n_it


def make_distributed_csym_pcg(hmax: int, max_iter: int = 200000,
                              comm=STACKED):
    """``solve(dc, br, bi, dr_, di_, tol, x0r, x0i) -> (xr, xi, relres,
    iterations)`` on (P, nmax) part tensors."""
    def solve(dc: DeviceArraysC, br, bi, dr_, di_, tol, x0r, x0i):
        return _pcg_csym_shard(dc, br, bi, x0r, x0i, dr_, di_, tol,
                               max_iter, hmax, comm)

    return solve


def make_distributed_matvec(hmax: int, comm=STACKED):
    """``mv(da, x) -> y`` on (P, nmax) part tensors (the PCG's layout)."""
    def mv(da: DeviceArrays, x):
        return _local_matvec(da, x, hmax, comm)

    return mv


def solve_distributed(ps: PartitionedSystem, b: np.ndarray, tol: float,
                      device=None, x0=None, max_iter: int = 200000,
                      schwarz: bool = False, comm=STACKED):
    """End-to-end distributed solve from a PartitionedSystem on
    ``device`` (CUDA unless named), over ``comm``'s parts. ``b`` is in
    reduced-DOF numbering; Dirichlet values are imposed by projection as
    in the single-device solve. Returns (x_reduced, relres,
    iterations)."""
    dev = solver_mod.resolve_device(device)
    da = device_arrays(ps, device=dev, comm=comm)
    diag = distributed_diag(da, ps.hmax, comm)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    g_dev = torch.where(da.fixed_mask, da.fixed_vals, zero)
    bg = make_distributed_matvec(ps.hmax, comm)(da, g_dev)
    b_dev = _t(ps.to_devices(np.asarray(b, np.float64), comm),
               torch.float64, dev)
    rhs = torch.where(da.fixed_mask, da.fixed_vals, b_dev - bg)
    rhs = torch.where(da.valid, rhs, zero)
    if x0 is None:
        x0_dev = g_dev
    else:
        x0_dev = _t(ps.to_devices(np.asarray(x0, np.float64), comm),
                    torch.float64, dev)
        x0_dev = torch.where(da.fixed_mask, da.fixed_vals, x0_dev)
    amg = coarse = None
    if schwarz:
        from .schwarz import build_global_coarse, build_schwarz_amg
        amg = build_schwarz_amg(ps, dtype=np.float64, device=dev, comm=comm)
        coarse = build_global_coarse(ps, device=dev)
    solve = make_distributed_pcg(ps.hmax, max_iter, amg=amg, coarse=coarse,
                                 comm=comm)
    x_dev, relres, iters = solve(da, rhs, diag, tol, x0_dev)
    return ps.from_devices(x_dev, comm), relres, iters
