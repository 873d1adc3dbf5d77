"""Domain-decomposition linear solves for the model solvers: the JAX
package's ``parallel/driver.py``.

The model code assembles element blocks exactly as for the single-device
path and hands each linear system to a ``DistributedSession``, which
partitions the problem once, keeps the partition and the preconditioner
across Newton iterations, and refreshes only the matrix VALUES per call.
Two engines, chosen per call as in the JAX package:

* the sharded band engine (``band_dd.py``) when DOF coordinates are given
  and the system has more than 4*ndev*128 unknowns: per-part dense bands
  (K1) and exact per-part block-Thomas factors (K2, K3+K4) in an f32 CG
  inside an f64 host refinement against the assembled CSR; a pass that
  does not contract latches the engine off for the session;
* the first-generation element-block PCG (``halo.py``), f64, with the
  additive-Schwarz AMG and the global coarse solve (``schwarz.py``) built
  from the first operator and rebuilt when the iteration count passes
  ``refresh_factor`` x the first call's; a Schwarz solve that misses the
  tolerance latches the session to Jacobi.

The JAX package runs N parts on N devices. Here, without a process
group, the N parts are the leading axis of tensors on ONE device (the
stacked communicator of ``comm.py``), the card unless the caller names
another (ROADMAP C.17). With a ``torch.distributed`` process group of N
ranks as ``device_mesh``, each rank holds its own part on its own card
(or the host, when the caller asks for ``device="cpu"``) and the parts
meet through the group (``comm.GroupComm``): every rank runs the same
host code, every host vector that leaves a rank is all-gathered, so all
ranks keep identical host state, and each solve ends by checking that
they do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import solver as solver_mod
from ..utils.profiling import phase
from . import halo, partition as part
from .comm import STACKED, GroupComm


def _is_group(device_mesh) -> bool:
    import torch.distributed as dist
    return dist.is_available() and isinstance(device_mesh,
                                              dist.ProcessGroup)


def mesh_device(device_mesh, device=None) -> torch.device:
    """The device of this process's parts: for a process group the
    rank's card (the current CUDA device), or ``device`` when the caller
    names one; else the one device of a ``device_mesh``: None (the
    solve's default device, ``device``), a device, or a sequence of
    devices that are all the same one. A sequence naming several
    distinct devices raises: one process holds one device, so several
    cards take one process per card with a process group (ROADMAP
    C.17)."""
    if device_mesh is None:
        return solver_mod.resolve_device(device)
    if _is_group(device_mesh):
        dev = solver_mod.resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if isinstance(device_mesh, (str, torch.device)):
        devs = [device_mesh]
    elif isinstance(device_mesh, (list, tuple)) and device_mesh:
        devs = list(device_mesh)
    else:
        raise TypeError(f"device_mesh must be a device or a non-empty "
                        f"list of devices, not {type(device_mesh).__name__}")
    try:
        distinct = {torch.device(d) for d in devs}
    except (TypeError, RuntimeError) as exc:
        raise TypeError(f"device_mesh holds something that is not a "
                        f"device: {exc}") from None
    if len(distinct) > 1:
        raise NotImplementedError(
            f"device_mesh names {len(distinct)} distinct devices; a "
            f"process holds its parts on one device: run one process per "
            f"card and pass their torch.distributed process group "
            f"(parallel/launch.py; ROADMAP C.17)")
    return solver_mod.resolve_device(distinct.pop())


def session(devices, device_mesh=None, device=None, schwarz: bool = True):
    """The models' ``devices=`` / ``device_mesh=``: a DistributedSession
    over ``devices`` parts, or None without ``devices``. A given
    ``device_mesh`` is checked either way (``mesh_device``); a process
    group must have ``devices`` ranks."""
    if device_mesh is not None:
        mesh_device(device_mesh, device)
    if not devices:
        return None
    return DistributedSession(devices, mesh=device_mesh, schwarz=schwarz,
                              device=device)


class DistributedSession:
    """Per-problem domain-decomposition solver state (one per solve; one
    per rank under a process group ``mesh``)."""

    def __init__(self, ndev: int, mesh=None, schwarz: bool = True,
                 refresh_factor: float = 3.0, device=None):
        self.ndev = int(ndev)
        if self.ndev < 1:
            raise ValueError(f"DistributedSession: {ndev} parts")
        if _is_group(mesh) and self.ndev != mesh.size():
            raise ValueError(f"devices={ndev} with a process group of "
                             f"{mesh.size()} ranks: one part per rank")
        self.device = mesh_device(mesh, device)
        #: the parts' communicator (``comm.py``)
        self.comm = GroupComm(mesh) if _is_group(mesh) else STACKED
        self.schwarz = schwarz
        self.refresh_factor = refresh_factor
        self.ps = None            # PartitionedSystem (structure)
        self._sel = None          # per-block element->part packing
        self._solver = None       # distributed PCG
        self._csolver = None      # distributed csym PCG
        self._mv = None           # distributed matvec
        self._amg = None
        self._coarse = None
        self.first_iters = None
        self.last_iters = None
        # sharded band engine (band_dd.py): the fast path
        self._csr_session = None
        self._bdd = None          # BandDDState
        self._bdd_solver = None
        self._bdd_bt = None       # stacked per-part BTFactor
        self._bdd_map = None      # At.data -> Ap.data entry map
        self._bdd_disabled = False
        self._bdd_first = None
        self._bdd_last = None
        #: CG iterations of each refinement pass of the last band_dd solve
        self.pass_iters: list[int] = []

    # ------------------------------------------------------------------
    def _solve_band_dd(self, blocks, b, fixed_mask, fixed_vals, tol,
                       x0, coords):
        """Sharded band engine solve: per-part dense bands + exact local
        block-Thomas factors, mixed-precision refinement against the
        host f64 CSR (the contract of ops/solver.solve). Returns None
        when the structure is ineligible or a pass does not contract."""
        from . import band_dd

        n = int(np.asarray(b).shape[0])
        fixed = np.asarray(fixed_mask, bool)
        fvals = np.asarray(fixed_vals, np.float64)
        nonzero_g = bool(fixed.any() and np.any(fvals[fixed] != 0.0))
        if self._csr_session is None:
            self._csr_session = solver_mod.Session()
        with phase("dd csr assembly"):
            At = self._csr_session.csr_values(blocks, n, fixed)
        if self._bdd is None and not self._bdd_disabled:
            with phase("dd band setup"):
                st = band_dd.setup_band_dd(At, np.asarray(coords),
                                           self.ndev, device=self.device,
                                           comm=self.comm)
            if st is None:
                self._bdd_disabled = True
                return None
            self._bdd = st
            self._bdd_map = solver_mod._csr_perm_map(
                At, st.Ap_pattern, st.perm, st.iperm)
            self._bdd_solver = band_dd.make_dd_pcg(st)
        if self._bdd is None:
            return None
        st = self._bdd
        Ap = st.Ap_pattern
        Ap.data = At.data[self._bdd_map]

        with phase("dd band refresh"):
            dense, oob_vals, invd_dev = band_dd.device_values(st, Ap)
        stale = (self._bdd_bt is not None and self._bdd_first is not None
                 and self._bdd_last is not None
                 and self._bdd_last
                 > self.refresh_factor * max(self._bdd_first, 1))
        if self._bdd_bt is None or stale:
            self._bdd_bt = None
            with phase("dd bt factor"):
                self._bdd_bt = band_dd.build_factors(st, Ap.data)
            self._bdd_first = None

        b64 = np.asarray(b, np.float64)
        g = np.where(fixed, fvals, 0.0)
        if nonzero_g:
            # the Dirichlet values' A.g correction from the blocks
            Ag = np.zeros(n)
            for blk_ in blocks:
                idx = np.asarray(blk_.idx)
                sgn = np.asarray(blk_.sign, np.float64)
                mat = np.asarray(blk_.mat, np.float64)
                ge = sgn * g[idx]
                ye = np.einsum("ekl,el->ek", mat, ge)
                np.add.at(Ag, idx.reshape(-1), (sgn * ye).reshape(-1))
            rhs = np.where(fixed, fvals, b64 - Ag)
        else:
            rhs = np.where(fixed, fvals, b64)
        diag64 = np.asarray(At.diagonal())
        diag64[diag64 == 0.0] = 1.0
        invd = 1.0 / diag64
        res0 = float(np.dot(invd * rhs, rhs))
        res0 = res0 if res0 != 0.0 else 1.0
        x = g.copy() if x0 is None else np.where(
            fixed, fvals, np.asarray(x0, np.float64))

        def scatter(v):
            out = np.zeros((st.ndev, st.nloc), np.float32)
            out[st.part_of, st.loc_of] = v[st.perm]
            return torch.as_tensor(self.comm.local(out), device=self.device)

        it_total = 0
        self.pass_iters = []
        inner_tol = max(tol, 1e-5)
        metric = None
        x_zero = torch.zeros((st.nl, st.nloc), dtype=torch.float32,
                             device=self.device)
        for _ in range(12):
            r = rhs - At @ x
            metric = float(np.sqrt(np.dot(invd * r, r) / res0))
            if metric <= tol:
                break
            with phase("dd cg"):
                dx_dev, rr, it = self._bdd_solver(
                    dense, oob_vals, self._bdd_bt, scatter(r), invd_dev,
                    x_zero, inner_tol)
            it_total += it
            self.pass_iters.append(it)
            dx = np.zeros(n)
            dx_all = self.comm.all_gather(dx_dev).view(st.ndev, st.nloc)
            dx[st.perm] = dx_all.cpu().numpy().astype(np.float64)[
                st.part_of, st.loc_of]
            x = x + np.where(fixed, 0.0, dx)
            if rr > 0.9 and it >= 60:
                # not contracting: latch the path off and report failure
                self._bdd_disabled = True
                return None
        if metric is None or metric > tol:
            self._bdd_disabled = True
            return None
        if self._bdd_first is None:
            self._bdd_first = it_total
        self._bdd_last = it_total
        return x, metric, it_total

    # ------------------------------------------------------------------
    def _build_structure(self, blocks, nreduced, fixed_mask, fixed_vals,
                         coords):
        np_blocks = [(np.asarray(b.idx), np.asarray(b.sign),
                      np.asarray(b.mat, np.float64)) for b in blocks]
        self.ps = part.partition(np_blocks, nreduced,
                                 np.asarray(fixed_mask),
                                 np.asarray(fixed_vals, np.float64),
                                 coords, self.ndev)
        self._derive_sel(np_blocks)
        self._mv = halo.make_distributed_matvec(self.ps.hmax, self.comm)

    def _derive_sel(self, np_blocks):
        """Reproduce partition()'s element->slot packing so later calls
        refresh ``mat`` values without re-partitioning: ONE flat
        destination index per block (element e of the original block
        lands at row ``dst[e]`` of the (D*emax, K, K) buffer)."""
        ps = self.ps
        owner = ps.dof_dev
        self._sel = []
        for (idx, sign, mat), (bidx, bsign, bmat) in zip(np_blocks,
                                                         ps.blocks):
            ed = owner[idx].max(axis=1)
            emax = bmat.shape[1]
            # slot within the owning part = rank among same-part elements
            # in original order (matches partition()'s packing)
            order = np.argsort(ed, kind="stable")
            slot = np.empty(ed.size, np.int64)
            ranks = np.arange(ed.size) - np.searchsorted(
                ed[order], ed[order])
            slot[order] = ranks
            dst = ed.astype(np.int64) * emax + slot
            self._sel.append((dst, emax))

    def _repack_values(self, blocks):
        """New (D, emax, K, K) matrices from this call's block values:
        one vectorized scatter per block."""
        out = []
        for (bidx, bsign, bmat), b, (dst, emax) in zip(
                self.ps.blocks, blocks, self._sel):
            mat = np.asarray(b.mat, np.float64)
            D = bmat.shape[0]
            K = bmat.shape[2]
            new = np.zeros((D * emax, K, K), bmat.dtype)
            new[dst] = mat
            out.append((bidx, bsign, new.reshape(bmat.shape)))
        return out

    def _to_parts(self, v):
        return torch.as_tensor(self.ps.to_devices(v, self.comm),
                               device=self.device)

    # ------------------------------------------------------------------
    def solve(self, blocks, b, fixed_mask, fixed_vals, tol,
              x0=None, coords=None, max_iter: int = 200000):
        """Distributed solve; the contract of ops/solver.solve. Returns
        (x, relative residual, iterations). Under a process group every
        rank returns the same x, or every rank raises RuntimeError."""
        out = self._solve(blocks, b, fixed_mask, fixed_vals, tol, x0,
                          coords, max_iter)
        self.comm.check_same(out[0], "DistributedSession.solve")
        return out

    def _solve(self, blocks, b, fixed_mask, fixed_vals, tol, x0, coords,
               max_iter):
        nreduced = int(np.asarray(b).shape[0])
        if (coords is not None and not self._bdd_disabled
                and np.shape(coords)[0] == nreduced
                and nreduced > 4 * self.ndev * 128):
            out = self._solve_band_dd(blocks, b, fixed_mask, fixed_vals,
                                      tol, x0, coords)
            if out is not None:
                return out
        if self.ps is None:
            self._build_structure(blocks, nreduced, fixed_mask,
                                  fixed_vals, coords)
        else:
            self.ps.blocks = self._repack_values(blocks)

        ps = self.ps
        dev = self.device
        da = halo.device_arrays(ps, device=dev, comm=self.comm)
        stale = (self._amg is not None and self.first_iters is not None
                 and self.last_iters is not None
                 and self.last_iters
                 > self.refresh_factor * max(self.first_iters, 1))
        if self.schwarz and (self._amg is None or stale):
            from .schwarz import build_global_coarse, build_schwarz_amg
            self._amg = build_schwarz_amg(ps, dtype=np.float64, device=dev,
                                          comm=self.comm)
            self._coarse = build_global_coarse(ps, device=dev)
            self._solver = None
            self.first_iters = None
        if self._solver is None:
            self._solver = halo.make_distributed_pcg(
                ps.hmax, max_iter, amg=self._amg, coarse=self._coarse,
                comm=self.comm)

        # assembled diagonal on the host
        dh = np.zeros(nreduced)
        for blk in blocks:
            idx = np.asarray(blk.idx)
            dd = np.einsum("ekk->ek", np.asarray(blk.mat, np.float64))
            np.add.at(dh, idx.reshape(-1), dd.reshape(-1))
        dh[np.asarray(fixed_mask)] = 1.0
        dh[dh == 0.0] = 1.0
        diag_np = np.ones((ps.ndev, ps.nmax))
        diag_np[ps.dof_dev, ps.dof_slot] = dh
        diag = torch.as_tensor(self.comm.local(diag_np), device=dev)

        zero = torch.zeros((), dtype=torch.float64, device=dev)
        g_dev = torch.where(da.fixed_mask, da.fixed_vals, zero)
        bg = self._mv(da, g_dev)
        b_dev = self._to_parts(np.asarray(b, np.float64))
        rhs = torch.where(da.fixed_mask, da.fixed_vals, b_dev - bg)
        rhs = torch.where(da.valid, rhs, zero)
        if x0 is None:
            x0_dev = g_dev
        else:
            x0_dev = self._to_parts(np.asarray(x0, np.float64))
            x0_dev = torch.where(da.fixed_mask, da.fixed_vals, x0_dev)
        x_dev, relres, it = self._solver(da, rhs, diag, tol, x0_dev)
        if relres > tol and self._amg is not None:
            # the Schwarz-AMG preconditioner does not contract on this
            # operator: latch it off for the session and re-solve with
            # Jacobi CG (the single-device engine's runtime fallback)
            self.schwarz = False
            self._amg = None
            self._coarse = None
            self._solver = halo.make_distributed_pcg(ps.hmax, max_iter,
                                                     comm=self.comm)
            x_dev, relres, it2 = self._solver(da, rhs, diag, tol, x0_dev)
            it += it2
            self.first_iters = None
        if self.first_iters is None:
            self.first_iters = it
        self.last_iters = it
        return ps.from_devices(x_dev, self.comm), relres, it

    # ------------------------------------------------------------------
    def solve_complex(self, blocks, b, fixed_mask, fixed_vals, tol,
                      x0=None, coords=None, max_iter: int = 200000):
        """Distributed complex-symmetric solve on (re, im) pairs
        (cspars.cpp:822 PBCGSolve semantics, ``halo._pcg_csym_shard``).
        ``blocks`` carry complex ``mat``; circuit Case-2 bordered rows
        are not supported here (their dense coupling spans every slab):
        callers keep those on the single-device path. Under a process
        group every rank returns the same x, or every rank raises."""
        nreduced = int(np.asarray(b).shape[0])
        if self.ps is None:
            struct = [type(b0)(idx=b0.idx, sign=b0.sign,
                               mat=np.asarray(b0.mat).real)
                      for b0 in blocks]
            self._build_structure(struct, nreduced, fixed_mask,
                                  np.asarray(fixed_vals).real, coords)
        ps = self.ps
        dev = self.device
        np_mats = [np.asarray(b0.mat, np.complex128) for b0 in blocks]
        mre_l, mim_l = [], []
        for (bidx, bsign, _bm), mat, (dst, emax) in zip(
                ps.blocks, np_mats, self._sel):
            D = _bm.shape[0]
            K = _bm.shape[2]
            mre = np.zeros((D * emax, K, K))
            mim = np.zeros_like(mre)
            mre[dst] = mat.real
            mim[dst] = mat.imag
            mre_l.append(mre.reshape(D, emax, K, K))
            mim_l.append(mim.reshape(D, emax, K, K))

        def t(a, dtype=torch.float64):
            return torch.as_tensor(np.asarray(self.comm.local(a)),
                                   dtype=dtype, device=dev)

        dc = halo.DeviceArraysC(
            blocks_idx=tuple(t(b0[0], torch.int64) for b0 in ps.blocks),
            blocks_sign=tuple(t(b0[1]) for b0 in ps.blocks),
            blocks_mre=tuple(t(m) for m in mre_l),
            blocks_mim=tuple(t(m) for m in mim_l),
            fixed_mask=t(ps.fixed_mask, torch.bool),
            valid=t(ps.valid, torch.bool))
        if self._csolver is None:
            self._csolver = halo.make_distributed_csym_pcg(
                ps.hmax, max_iter, comm=self.comm)

        # assembled complex diagonal on the host
        dh = np.zeros(nreduced, np.complex128)
        for b0 in blocks:
            idx = np.asarray(b0.idx)
            dd = np.einsum("ekk->ek", np.asarray(b0.mat, np.complex128))
            np.add.at(dh, idx.reshape(-1), dd.reshape(-1))
        fixed = np.asarray(fixed_mask, bool)
        dh[fixed] = 1.0
        dh[dh == 0.0] = 1.0
        dr_ = np.ones((ps.ndev, ps.nmax))
        di_ = np.zeros((ps.ndev, ps.nmax))
        dr_[ps.dof_dev, ps.dof_slot] = dh.real
        di_[ps.dof_dev, ps.dof_slot] = dh.imag

        fvals = np.asarray(fixed_vals, np.complex128)
        g = np.where(fixed, fvals, 0.0)
        # rhs adjustment b - A g on the host (g is fixed-only)
        bg = np.zeros(nreduced, np.complex128)
        for b0 in blocks:
            idx = np.asarray(b0.idx)
            sign = np.asarray(b0.sign, np.float64)
            mat = np.asarray(b0.mat, np.complex128)
            ge = sign * g[idx]
            ye = np.einsum("ekl,el->ek", mat, ge)
            np.add.at(bg, idx.reshape(-1), (sign * ye).reshape(-1))
        rhs = np.where(fixed, fvals, np.asarray(b, np.complex128) - bg)
        x0c = g if x0 is None else np.where(
            fixed, fvals, np.asarray(x0, np.complex128))

        xr, xi, relres, iters = self._csolver(
            dc, self._to_parts(rhs.real), self._to_parts(rhs.imag),
            t(dr_), t(di_), tol, self._to_parts(x0c.real),
            self._to_parts(x0c.imag))
        x = (ps.from_devices(xr, self.comm)
             + 1j * ps.from_devices(xi, self.comm))
        self.comm.check_same(x, "DistributedSession.solve_complex")
        return x, relres, iters
