"""The port's band-AMG hierarchy (xfemm_tpu_torch/ops/band.py
``setup_band_amg``, ``band_vcycle``, ``band_pcg``; blocktri's
``BTSmoother``) and its planner (ops/solver.py ``pick_band_order``,
``plan_band_hierarchy``) against the JAX package on triangulated grid
matrices: a partitioned (RCB) ordering with its COO sidecars, triu
levels and budget truncation, the two-level V-cycle with the in-part
block-tridiagonal smoother, and the plans of the 1M- and 2M-node grids
at a 16 GB device."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

import jax.numpy as jnp

from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import blocktri as jbt
from xfemm_tpu.ops import pallas_band
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch import convert
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import blocktri as tbt
from xfemm_tpu_torch.ops import solver as tsolver

HBM = 16e9

# the suite runs in several worker processes on a few cores: one torch
# thread each (the plain versions run many small products)
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _xla_band(monkeypatch):
    monkeypatch.delenv("XFEMM_TPU_PALLAS", raising=False)
    monkeypatch.setattr(pallas_band, "INTERPRET", True)
    jband._pallas_enabled.cache_clear()
    yield
    jband._pallas_enabled.cache_clear()


def _grid_fem(nx: int, ny: int):
    """A triangulated structured grid's 7-point nodal stencil (SPD), as
    tests/test_band_plan.py builds it."""
    n = nx * ny
    ii = np.arange(n, dtype=np.int64)
    x = ii % nx
    y = ii // nx
    coords = np.stack([x, y], axis=1).astype(np.float64)
    rows, cols, vals = [ii], [ii], [np.full(n, 6.0)]
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1)):
        ok = ((x + dx >= 0) & (x + dx < nx)
              & (y + dy >= 0) & (y + dy < ny))
        rows.append(ii[ok])
        cols.append(((y + dy) * nx + (x + dx))[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A, coords


def _partitioned(nx, ny, parts):
    """The grid in a 4-part RCB + in-part RCM ordering (both packages'
    partition_order agree), with the permuted coordinates and the
    global-RCM key the coarse levels inherit."""
    At, coords = _grid_fem(nx, ny)
    perm = tband.partition_order(At, coords, parts)
    assert np.array_equal(perm, jband.partition_order(At, coords, parts))
    g = np.asarray(reverse_cuthill_mckee(At, symmetric_mode=True))
    gpos = np.empty(At.shape[0], np.int64)
    gpos[g] = np.arange(At.shape[0])
    Ap = At[perm][:, perm].tocsr()
    Ap.sum_duplicates()
    return Ap, coords[perm], gpos[perm]


def _same_levels(tamg, jamg):
    assert len(tamg.levels) == len(jamg.levels)
    for tl, jl in zip(tamg.levels, jamg.levels):
        jd = convert.tensor(jl.A.dense)
        assert tl.A.dense.dtype == jd.dtype
        assert torch.equal(tl.A.dense, jd)
        assert (tl.A.shift0, tl.A.cchunk, tl.A.ncols) == \
            (jl.A.shift0, jl.A.cchunk, jl.A.ncols)
        assert (tl.dvec is None) == (jl.dvec is None)
        assert (tl.oob is None) == (jl.oob is None)
        if tl.oob is not None:
            assert tl.oob.rows.numel() == jl.oob.rows.size
            assert torch.equal(tl.oob.cols, convert.tensor(jl.oob.cols).long())
        assert (tl.P is None) == (jl.P is None)
        if tl.P is not None:
            assert torch.equal(tl.P.dense, convert.tensor(jl.P.dense))
        assert (tl.Abf is None) == (jl.Abf is None)
        assert (tl.cperm is None) == (jl.cperm is None)
        if tl.cperm is not None:
            assert np.array_equal(tl.cperm.numpy(), np.asarray(jl.cperm))
        assert float(tl.omega) == float(jl.omega)
    if jamg.bt_coarse is None:
        np.testing.assert_allclose(tamg.coarse_inv.numpy(),
                                   np.asarray(jamg.coarse_inv), rtol=1e-6,
                                   atol=1e-9)


def _kept_factor(Ap, lay, jmod, tmod):
    """Both packages' block-tridiagonal factor of the fine level's KEPT
    band (the solve's BTSmoother construction)."""
    n = Ap.shape[0]
    if lay.upper_sel is not None:
        rows = np.repeat(np.arange(n), np.diff(Ap.indptr))
        dist = np.abs(rows - Ap.indices)
        cut = int(dist[lay.upper_sel][lay.keep_sel].max())
        keep = dist <= cut
    else:
        keep = np.zeros(Ap.nnz, bool)
        keep[lay.keep_sel] = True
    Ak, _ = jband._split_csr(Ap, keep)
    bsize = jbt.pick_block(jbt.bandwidth(Ak))
    lj = jbt.pack_layout(Ak, bsize)
    fj = jbt.build_factor(jbt.device_maps(lj), Ak.data, b=bsize, NB=lj.NB)
    lt = tbt.pack_layout(Ak, bsize)
    ft = tbt.build_factor(tbt.device_maps(lt), Ak.data, b=bsize, NB=lt.NB)
    return jbt.BTSmoother(*fj), tbt.BTSmoother(*ft)


@pytest.mark.parametrize("sym,budget", [(False, None), (True, None),
                                        (False, "tight")])
def test_partitioned_hierarchy_matches_jax(sym, budget, monkeypatch):
    monkeypatch.setattr(jband, "SYM_MIN_BYTES", 0)
    monkeypatch.setattr(tband, "SYM_MIN_BYTES", 0)
    Ap, cp, key = _partitioned(160, 160, 4)
    n = Ap.shape[0]
    if budget == "tight":
        # barely above the fine band: every coarse level is truncated
        rows = np.repeat(np.arange(n), np.diff(Ap.indptr))
        R, cut, _s = jband.plan_level(np.abs(rows - Ap.indices), n, False)
        budget = 1.3 * jband._band_est(n, cut, R, False)
    kw = dict(sym=sym, coords=cp, band_key=key, budget_bytes=budget,
              fine_abf=False)
    jamg, jlay = jband.setup_band_amg(Ap, **kw)
    tamg, tlay = tband.setup_band_amg(Ap, **kw)
    _same_levels(tamg, jamg)
    assert tamg.levels[0].oob is not None          # the cross-part tail
    assert (tamg.levels[0].dvec is not None) == sym
    for a, b in zip(tlay, convert.fine_layout(jlay)):
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert a == b
    jreport, _ = jband.setup_band_amg(Ap, plan_only=True, **kw)
    treport, _ = tband.setup_band_amg(Ap, plan_only=True, **kw)
    assert treport == jreport
    if budget is not None:
        assert any(lv["truncated"] for lv in treport[1:-1])

    rng = np.random.default_rng(3)
    r = rng.standard_normal(n).astype(np.float32)
    jbs, tbs = _kept_factor(Ap, jlay, jbt, tbt)
    all_P = all(lv.P is not None for lv in tamg.levels)
    # the tight budget leaves its last level without a prolongator band,
    # where the port's transfers are the smoothed prolongator's applied
    # matrix-free and the JAX package's plain aggregation
    assert all_P == (budget is None)
    # one V-cycle, the SAME smoother factor on both sides: the bf16
    # prolongator rounds both packages' f32 residuals (equal to ~1e-7)
    # differently at a few elements, so the l2 error is held to 1e-5
    # and the largest element error to 1e-4 of max|z|
    for jb_s, tb_s in ((None, None),
                       (jbs, tbt.BTSmoother(*convert.bt_factor(jbs)))):
        if not all_P:
            break
        zj = np.asarray(jband.band_vcycle(jamg, jnp.asarray(r), bt=jb_s))
        zt = tband.band_vcycle(tamg, torch.as_tensor(r), bt=tb_s).numpy()
        assert np.linalg.norm(zt - zj) <= 1e-5 * np.linalg.norm(zj)
        assert np.abs(zt - zj).max() <= 1e-4 * np.abs(zj).max()

    b = (Ap @ rng.standard_normal(n)).astype(np.float32)
    b /= np.abs(b).max()
    for jb_s, tb_s in ((None, None), (jbs, tbs)):
        _xj, relj, itj = jband.band_pcg(
            jamg, jnp.asarray(b), jnp.asarray(1e-6, jnp.float32),
            jnp.zeros(n, jnp.float32), 400, stall_window=48, bt=jb_s)
        _xt, relt, itt = tband.band_pcg(
            tamg, torch.as_tensor(b), 1e-6, torch.zeros(n), 400,
            stall_window=48, bt=tb_s)
        # tol, or the drift guard's f32-floor exit just above it
        assert relt <= 2e-6 and float(relj) <= 2e-6
        if all_P:
            assert abs(itt - int(itj)) <= max(1, 0.1 * int(itj)), (itt, itj)
        else:
            assert itt <= 1.1 * int(itj) + 1, (itt, itj)


def test_matrix_free_smoothed_transfers():
    """A level without a stored prolongator band transfers through the
    smoothed prolongator applied matrix-free (P = (I - omega D^-1 A) P0):
    the same V-cycle as the JAX package's with its stored bf16 P band,
    up to that band's bf16 rounding."""
    Ap, cp, key = _partitioned(160, 160, 4)
    kw = dict(coords=cp, band_key=key, fine_abf=False)
    jamg, _ = jband.setup_band_amg(Ap, **kw)
    tamg, _ = tband.setup_band_amg(Ap, **kw)
    assert all(lv.P is not None for lv in tamg.levels)
    for lv in tamg.levels:
        lv.P = lv.P_oob = None
    r = np.random.default_rng(5).standard_normal(Ap.shape[0]) \
        .astype(np.float32)
    zj = np.asarray(jband.band_vcycle(jamg, jnp.asarray(r)))
    zt = tband.band_vcycle(tamg, torch.as_tensor(r)).numpy()
    assert np.linalg.norm(zt - zj) <= 1e-2 * np.linalg.norm(zj)
    # and the exact transfer: P^T d through the stored CSR of P
    lv = tamg.levels[0]
    A = Ap.astype(np.float32)
    n = A.shape[0]
    P0 = sp.csr_matrix((np.ones(n), (np.arange(n), np.arange(n) // 4)),
                       shape=(n, (n + 3) // 4))
    P = P0 - sp.diags(float(lv.omega) * lv.invd.numpy().astype(np.float64)) \
        @ (A @ P0)
    d = torch.as_tensor(r)
    dd = d - tband.band_apply(lv.A, lv.dvec, lv.omega * lv.invd * d, lv.oob)
    rc = torch.nn.functional.pad(dd, (0, 4 * P0.shape[1] - n)) \
        .view(-1, 4).sum(1).numpy()
    ref = P.T @ r.astype(np.float64)
    assert np.abs(rc - ref).max() <= 1e-5 * np.abs(ref).max()


def test_two_grid_bottom_solve_matches_jax():
    """The two-grid form: a block-tridiagonal factor of the first
    Galerkin coarse matrix as the bottom solve (BTCoarse)."""
    At, _coords = _grid_fem(120, 120)
    g = np.asarray(reverse_cuthill_mckee(At, symmetric_mode=True))
    Ap = At[g][:, g].tocsr()
    kw = dict(bt_coarse_budget=1e9, bt_transient_budget=2e9)
    jamg, _ = jband.setup_band_amg(Ap, **kw)
    tamg, _ = tband.setup_band_amg(Ap, **kw)
    assert tamg.bt_coarse is not None and tamg.coarse_inv is None
    assert tamg.bt_coarse.n == jamg.bt_coarse.n
    assert (tamg.bt_coarse.perm is None) == (jamg.bt_coarse.perm is None)
    _same_levels(tamg, jamg)
    rc = np.random.default_rng(8).standard_normal(
        tamg.bt_coarse.n).astype(np.float32)
    zj = np.asarray(jbt.bt_coarse_apply(jamg.bt_coarse, jnp.asarray(rc)))
    zt = tbt.bt_coarse_apply(tamg.bt_coarse, torch.as_tensor(rc)).numpy()
    assert np.abs(zt - zj).max() <= 1e-5 * np.abs(zj).max()
    # the V-cycle around it, with the SAME bottom factor on both sides
    jbc = jamg.bt_coarse
    tamg.bt_coarse = tbt.BTCoarse(
        convert.bt_factor(jbc.factor), n=jbc.n,
        perm=None if jbc.perm is None else convert.tensor(jbc.perm).long(),
        iperm=None if jbc.iperm is None
        else convert.tensor(jbc.iperm).long())
    r = np.cos(np.arange(Ap.shape[0]) * 0.1).astype(np.float32)
    zj = np.asarray(jband.band_vcycle(jamg, jnp.asarray(r)))
    zt = tband.band_vcycle(tamg, torch.as_tensor(r)).numpy()
    assert np.linalg.norm(zt - zj) <= 1e-5 * np.linalg.norm(zj)
    assert np.abs(zt - zj).max() <= 1e-4 * np.abs(zj).max()


@pytest.mark.parametrize("nx,regime", [(1000, "bt_smooth"), (1400, "sym")])
def test_planner_matches_jax(nx, regime):
    """The ordering, the storage tiers and the hierarchy plan of the 1M-
    and 2M-node grids at a 16 GB device equal the JAX package's."""
    At, coords = _grid_fem(nx, nx)
    tperm, tpart, tgpos = tsolver.pick_band_order(At, coords, HBM)
    jperm, jpart, jgpos = jsolver.pick_band_order(At, coords, hbm=HBM)
    assert tpart and jpart
    assert np.array_equal(tperm, jperm) and np.array_equal(tgpos, jgpos)
    Ap = At[tperm][:, tperm].tocsr()
    Ap.sum_duplicates()
    tplan = tsolver.plan_band_hierarchy(Ap, tpart, HBM)
    jplan = jsolver.plan_band_hierarchy(Ap, jpart, hbm=HBM)
    assert tplan == jplan
    assert tplan[regime]
    kw = dict(sym=tplan["sym"], bt_coarse_budget=tplan["bt_budget"],
              bt_transient_budget=tplan["bt_transient"],
              coords=coords[tperm], budget_bytes=tplan["hier_budget"],
              fine_full=tplan["fine_full"], band_key=tgpos[tperm],
              fine_abf=not tplan["bt_smooth"], plan_only=True)
    treport, _ = tband.setup_band_amg(Ap, **kw)
    jreport, _ = jband.setup_band_amg(Ap, **kw)
    assert treport == jreport
