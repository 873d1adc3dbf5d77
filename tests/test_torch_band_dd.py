"""The port's sharded band engine (``xfemm_tpu_torch/parallel/band_dd.py``)
and the band-engine half of ``DistributedSession`` against the JAX
package's ``parallel/band_dd.py`` / ``driver.py`` on the CPU (the JAX
side on the 8 virtual devices of tests/conftest.py, x64 on; the port on
``device="cpu"`` with the kernels' plain versions).

Tolerances: the structure (RCB parts with the slab fallback, per-part
RCM, the common band geometry, the fill maps, the sidecar, the per-part
factor maps) is bit for bit; the f32 band, sidecar values and Jacobi
weights are bit for bit (every band slot is written once); the per-part
factors are built in f32 by two libraries, so their applications agree
to 1e-4 of max|z|; one f32 CG pass from the same state and factor gives
the same correction to 1e-4 of max|x| and an iteration count within 10%
(the dot products are summed in a different order: the JAX ``psum``
against the port's part-order sum); whole solves meet 1e-8 of max|x|
against the single-device f64 answer, as tests/test_parallel.py asks.
"""

import functools

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from xfemm_tpu.mesh import mesher as jmesher
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu.models import magnetostatics as jmag
from xfemm_tpu.ops import assembly as jassembly
from xfemm_tpu.ops import blocktri as jbt
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu.parallel import band_dd as jbdd
from xfemm_tpu.parallel.driver import DistributedSession as JSession
from xfemm_tpu_torch import convert
from xfemm_tpu_torch import models as tmodels
from xfemm_tpu_torch.models import benchprob as tbench
from xfemm_tpu_torch.ops import blocktri as tbt
from xfemm_tpu_torch.ops import solver as tsolver
from xfemm_tpu_torch.parallel import band_dd as tbdd
from xfemm_tpu_torch.parallel import driver as tdriver

# several worker processes on a few cores: one torch thread each
torch.set_num_threads(1)

HOST = ("perm", "iperm", "part_of", "loc_of")
MAPS = ("fill_pos", "fill_sel", "pad_pos", "oob_rows", "oob_cols",
        "oob_sel", "oob_w")
GEOM = ("ndev", "n", "nloc", "shift0", "W", "NT", "b", "NB")


@functools.lru_cache(maxsize=None)
def _system():
    """tests/test_parallel.py's ``test_sharded_band_engine_matches_single``
    system: the 10k benchmark problem at mu = 1000 in its steel, as
    element blocks (both packages' ElementBlock take the same numpy
    arrays), the right-hand side, the DOF coordinates, the assembled
    Dirichlet-eliminated CSR and its f64 direct solution."""
    p = jbench.build(10000)
    mesh = jmesher.mesh_problem(p)
    pk = jmag.pack(p, mesh)
    geom = jassembly.tri_geometry(pk.xy, pk.tris)
    Mx, My, _ = jassembly.curl_matrices(geom)
    mu = np.where(pk.nonlinear, 1000.0, pk.mu_x)
    Me = np.asarray(Mx) / mu[:, None, None] \
        + np.asarray(My) / mu[:, None, None]
    idx = pk.ridx[pk.tris]
    sign = pk.rsign[pk.tris]
    b = np.zeros(pk.nreduced)
    np.add.at(b, idx.reshape(-1),
              -(sign * (-(pk.Jre * np.asarray(geom.area) / 3.0)[:, None]
                        * np.ones((1, 3)))).reshape(-1))
    coords = np.zeros((pk.nreduced, 2))
    coords[pk.ridx] = pk.xy
    fixed = np.asarray(pk.fixed_mask, bool)
    At = jsolver.Session().csr_values(
        [jsolver.ElementBlock(idx=idx, sign=sign, mat=-Me)], pk.nreduced,
        fixed)
    x_ref = spla.spsolve(At.tocsc(), np.where(fixed, 0.0, b))
    return pk, (idx, sign, -Me), b, coords, At, x_ref


def _states(ndev):
    _pk, _blk, _b, coords, At, _x = _system()
    return (jbdd.setup_band_dd(At, coords, ndev),
            tbdd.setup_band_dd(At, coords, ndev))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("ndev", [4, 6, 8])
def test_setup_band_dd_matches_jax(ndev):
    """The sharded structure bit for bit, at 6 parts through the slab
    fallback for a part count that is not a power of two."""
    js, ts = _states(ndev)
    for name in GEOM:
        assert getattr(ts, name) == getattr(js, name), name
    for name in HOST + MAPS:
        assert np.array_equal(_np(getattr(ts, name)),
                              np.asarray(getattr(js, name))), name
    for tm, jm in zip(ts.bt_maps, js.bt_maps):
        for name in tbt.BTDeviceMaps._fields:
            assert np.array_equal(_np(getattr(tm, name)),
                                  np.asarray(getattr(jm, name))), name
    for a, b in zip(ts.bt_lsel, js.bt_lsel):
        assert np.array_equal(a, b)
    assert np.array_equal(ts.Ap_pattern.indices, js.Ap_pattern.indices)
    assert np.array_equal(ts.Ap_pattern.indptr, js.Ap_pattern.indptr)
    # every part's band is a 16-byte aligned slice of the stacked one
    assert (ts.W * 4) % 16 == 0
    assert ts.fill_pos.device.type == "cpu"
    # the JAX state carried across is the port's own
    cs = convert.band_dd_state(js)
    for name in MAPS:
        assert torch.equal(getattr(cs, name), getattr(ts, name)), name
    for cm, tm in zip(cs.bt_maps, ts.bt_maps):
        assert all(torch.equal(a, b) for a, b in zip(cm, tm))


def _permuted(st, At):
    Ap = st.Ap_pattern.copy()
    Ap.data = At.data[tsolver._csr_perm_map(At, Ap, st.perm, st.iperm)]
    return Ap


def test_device_values_match_jax():
    """The (P, NT, R, W) f32 band, the sidecar values and the Jacobi
    weights from the same permuted CSR: bit for bit."""
    js, ts = _states(8)
    Ap = _permuted(ts, _system()[4])
    dj = jbdd._fill_dense(jnp.asarray(Ap.data, jnp.float32), js.fill_pos,
                          js.fill_sel, js.pad_pos, P_=js.ndev, NT=js.NT,
                          R=jbdd.ROW_TILE, W=js.W)
    dense, oob_vals, invd = tbdd.device_values(ts, Ap)
    assert tuple(dense.shape) == (8, ts.NT, tbdd.ROW_TILE, ts.W)
    assert np.array_equal(dense.numpy(), np.asarray(dj))
    _dj, oj, ij = jbdd.device_values(js, Ap)
    assert np.array_equal(oob_vals.numpy(), np.asarray(oj))
    assert np.array_equal(invd.numpy(), np.asarray(ij))


def test_operator_is_the_permuted_matrix():
    """K1 on every part's band plus the all-gathered sidecar is the
    permuted CSR's product (f32 band against the f64 host product)."""
    _js, ts = _states(8)
    Ap = _permuted(ts, _system()[4])
    dense, oob_vals, _invd = tbdd.device_values(ts, Ap)
    x = np.random.default_rng(6).standard_normal(ts.n)
    xp = np.zeros((ts.ndev, ts.nloc))
    xp[ts.part_of, ts.loc_of] = x
    y = tbdd.dd_operator(ts, dense, oob_vals)(
        torch.as_tensor(xp, dtype=torch.float32)).numpy()
    ref = Ap @ x
    assert np.abs(y[ts.part_of, ts.loc_of] - ref).max() \
        <= 1e-5 * np.abs(ref).max()
    pad = np.ones((ts.ndev, ts.nloc), bool)
    pad[ts.part_of, ts.loc_of] = False
    assert np.abs(y[pad]).max() == 0.0


def test_factors_and_pcg_pass_match_jax():
    """The stacked per-part factors: each part's application within
    1e-4 of max|z| of the JAX package's; then one CG pass (tol 1e-5)
    from the same state with the JAX package's factor carried across:
    the correction within 1e-4 of max|x|, iterations within 10%."""
    js, ts = _states(8)
    Ap = _permuted(ts, _system()[4])
    fj = jbdd.build_factors(js, Ap.data)
    ft = tbdd.build_factors(ts, Ap.data)
    assert tuple(ft.Sinv.shape) == (8, ts.NB, ts.b, ts.b)
    assert tuple(ft.G.shape) == (8, ts.NB - 1, ts.b, ts.b)
    rng = np.random.default_rng(9)
    for p in (0, 5):
        r = rng.standard_normal(ts.nloc).astype(np.float32)
        zj = np.asarray(jbt.bt_apply(
            jbt.BTFactor(fj.Sinv[p], fj.G[p], fj.s[p]), jnp.asarray(r)))
        zt = tbt.bt_apply(tbdd.part_factor(ft, p),
                          torch.as_tensor(r)).numpy()
        assert np.abs(zt - zj).max() <= 1e-4 * np.abs(zj).max()

    ts = convert.band_dd_state(js)
    dense, oob_vals, invd = tbdd.device_values(ts, Ap)
    rhs = np.zeros((ts.ndev, ts.nloc), np.float32)
    rhs[ts.part_of, ts.loc_of] = np.where(
        np.asarray(_system()[0].fixed_mask, bool), 0.0, _system()[2]
    )[ts.perm]
    rhs /= np.abs(rhs).max()
    x0 = np.zeros_like(rhs)
    _dj, oj, ij = jbdd.device_values(js, Ap)
    xj, rj, itj = jbdd.make_dd_pcg(
        Mesh(np.array(jax.devices()[:8]), ("d",)), js)(
        _dj, js.oob_rows, js.oob_cols, oj, fj.Sinv, fj.G, fj.s,
        jnp.asarray(rhs), ij, jnp.asarray(x0), jnp.asarray(1e-5, jnp.float32))
    xt, rt, itt = tbdd.make_dd_pcg(ts)(
        dense, oob_vals, convert.bt_factor(fj), torch.as_tensor(rhs), invd,
        torch.as_tensor(x0), 1e-5)
    assert rt <= 1e-5 and float(rj) <= 1e-5
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-4 * np.abs(xj).max()
    assert abs(itt - int(itj)) <= max(2, int(itj) // 10), (itt, int(itj))


def _blocks(pkg_solver, scale=1.0):
    _pk, (idx, sign, mat), *_ = _system()
    return [pkg_solver.ElementBlock(idx=idx, sign=sign, mat=scale * mat)]


def test_session_cold_and_refresh_match_single(monkeypatch):
    """``DistributedSession(8).solve`` on the 10k system takes the band
    engine: the f64 direct solution within 1e-8 of max|x| cold and on a
    value refresh of the same session (the factor kept, then rebuilt
    once the refresh rule fires), CG counts within 10% of the JAX
    session's, printed per refinement pass."""
    pk, _blk, b, coords, _At, x_ref = _system()
    builds = []
    real = tbdd.build_factors
    monkeypatch.setattr(tbdd, "build_factors",
                        lambda *a: (builds.append(1), real(*a))[1])
    ts = tdriver.DistributedSession(8, device="cpu")
    js = JSession(8)
    args = (pk.fixed_mask, pk.fixed_vals, 1e-10)
    scale = np.abs(x_ref).max()
    xt, rt, it = ts.solve(_blocks(tsolver), b, *args, coords=coords)
    _xj, _rj, ij = js.solve(_blocks(jsolver), b, *args, coords=coords)
    print(f"band_dd cold: {it} CG ({ts.pass_iters} per pass), JAX {ij}")
    assert ts._bdd is not None and not ts._bdd_disabled
    assert rt <= 1e-10 and np.abs(xt - x_ref).max() <= 1e-8 * scale
    assert abs(it - ij) <= max(2, ij // 10), (it, ij)
    x2, r2, it2 = ts.solve(_blocks(tsolver), b, *args, coords=coords)
    assert np.abs(x2 - x_ref).max() <= 1e-8 * scale and it2 <= it + 5
    assert len(builds) == 1
    ts.refresh_factor = 0.0          # every later call is "stale"
    x3, _r3, _it3 = ts.solve(_blocks(tsolver), b, *args, coords=coords)
    assert len(builds) == 2 and np.abs(x3 - x_ref).max() <= 1e-8 * scale


def test_nonzero_dirichlet_matches_jax():
    """Nonzero Dirichlet values take the blocks' A.g correction of the
    band engine's right-hand side (JAX driver.py:87-137, kept as it
    is): against the JAX session and the single-device solve, 1e-8."""
    pk, _blk, b, coords, _At, _x = _system()
    fixed = np.asarray(pk.fixed_mask, bool)
    fv = np.where(fixed, 1e-4 * (1.0 + coords[:, 0]), 0.0)
    ts = tdriver.DistributedSession(4, device="cpu")
    xt, rt, _ = ts.solve(_blocks(tsolver), b, fixed, fv, 1e-10,
                         coords=coords)
    assert ts._bdd is not None and not ts._bdd_disabled
    xs, _, _ = jsolver.solve(_blocks(jsolver), b, fixed, fv, 1e-10)
    xs = np.asarray(xs)
    xj, _, _ = JSession(4).solve(_blocks(jsolver), b, fixed, fv, 1e-10,
                                 coords=coords)
    assert rt <= 1e-10
    assert np.array_equal(xt[fixed], fv[fixed])
    for ref in (xs, np.asarray(xj)):
        assert np.abs(xt - ref).max() <= 1e-8 * np.abs(ref).max()


def test_non_contracting_pass_latches_off(monkeypatch):
    """A band pass that does not contract (relres > 0.9 after 60 or more
    iterations) latches the band engine off for the session, and the
    solve finishes on the element-block Schwarz PCG."""
    pk, _blk, b, coords, _At, x_ref = _system()
    monkeypatch.setattr(tbdd, "make_dd_pcg", lambda st: (
        lambda dense, oob, bt, rhs, invd, x0, tol:
        (torch.zeros_like(rhs), 1.0, 60)))
    ts = tdriver.DistributedSession(8, device="cpu")
    x, r, _it = ts.solve(_blocks(tsolver), b, pk.fixed_mask, pk.fixed_vals,
                         1e-10, coords=coords)
    assert ts._bdd_disabled and ts.ps is not None
    assert r <= 1e-10
    assert np.abs(x - x_ref).max() <= 1e-8 * np.abs(x_ref).max()


def test_magnetostatics_devices_take_band_dd(monkeypatch):
    """The nonlinear 3,000-node benchmark problem with ``devices=2``:
    above the 4*2*128-unknown gate both packages run every linear solve
    on the sharded band engine; A within 1e-6 of max|A| of the JAX
    package's ``devices=2`` solve."""
    setups = []
    real = tbdd.setup_band_dd
    monkeypatch.setattr(tbdd, "setup_band_dd",
                        lambda *a, **k: (setups.append(1), real(*a, **k))[1])
    jp, tp = jbench.build(3000), tbench.build(3000)
    mesh = jmesher.mesh_problem(jp)
    sol = tmodels.solve(tp, mesh, devices=2, device="cpu", hbm_bytes=1e9)
    jsol = jmag.solve(jp, mesh, devices=2)
    assert setups == [1]
    assert sol.residual <= tp.Precision and sol.newton_iterations > 1
    assert np.abs(sol.A - jsol.A).max() <= 1e-6 * np.abs(jsol.A).max()
