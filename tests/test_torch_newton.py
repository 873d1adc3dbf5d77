"""The device Newton loop (``ops/newton.py``) of the port against the JAX
package's on the CPU: the element update, the device data ``setup``
builds, the operator refresh of both modes, and ``run`` /
``run_scatter`` from the same state.

Each loop test drives both packages' solves (the band engine forced as
in test_torch_magnetostatics.py, the device loop on) up to their first
loop call and starts both loops from the JAX package's state there.
Holding the two loops' Newton steps to 1e-5 needs a step whose residual
is not rounding noise: one step of the 10k problem does, but past the
loop's f32 displacement floor (~1e-6 there, ~1e-3 on Temp.fem's first
systems) the trajectory is decided by rounding, and the JAX package's
own loop changes its step count, CG count and exit residual when its
start vector moves by 1e-7 (Temp.fem: 7 steps / 11 CG / res 9.3e-4
against 7 / 12 / 3.6e-3). So the real loops are held over ONE step,
and the loop logic over many steps (relaxation, stall and budget exits,
the chained scatter steps) with a deterministic stand-in for the inner
CG in both packages (half a Jacobi sweep, one "iteration")."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.mesh import mesher as jmesher
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu.models import magnetostatics as jmag
from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import newton as jnewton
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch.constants import C_APOT
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files as tread_mesh
from xfemm_tpu_torch.models import benchprob as tbench
from xfemm_tpu_torch.models import magnetostatics as tmag
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import blocktri as tbt
from xfemm_tpu_torch.ops import newton as tnewton
from xfemm_tpu_torch.ops import solver as tsolver

torch.set_num_threads(1)

#: band layouts of Temp.fem: (device memory, triu storage, RCB parts).
#: "full": the bt-alone full band; "triu": the V-cycle with the fine
#: level stored triu (SYM_MIN_BYTES = 0 in both packages); "sidecar":
#: a partitioned ordering (pick_parts = 2 in both packages, a test
#: setting: Temp is below the size that partitions) whose cross-part
#: couplings ride the fine level's COO sidecar
LAYOUTS = {"full": (16e9, False, 0), "triu": (1.5e8, True, 0),
           "sidecar": (1.5e8, False, 2)}


@pytest.fixture
def fused_engine(monkeypatch):
    """Both packages on the band engine with the device loop on."""
    monkeypatch.delenv("XFEMM_TPU_NO_DEVICE_NEWTON", raising=False)
    monkeypatch.setattr(jsolver, "device_f64_ok", lambda: False)
    monkeypatch.setattr(jsolver, "band_platform_ok", lambda: True)
    caches = (jsolver._BAND_CACHE, tsolver._BAND_CACHE, jmag._PACK_CACHE,
              tmag._PACK_CACHE)
    for cache in caches:
        cache.clear()
    yield monkeypatch
    for cache in caches:
        cache.clear()


class _Stop(Exception):
    pass


_REAL = {"j": {"run": jnewton.run, "run_scatter": jnewton.run_scatter},
         "t": {"run": tnewton.run, "run_scatter": tnewton.run_scatter}}


def _first_calls(mp, fixtures, problem="temp", hbm=16e9, triu=False,
                 parts=0):
    """Drive both packages' solves up to their first device-loop call
    and return ``{"j": (name, args, kwargs), "t": (...)}``."""
    mp.setattr(jsolver, "device_hbm_bytes", lambda: hbm)
    if triu:
        mp.setattr(jband, "SYM_MIN_BYTES", 0)
        mp.setattr(tband, "SYM_MIN_BYTES", 0)
    if parts:
        mp.setattr(jband, "pick_parts", lambda n, **kw: parts)
        mp.setattr(tband, "pick_parts", lambda n, **kw: parts)
    seen = {}
    for key, mod in (("j", jnewton), ("t", tnewton)):
        for name in ("run", "run_scatter"):
            def stop(*a, _k=key, _n=name, **kw):
                seen[_k] = (_n, a, kw)
                raise _Stop
            mp.setattr(mod, name, stop)
    if problem == "temp":
        jp = (jfemfile.load(str(fixtures / "Temp.fem")),
              jread_mesh(str(fixtures / "Temp")))
        tp = (tfemfile.load(str(fixtures / "Temp.fem")),
              tread_mesh(str(fixtures / "Temp")))
    else:
        mesh = jmesher.mesh_problem(jbench.build(10_000))
        jp, tp = (jbench.build(10_000), mesh), (tbench.build(10_000), mesh)
    with pytest.raises(_Stop):
        jmag.solve(*jp)
    with pytest.raises(_Stop):
        tmag.solve(*tp, device="cpu", hbm_bytes=hbm)
    for key, mod in (("j", jnewton), ("t", tnewton)):
        for name in ("run", "run_scatter"):
            mp.setattr(mod, name, _REAL[key][name])
    return seen


def _np(a):
    return None if a is None else np.asarray(a)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------- #
# element update                                                         #
# ---------------------------------------------------------------------- #

def _random_elements(axi: bool, seed: int = 0):
    """Seeded element data of S elements over n DOFs, lamination types
    0, 1 and 2, |B| inside the B-H table."""
    rng = np.random.default_rng(seed)
    S, n = 90, 60
    idxT = rng.integers(0, n, (S, 3))
    sgnT = rng.choice([-1.0, 1.0], (S, 3))
    q = rng.uniform(-0.3, 0.3, (S, 3))
    p = rng.uniform(-0.3, 0.3, (S, 3))
    area = rng.uniform(0.02, 0.05, S)
    lt = np.arange(S) % 3
    fs = rng.uniform(0.6, 0.98, S)
    knB = np.array([0.0, 0.3, 0.6, 0.9, 1.2, 1.5, 1.8, 2.8])
    knH = np.array([0.0, 60.0, 130.0, 230.0, 420.0, 1200.0, 9000.0,
                    90000.0])
    knS = np.gradient(knH, knB)
    bh = [np.tile(k, (S, 1)) for k in (knB, knH, knS)]
    A = rng.standard_normal((S, 3, 3))
    Mx = -(A + A.transpose(0, 2, 1))
    A = rng.standard_normal((S, 3, 3))
    My = -(A + A.transpose(0, 2, 1))
    if axi:
        q = p = np.zeros((S, 3))
    V = rng.standard_normal(n) * (10.0 if not axi else 2.0)
    f = dict(idxT=idxT, sgnT=sgnT, q=q, p=p, area=area, lt=lt, fs=fs,
             bhB=bh[0], bhH=bh[1], bhS=bh[2], Mx=Mx, My=My)
    return f, V


@pytest.mark.parametrize("axi", [False, True])
@pytest.mark.parametrize("has_lam", [False, True])
def test_newton_elements_match_jax(axi, has_lam):
    f, V = _random_elements(axi)
    ints = ("idxT", "lt")
    jf = {k: jnp.asarray(v.astype(np.int32 if k in ints else np.float32))
          for k, v in f.items()}
    tf = {k: torch.as_tensor(v, dtype=torch.int64 if k in ints
                             else torch.float32) for k, v in f.items()}
    jdn = jnewton.DeviceNewton(**{k: None for k in jnewton.DeviceNewton
                                  ._fields}
                               | jf | {"c": jnp.float32(C_APOT)})
    tdn = tnewton.DeviceNewton(**{k: None for k in tnewton.DeviceNewton
                                  ._fields}
                               | tf | {"c": torch.tensor(C_APOT)})
    Vf = V.astype(np.float32)
    jout = jnewton._newton_elements(jdn, jnp.asarray(Vf), has_lam, axi)
    tout = tnewton._newton_elements(tdn, torch.as_tensor(Vf), has_lam, axi)
    for name, a, b in zip(("Vl", "Me", "Mn"), tout, jout):
        assert np.isfinite(a.numpy()).all()
        assert _rel(a.numpy(), _np(b)) <= 1e-5, name
    # the lamination variants really differ from the isotropic form
    if has_lam:
        iso = tnewton._newton_elements(tdn, torch.as_tensor(Vf), False, axi)
        assert _rel(tout[2].numpy(), iso[2].numpy()) > 1e-3


# ---------------------------------------------------------------------- #
# setup and the operator refresh, per band layout                        #
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_setup_maps_match_jax(fixtures, fused_engine, layout):
    """The DeviceNewton ``setup`` builds on the same problem and band
    layout: every field the port carries equals the JAX package's
    (integer maps exactly, f32 values to 1e-6 of their largest)."""
    hbm, triu, parts = LAYOUTS[layout]
    seen = _first_calls(fused_engine, fixtures, hbm=hbm, triu=triu,
                        parts=parts)
    jdn, tdn = seen["j"][1][0], seen["t"][1][0]
    checked = 0
    for name in tnewton.DeviceNewton._fields:
        a, b = getattr(tdn, name), _np(getattr(jdn, name))
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a = a.numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind in "iu":
            assert np.array_equal(a, b), name
        else:
            assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1e-30), \
                name
        checked += 1
    assert checked >= 30
    assert (tdn.dvec_rows is not None) == triu
    assert (tdn.oob_upd_pos is not None) == (layout == "sidecar")
    # the maps alone, as _band_refresh_maps returns them
    sess = next(v for k, v in next(iter(tmag._PACK_CACHE.values()))[2]
                .items() if k[0] == "sess")
    pk = next(iter(tmag._PACK_CACHE.values()))[1][0]
    maps = tnewton._band_refresh_maps(sess, pk.fixed_mask, "cpu")
    assert np.array_equal(maps["ns"], np.nonzero(pk.nonlinear)[0])
    assert np.array_equal(maps["fields"]["delta_rows"].numpy(),
                          tdn.delta_rows.numpy())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_refresh_operator_matches_scatter_and_jax(fixtures, fused_engine,
                                                  monkeypatch, layout):
    """The operator after the element update at one V, three ways: the
    port's merged-sidecar operator over the frozen band
    (``_refresh_operator``), the port's band refreshed in place by
    ``run_scatter`` (the same tensor, same storage), and the JAX
    package's merged-sidecar operator; to 1e-6 of max|y|."""
    hbm, triu, parts = LAYOUTS[layout]
    seen = _first_calls(fused_engine, fixtures, hbm=hbm, triu=triu,
                        parts=parts)
    _n, (jdn, jamg, jdense, jV, _js), jkw = seen["j"]
    _n, (tdn, tamg, _tV, _ts), tkw = seen["t"]
    V = 1.5 * np.asarray(jV)          # away from the frozen operator
    x = np.random.default_rng(3).standard_normal(V.size).astype(np.float32)
    xt = torch.as_tensor(x)

    # JAX: merged sidecar over its frozen band
    lj = jamg.levels[0]
    R = jdense.shape[1]
    jent = jdense[jdn.delta_brows // R, jdn.delta_brows % R,
                  jdn.delta_bcols].astype(jnp.float32)
    jcur = jband.BandAMG(
        levels=(lj._replace(A=jband.BandMatrix(jdense, lj.A.shift0,
                                               lj.A.cchunk, lj.A.ncols),
                            Abf=None),) + jamg.levels[1:],
        coarse_inv=jamg.coarse_inv, n=jamg.n, bt_coarse=jamg.bt_coarse)
    _vl, jMe, _mn = jnewton._newton_elements(jdn, jnp.asarray(V),
                                             jkw["has_lam"])
    jnew, _c, _o = jnewton._refresh_operator(jdn, jcur, jMe, jent)
    ln = jnew.levels[0]
    y_j = np.asarray(jband.band_apply(ln.A, ln.dvec, jnp.asarray(x), ln.oob))

    # the port: merged sidecar over the frozen band
    lt = tamg.levels[0]
    d2 = lt.A.dense.view(-1, lt.A.dense.shape[2])
    tent = d2[tdn.delta_brows, tdn.delta_bcols]
    _vl, tMe, _mn = tnewton._newton_elements(tdn, torch.as_tensor(V),
                                             tkw["has_lam"])
    tnew, _c, _o = tnewton._refresh_operator(tdn, tamg, tMe, tent)
    ln = tnew.levels[0]
    y_m = tband.band_apply(ln.A, ln.dvec, xt, ln.oob).numpy()

    y0 = tband.band_apply(lt.A, lt.dvec, xt, lt.oob).numpy()

    # the port: run_scatter's in-place refresh (a zero inner solve)
    monkeypatch.setattr(tnewton, "_inner_solve",
                        lambda amg, r, tol, it, bt, n: (torch.zeros_like(r),
                                                        0))
    ptr = lt.A.dense.data_ptr()
    state = torch.tensor([1.0, 1.0, 0.0, 1.0])
    _V, dvec, oob_vals, _st = tnewton.run_scatter(
        tdn, tamg, torch.as_tensor(V), state, bt=tkw["bt"],
        has_lam=tkw["has_lam"])
    assert lt.A.dense.data_ptr() == ptr
    assert dvec is lt.dvec and (oob_vals is None) == (lt.oob is None)
    y_s = tband.band_apply(lt.A, lt.dvec, xt, lt.oob).numpy()

    scale = np.abs(y_j).max()
    assert np.abs(y_m - y_s).max() <= 1e-6 * scale
    assert np.abs(y_m - y_j).max() <= 1e-6 * scale
    # the refresh moved the operator (the comparison is not vacuous)
    assert np.abs(y0 - y_s).max() > 1e-5 * scale


# ---------------------------------------------------------------------- #
# run and run_scatter from the same state                                #
# ---------------------------------------------------------------------- #

def _stats_close(ts, js, tol=1e-4):
    ts, js = np.asarray(ts, np.float64), np.asarray(js, np.float64)
    assert ts[3] == js[3] and ts[4] == js[4]        # steps, CG total
    for i in range(3):                               # relax, res, lastres
        assert abs(ts[i] - js[i]) <= tol * abs(js[i]), i


@pytest.mark.parametrize("mode", ["run", "run_scatter"])
def test_one_step_matches_jax(fixtures, fused_engine, mode):
    """One Newton step of the real loop (its block-tridiagonal PCG
    included) on the 10k problem, both packages from the JAX package's
    state at its first loop call: V within 1e-5 of max|V|, the same
    step and CG counts, relax / res / lastres within 1e-4."""
    seen = _first_calls(fused_engine, fixtures, problem="bench")
    _n, (jdn, jamg, jdense, jV, jstate), jkw = seen["j"]
    _n, (tdn, tamg, _V, _s), tkw = seen["t"]
    V = torch.as_tensor(np.asarray(jV))
    state = torch.as_tensor(np.asarray(jstate))
    common = dict(tol_floor=jkw["tol_floor"], has_lam=jkw["has_lam"])
    if mode == "run":
        jout = jnewton.run(jdn, jamg, jdense, jV, jstate, bt=jkw["bt"],
                           target_res=jkw["target_res"], max_steps=1,
                           cg_budget=jkw["cg_budget"], **common)
        tout = tnewton.run(tdn, tamg, V, state, bt=tkw["bt"],
                           target_res=tkw["target_res"], max_steps=1,
                           cg_budget=tkw["cg_budget"], **common)
    else:
        jout = jnewton.run_scatter(jdn, jamg, jdense, jV, jstate,
                                   bt=jkw["bt"], inner_iter=230, **common)
        tout = tnewton.run_scatter(tdn, tamg, V, state, bt=tkw["bt"],
                                   inner_iter=230, **common)
    jVo = np.asarray(jout[0])
    assert np.abs(tout[0].numpy() - jVo).max() <= 1e-5 * np.abs(jVo).max()
    _stats_close(tout[-1].numpy(), _np(jout[-1]))
    assert tout[-1][3] == 1 and tout[-1][4] >= 1


def _jacobi_stubs(monkeypatch):
    """Half a Jacobi sweep as the inner solve, one "iteration", in both
    packages: the loop's arithmetic around it is then deterministic to
    f32 rounding over many steps."""
    def jstub(amg_new, r, tol, inner_iter, bt, n):
        return 0.5 * amg_new.levels[0].invd * r, jnp.array(1, jnp.int32)

    def tstub(amg_new, r, tol, inner_iter, bt, n):
        return 0.5 * amg_new.levels[0].invd * r, 1

    monkeypatch.setattr(jnewton, "_inner_solve", jstub)
    monkeypatch.setattr(tnewton, "_inner_solve", tstub)
    # a static argument no other test uses: a fresh trace of the JAX loop
    return 397


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("budget", [0, 4])
def test_run_logic_matches_jax(fixtures, fused_engine, monkeypatch, layout,
                               budget):
    """``run`` over up to 9 steps from half the it-0 solution (far from
    the root, so the residuals are not rounding noise) with the Jacobi
    stand-in:
    the relaxation rule activating at global iteration 6 (base_it 3),
    the 5%-improvement stall exit, and (budget 4) the CG-budget exit,
    against the JAX loop: V within 1e-5 of max|V|, the same step and CG
    counts, relax / res / lastres within 1e-4; the triu diagonal and the
    sidecar values it returns as well."""
    hbm, triu, parts = LAYOUTS[layout]
    seen = _first_calls(fused_engine, fixtures, hbm=hbm, triu=triu,
                        parts=parts)
    _n, (jdn, jamg, jdense, jV, _js), jkw = seen["j"]
    _n, (tdn, tamg, _V, _s), tkw = seen["t"]
    inner = _jacobi_stubs(monkeypatch)
    st = np.array([0.5, 1.0, 0.0, 3.0], np.float32)
    V0 = 0.5 * np.asarray(jV)
    jnewton.run.clear_cache()
    jout = jnewton.run(jdn, jamg, jdense, jnp.asarray(V0), jnp.asarray(st),
                       bt=jkw["bt"], has_lam=jkw["has_lam"], max_steps=9,
                       inner_iter=inner, cg_budget=budget)
    jnewton.run.clear_cache()
    tout = tnewton.run(tdn, tamg, torch.as_tensor(V0), torch.as_tensor(st),
                       bt=tkw["bt"], has_lam=tkw["has_lam"], max_steps=9,
                       inner_iter=inner, cg_budget=budget)
    jVo = np.asarray(jout[0])
    assert np.abs(tout[0].numpy() - jVo).max() <= 1e-5 * np.abs(jVo).max()
    ts = tout[-1].numpy()
    _stats_close(ts, _np(jout[-1]))
    assert ts[3] == (4 if budget else ts[3]) and ts[3] >= 4
    assert ts[0] != st[0]             # the relaxation rule acted
    for t_arr, j_arr in ((tout[1], jout[2]), (tout[2], jout[3])):
        if t_arr is None:
            assert _np(j_arr) is None or _np(j_arr).size == 0
            continue
        assert _rel(t_arr.numpy(), _np(j_arr)) <= 1e-5


@pytest.mark.parametrize("layout", ["full", "triu"])
def test_scatter_chain_matches_jax(fixtures, fused_engine, monkeypatch,
                                   layout):
    """Six chained ``run_scatter`` steps from half the it-0 solution with
    the Jacobi stand-in, the state threaded as the solve's chain does, against the
    JAX package's: V within 1e-5, stats within 1e-4, and the band
    refreshed in place to the JAX package's returned band (1e-6)."""
    hbm, triu, parts = LAYOUTS[layout]
    seen = _first_calls(fused_engine, fixtures, hbm=hbm, triu=triu,
                        parts=parts)
    _n, (jdn, jamg, jdense, jV, _js), jkw = seen["j"]
    _n, (tdn, tamg, _V, _s), tkw = seen["t"]
    inner = _jacobi_stubs(monkeypatch)
    jnewton.run_scatter.clear_cache()
    ptr = tamg.levels[0].A.dense.data_ptr()
    jVc = 0.5 * jV
    tVc = torch.as_tensor(np.asarray(jVc))
    st = np.array([0.5, 1.0, 0.0, 3.0], np.float32)
    jst, tst = st.copy(), st.copy()
    for _ in range(6):
        jVc, jdense, _d, _o, js = jnewton.run_scatter(
            jdn, jamg, jdense, jVc, jnp.asarray(jst), bt=jkw["bt"],
            has_lam=jkw["has_lam"], inner_iter=inner)
        tVc, _d, _o, ts = tnewton.run_scatter(
            tdn, tamg, tVc, torch.as_tensor(tst), bt=tkw["bt"],
            has_lam=tkw["has_lam"], inner_iter=inner)
        js, ts = np.asarray(js), ts.numpy()
        _stats_close(ts, js)
        jst = np.array([js[0], js[1], js[2], jst[3] + 1], np.float32)
        tst = np.array([ts[0], ts[1], ts[2], tst[3] + 1], np.float32)
    jnewton.run_scatter.clear_cache()
    assert tst[0] != st[0]            # the relaxation rule acted
    jVo = np.asarray(jVc)
    assert np.abs(tVc.numpy() - jVo).max() <= 1e-5 * np.abs(jVo).max()
    dense = tamg.levels[0].A.dense
    assert dense.data_ptr() == ptr
    jd = np.asarray(jdense)
    assert np.abs(dense.numpy() - jd).max() <= 1e-6 * np.abs(jd).max()


def test_inner_solve_dispatch(monkeypatch):
    """Which solver the loop's inner solve calls: bt_pcg with a
    standalone factor, band_pcg with the factor as the V-cycle smoother
    (stall window 48, as the JAX package), band_pcg alone without one;
    on a bf16 fine operator band_fgmres(24), restarted from the
    recomputed residual at most four times (a stand-in: one that never
    contracts runs all four, an exact one stops after the first)."""
    calls = []
    monkeypatch.setattr(tband, "band_pcg", lambda *a, **kw: (
        calls.append(("band_pcg", kw)) or (a[3], 0.0, 2)))
    monkeypatch.setattr(tbt, "bt_pcg", lambda *a, **kw: (
        calls.append(("bt_pcg", kw)) or (a[6], 0.0, 3)))
    A = tband.BandMatrix(torch.zeros((1, 4, 4)), 0, 4, 4)
    lv = tband.BandLevel(A=A, invd=torch.ones(4))
    amg = tband.BandAMG(levels=(lv,), n=4)
    r = torch.ones(4)
    fac = tbt.BTFactor(torch.eye(4)[None], torch.zeros((0, 4, 4)),
                       torch.ones(4))
    assert tnewton._inner_solve(amg, r, 1e-3, 50, fac, 4)[1] == 3
    assert tnewton._inner_solve(amg, r, 1e-3, 50, tbt.BTSmoother(*fac),
                                4)[1] == 2
    assert tnewton._inner_solve(amg, r, 1e-3, 50, None, 4)[1] == 2
    assert [c[0] for c in calls] == ["bt_pcg", "band_pcg", "band_pcg"]
    assert calls[1][1]["stall_window"] == 48
    assert isinstance(calls[1][1]["bt"], tbt.BTSmoother)
    assert "stall_window" not in calls[2][1]
    cycles = []

    def fgmres(amg, rc, m):
        cycles.append(m)
        return exact * rc, 0.0, m

    monkeypatch.setattr(tband, "band_fgmres", fgmres)
    for exact, band, n_cycles in ((0.0, torch.zeros((1, 4, 4)), 4),
                                  (1.0, torch.eye(4)[None], 1)):
        cycles.clear()
        Abf = tband.BandMatrix(band.to(torch.bfloat16), 0, 4, 4)
        amg_bf = tband.BandAMG(levels=(tband.BandLevel(A=Abf,
                                                       invd=torch.ones(4)),),
                               n=4)
        d, its = tnewton._inner_solve(amg_bf, r, 1e-3, 50, fac, 4)
        assert cycles == [24] * n_cycles and its == 24 * n_cycles
        assert torch.equal(d, exact * r)
    assert len(calls) == 3


def test_scatter_chain_ends_at_its_floor(monkeypatch):
    """The scatter chain's one departure from the JAX package's
    (ROADMAP C): it ends once the displacement falls below
    ``magnetostatics.SCATTER_FLOOR`` (the loop's f32 floor), where the
    JAX package's chain steps on to its 9e-7 target or a three-step
    stall. Scripted steps of 7 CG iterations each."""
    script = [1e-3, 9e-5, 5e-5, 3e-5, 4e-5, 3.5e-5, 3.2e-5]
    calls = []

    def scripted(dn, amg, V, state, **kw):
        res = script[len(calls)]
        calls.append(res)
        return V, None, None, torch.tensor([1.0, res, float(state[1]), 1.0,
                                            7.0])

    monkeypatch.setattr(tnewton, "run_scatter", scripted)
    monkeypatch.setenv("XFEMM_TPU_DN_SCATTER_BYTES", "0")

    def chain():
        A = tband.BandMatrix(torch.zeros((1, 4, 4)), 0, 4, 4)
        sess = tsolver.Session()
        sess.band_amg = tband.BandAMG(
            levels=(tband.BandLevel(A=A, invd=torch.ones(4)),), n=4)
        calls.clear()
        return tmag._device_chain(None, False, sess, np.zeros(4), 1.0, 1.0,
                                  0.0, 1.0, 1e-8, "cpu")

    out = chain()
    assert calls == script[:2] and out[4:] == (2, 14.0)
    assert out[2] == float(np.float32(9e-5))      # the f32 displacement
    # the JAX package's rule alone: on to the three-step stall
    monkeypatch.setattr(tmag, "SCATTER_FLOOR", 0.0)
    out = chain()
    assert calls == script and out[4:] == (7, 49.0)
