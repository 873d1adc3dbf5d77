"""The slices as a whole: the port's nonlinear magnetostatic solve
(host Newton chain; the band engine in its bt-alone and band-AMG
V-cycle regimes, with triu storage; kernels on their plain CPU path)
against the JAX package on the same problems and the reference
fsolver's golden solution.

The JAX package runs the same configuration: f32 device arithmetic
(``device_f64_ok`` False), the band engine on the CPU backend
(``band_platform_ok`` True), the host-driven Newton chain
(``XFEMM_TPU_NO_DEVICE_NEWTON=1``), and the same explicit device memory
size for the band planner in both packages."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from xfemm_tpu.io import ansfile
from xfemm_tpu.mesh import mesher as jmesher
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu.models import magnetostatics as jmag
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files as tread_mesh
from xfemm_tpu_torch.models import benchprob as tbench
from xfemm_tpu_torch.models import magnetostatics as tmag
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import solver as tsolver

HBM = 16e9

# the suite runs in several worker processes on a few cores: one torch
# thread each (the plain versions run many small products)
torch.set_num_threads(1)


@pytest.fixture
def jax_band_engine(monkeypatch):
    monkeypatch.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")
    monkeypatch.setattr(jsolver, "device_f64_ok", lambda: False)
    monkeypatch.setattr(jsolver, "band_platform_ok", lambda: True)
    monkeypatch.setattr(jsolver, "device_hbm_bytes", lambda: HBM)
    for cache in (jsolver._BAND_CACHE, tsolver._BAND_CACHE,
                  jmag._PACK_CACHE, tmag._PACK_CACHE):
        cache.clear()
    yield
    for cache in (jsolver._BAND_CACHE, tsolver._BAND_CACHE,
                  jmag._PACK_CACHE, tmag._PACK_CACHE):
        cache.clear()


def _plan(cache):
    entry = next(iter(cache.values()))
    return (tuple(entry["band_amg"].levels[0].A.dense.shape),
            tuple(entry["bt_shape"]))


def _levels(cache):
    """(shape, dtype, triu) of every band level, and the bottom solve."""
    amg = next(iter(cache.values()))["band_amg"]
    return ([(tuple(lv.A.dense.shape), str(lv.A.dense.dtype).split(".")[-1],
              lv.dvec is not None) for lv in amg.levels],
            amg.bt_coarse is not None)


def _check_golden(fixtures, mesh, tsol):
    g = ansfile.read_ans(str(fixtures / "Temp.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-12
    Ag = np.real(g.values)
    assert np.abs(tsol.A[idx] - Ag).max() / np.abs(Ag).max() < 1e-05
    return g


def _compare(jsol, tsol):
    scale = np.abs(jsol.A).max()
    assert np.abs(tsol.A - jsol.A).max() <= 1e-5 * scale
    assert tsol.residual <= 1e-8
    assert np.isfinite(tsol.A).all()
    assert abs(tsol.iterations - jsol.iterations) \
        <= 0.3 * jsol.iterations
    assert _plan(tsolver._BAND_CACHE) == _plan(jsolver._BAND_CACHE)


def test_temp_matches_jax_and_golden(fixtures, jax_band_engine):
    from xfemm_tpu.geometry import femfile as jfemfile
    jsol = jmag.solve(jfemfile.load(str(fixtures / "Temp.fem")),
                      jread_mesh(str(fixtures / "Temp")))
    mesh = tread_mesh(str(fixtures / "Temp"))
    tsol = tmag.solve(tfemfile.load(str(fixtures / "Temp.fem")), mesh,
                      device="cpu", hbm_bytes=HBM)
    _compare(jsol, tsol)
    # the bt-alone regime at this size: band (119, 128, 1152), b=512
    assert _plan(tsolver._BAND_CACHE) == ((119, 128, 1152), (512, 30))
    g = _check_golden(fixtures, mesh, tsol)
    assert np.allclose(tsol.label_case, g.label_case, rtol=1e-09,
                       atol=1e-300)


def test_benchprob_matches_jax(jax_band_engine):
    mesh = jmesher.mesh_problem(jbench.build(10_000))
    jsol = jmag.solve(jbench.build(10_000), mesh)
    tsol = tmag.solve(tbench.build(10_000), mesh, device="cpu",
                      hbm_bytes=HBM)
    _compare(jsol, tsol)
    # a repeat solve adopts the cached band and factor
    again = tmag.solve(tbench.build(10_000), mesh, device="cpu",
                       hbm_bytes=HBM)
    assert np.abs(again.A - tsol.A).max() <= 1e-6 * np.abs(tsol.A).max()


@pytest.mark.parametrize("case", ["temp", "benchprob10k"])
def test_floor_exit_keeps_bt_alone_passes(fixtures, jax_band_engine,
                                          monkeypatch, case):
    """The pass exit the port adds to the JAX package's ``_chunked_pcg``
    (``band.FLOOR_EXIT``: a recurrence drifted from a truth that stopped
    improving) never fires in the bt-alone regime: the solve takes the
    same passes, iteration for iteration, with the exit on and off, and
    on the 10k problem the same total as the JAX package. (On Temp the
    port's second pass contracts further than JAX's from f32 rounding
    alone, so it ends in three passes and 7 iterations where JAX takes
    four and 10, as since the first slice; test_temp_matches_jax_and_golden
    holds that within 30%.)"""
    from xfemm_tpu_torch.ops import blocktri as tbt

    real_bt_pcg = tbt.bt_pcg
    passes = []

    def recorded(*args, **kw):
        out = real_bt_pcg(*args, **kw)
        passes.append(out[2])
        return out

    monkeypatch.setattr(tbt, "bt_pcg", recorded)
    if case == "temp":
        mesh = tread_mesh(str(fixtures / "Temp"))

        def problem():
            return tfemfile.load(str(fixtures / "Temp.fem"))
    else:
        mesh = jmesher.mesh_problem(jbench.build(10_000))

        def problem():
            return tbench.build(10_000)
    runs = {}
    for on in (True, False):
        monkeypatch.setattr(tband, "FLOOR_EXIT", on)
        tsolver._BAND_CACHE.clear()
        tmag._PACK_CACHE.clear()
        passes.clear()
        sol = tmag.solve(problem(), mesh, device="cpu", hbm_bytes=HBM)
        assert sol.residual <= 1e-8
        runs[on] = (list(passes), sol)
    assert runs[True][0] == runs[False][0]
    assert sum(runs[True][0]) == runs[True][1].iterations
    assert np.array_equal(runs[True][1].A, runs[False][1].A)
    if case == "benchprob10k":
        jsol = jmag.solve(jbench.build(10_000), mesh)
        assert runs[True][1].iterations == jsol.iterations


@pytest.mark.parametrize("hbm,triu", [(2e8, False), (1.5e8, False),
                                      (1.5e8, True)])
def test_vcycle_regimes_match_jax(fixtures, jax_band_engine, monkeypatch,
                                  hbm, triu):
    """Temp.fem at the memory sizes whose plans are the band-AMG V-cycle
    with a two-grid block-tridiagonal bottom solve (1.5e8: with the fine
    level's bf16 smoothing copy; 2e8: without). Temp's 70 MB band is
    below SYM_MIN_BYTES, so the triu case sets it to 0 in both packages
    (a test setting): the fine level is then stored triu (K5's path)."""
    from xfemm_tpu.geometry import femfile as jfemfile
    from xfemm_tpu.ops import band as jband
    monkeypatch.setattr(jsolver, "device_hbm_bytes", lambda: hbm)
    if triu:
        monkeypatch.setattr(jband, "SYM_MIN_BYTES", 0)
        monkeypatch.setattr(tband, "SYM_MIN_BYTES", 0)
    jsol = jmag.solve(jfemfile.load(str(fixtures / "Temp.fem")),
                      jread_mesh(str(fixtures / "Temp")))
    mesh = tread_mesh(str(fixtures / "Temp"))
    tsol = tmag.solve(tfemfile.load(str(fixtures / "Temp.fem")), mesh,
                      device="cpu", hbm_bytes=hbm)
    scale = np.abs(jsol.A).max()
    assert np.abs(tsol.A - jsol.A).max() <= 1e-5 * scale
    assert tsol.residual <= 1e-8 and np.isfinite(tsol.A).all()
    assert abs(tsol.iterations - jsol.iterations) \
        <= 0.3 * jsol.iterations
    levels, two_grid = _levels(tsolver._BAND_CACHE)
    assert (levels, two_grid) == _levels(jsolver._BAND_CACHE)
    assert two_grid and levels[0][2] == triu
    entry = next(iter(tsolver._BAND_CACHE.values()))
    assert entry["bt"] is None
    _check_golden(fixtures, mesh, tsol)


def test_stale_factor_dropped_for_vcycle(fixtures, jax_band_engine,
                                         monkeypatch):
    """bt-alone regime whose factor stops contracting once: the solve
    drops it, builds the coarse hierarchy the fine-level-only setup
    skipped, and finishes that pass with the V-cycle (the JAX package's
    "drop stale bt factor, retry V-cycle" step); the next Newton
    iteration finds the V-cycle stale and rebuilds band and factor."""
    from xfemm_tpu_torch.ops import blocktri as tbt

    real_bt_pcg, real_band_pcg = tbt.bt_pcg, tband.band_pcg
    vcycles = []

    def fails_once(Aop, dvec, invd, bt, rhs, tol, x0, max_iter, **kw):
        if not vcycles:
            return torch.zeros_like(rhs), 1.0, 1
        return real_bt_pcg(Aop, dvec, invd, bt, rhs, tol, x0, max_iter,
                           **kw)

    def band_pcg(amg, *args, **kw):
        vcycles.append((len(amg.levels), amg.bt_coarse is not None
                        or amg.coarse_inv is not None))
        return real_band_pcg(amg, *args, **kw)

    monkeypatch.setattr(tbt, "bt_pcg", fails_once)
    monkeypatch.setattr(tband, "band_pcg", band_pcg)
    mesh = tread_mesh(str(fixtures / "Temp"))
    tsol = tmag.solve(tfemfile.load(str(fixtures / "Temp.fem")), mesh,
                      device="cpu", hbm_bytes=HBM)
    assert vcycles and all(bottom for _n, bottom in vcycles)
    assert tsol.residual <= 1e-8
    _check_golden(fixtures, mesh, tsol)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert tsolver.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tsolver.resolve_device()
    with pytest.raises(ValueError):
        tsolver.device_hbm_bytes("cpu")
    assert tsolver.device_hbm_bytes("cpu", 5e9) == 5e9
