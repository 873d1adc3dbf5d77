"""The slice as a whole: the port's nonlinear magnetostatic solve
(host Newton chain, band + block-tridiagonal engine, kernels on their
plain CPU path) against the JAX package on the same problems and the
reference fsolver's golden solution.

The JAX package runs the same configuration: f32 device arithmetic
(``device_f64_ok`` False), the band engine on the CPU backend
(``band_platform_ok`` True), the host-driven Newton chain
(``XFEMM_TPU_NO_DEVICE_NEWTON=1``), and the same explicit device memory
size for the band planner in both packages."""

import numpy as np
import pytest
import scipy.sparse as sp
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

    g = ansfile.read_ans(str(fixtures / "Temp.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-12
    Ag = np.real(g.values)
    assert np.abs(tsol.A[idx] - Ag).max() / np.abs(Ag).max() < 1e-05
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


def test_unported_regimes_raise(fixtures, jax_band_engine):
    # the small-problem path
    n = 100
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (n, n)).tocoo()
    blk = tsolver.ElementBlock(idx=np.stack([A.row, A.col], 1)[:, :1],
                               sign=np.ones((A.nnz, 1)),
                               mat=A.data[:, None, None])
    with pytest.raises(NotImplementedError, match="4\\*ROW_TILE_MIN"):
        tsolver.solve([blk], np.ones(n), np.zeros(n, bool), np.zeros(n),
                      1e-8, coords=np.zeros((n, 2)), device="cpu",
                      hbm=HBM)
    # symmetric storage / band-AMG V-cycle / no storage tier: plans of a
    # smaller device
    p = tfemfile.load(str(fixtures / "Temp.fem"))
    mesh = tread_mesh(str(fixtures / "Temp"))
    for hbm, what in ((2e8, "V-cycle"), (1.5e8, "symmetric"),
                      (1e6, "no band storage tier")):
        tsolver._BAND_CACHE.clear()
        tmag._PACK_CACHE.clear()
        with pytest.raises(NotImplementedError, match=what):
            tmag.solve(p, mesh, device="cpu", hbm_bytes=hbm)
    # symmetric band product and the COO sidecar
    bm = tband.BandMatrix(dense=torch.zeros(1, 128, 128), shift0=0,
                          cchunk=128, ncols=128)
    x = torch.zeros(128)
    with pytest.raises(NotImplementedError, match="triu"):
        tband.band_apply(bm, x, x)
    with pytest.raises(NotImplementedError, match="sidecar"):
        tband.band_apply(bm, None, x, oob=object())


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert tsolver.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tsolver.resolve_device()
    with pytest.raises(ValueError):
        tsolver.device_hbm_bytes("cpu")
    assert tsolver.device_hbm_bytes("cpu", 5e9) == 5e9
