"""The bf16 fine operator: the port's ``band.band_fgmres`` (one GMRES(m)
cycle right-preconditioned by the band V-cycle) against the JAX
package's on Temp.fem's hierarchy at a 5e7-byte device, and the whole
Temp.fem solve at that plan against the JAX package's band engine and
Temp.ans.golden."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax.numpy as jnp

from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.io import ansfile
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import magnetostatics as jmag
from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import pallas_band
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch import convert
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files as tread_mesh
from xfemm_tpu_torch.models import magnetostatics as tmag
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import solver as tsolver

HBM = 5e7

torch.set_num_threads(1)


@pytest.fixture
def jax_bf16_plan(monkeypatch):
    """The JAX package's band engine on the CPU backend at a 5e7-byte
    device (its ``XFEMM_TPU_FORCE_BAND=1`` configuration), f32 device
    arithmetic, the host Newton chain in both packages."""
    monkeypatch.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")
    monkeypatch.delenv("XFEMM_TPU_PALLAS", raising=False)
    monkeypatch.setattr(pallas_band, "INTERPRET", True)
    jband._pallas_enabled.cache_clear()
    monkeypatch.setattr(jsolver, "device_f64_ok", lambda: False)
    monkeypatch.setattr(jsolver, "band_platform_ok", lambda: True)
    monkeypatch.setattr(jsolver, "device_hbm_bytes", lambda: HBM)
    caches = (jsolver._BAND_CACHE, tsolver._BAND_CACHE, jmag._PACK_CACHE,
              tmag._PACK_CACHE)
    for cache in caches:
        cache.clear()
    yield
    for cache in caches:
        cache.clear()
    jband._pallas_enabled.cache_clear()


def test_band_fgmres_matches_jax(fixtures, jax_bf16_plan, monkeypatch):
    """One GMRES(24) cycle on the first correction system of Temp.fem's
    5e7-byte plan (a bf16 fine band), carried across with
    ``convert.band_amg``. The plan's own hierarchy has no prolongator
    band, where the port's transfers are the smoothed prolongator's and
    the JAX package's plain aggregation (ROADMAP C.1), so both packages
    get the same fine operator under a hierarchy built with P bands on
    every level (no budget cap, dense bottom): the same V-cycle. The
    JAX package solves the least-squares problem in f32 and the port in
    f64: x to 3e-3 of its norm, the least-squares residual to 1e-3."""
    seen = {}
    real_setup, real_fgmres = jband.setup_band_amg, jband.band_fgmres

    def setup(At, **kw):
        seen["setup"] = (At, kw)
        return real_setup(At, **kw)

    def first_cycle(amg, b, m=16):
        seen["cycle"] = (amg, b)
        raise KeyboardInterrupt

    monkeypatch.setattr(jband, "setup_band_amg", setup)
    monkeypatch.setattr(jband, "band_fgmres", first_cycle)
    with pytest.raises(KeyboardInterrupt):
        jmag.solve(jfemfile.load(str(fixtures / "Temp.fem")),
                   jread_mesh(str(fixtures / "Temp")))
    At, kw = seen["setup"]
    amg0, b = seen["cycle"]
    assert amg0.levels[0].A.dense.dtype == jnp.bfloat16
    assert amg0.levels[0].P is None
    kw.update(budget_bytes=None, bt_coarse_budget=0.0,
              bt_transient_budget=None)
    jamg, _ = real_setup(At, **kw)
    assert all(lv.P is not None for lv in jamg.levels)
    assert jamg.levels[0].A.dense.dtype == jnp.bfloat16
    tamg = convert.band_amg(jamg)
    xj, rj, mj = real_fgmres(jamg, b, m=24)
    xt, rt, mt = tband.band_fgmres(tamg, torch.as_tensor(np.array(b)), 24)
    xj = np.asarray(xj)
    assert mt == int(mj) == 24
    assert abs(rt - float(rj)) <= 1e-3 and 0.0 < rt < 0.5
    assert np.linalg.norm(xt.numpy() - xj) <= 3e-3 * np.linalg.norm(xj)


def test_temp_bf16_matches_jax_and_golden(fixtures, jax_bf16_plan):
    """Temp.fem through ``magnetostatics.solve`` at the 5e7-byte plan
    (bf16 fine operator: GMRES(24) passes with two tolerated stalls,
    then, as in the JAX package, the latch-off to ELL-AMG): the
    contract residual, A within 1e-5 of the JAX package's, and
    Temp.ans.golden to 1e-5."""
    jsol = jmag.solve(jfemfile.load(str(fixtures / "Temp.fem")),
                      jread_mesh(str(fixtures / "Temp")))
    mesh = tread_mesh(str(fixtures / "Temp"))
    tsol = tmag.solve(tfemfile.load(str(fixtures / "Temp.fem")), mesh,
                      device="cpu", hbm_bytes=HBM)
    assert tsol.residual <= 1e-8 and np.isfinite(tsol.A).all()
    scale = np.abs(jsol.A).max()
    assert np.abs(tsol.A - jsol.A).max() <= 1e-5 * scale
    sess = next(iter(tmag._PACK_CACHE.values()))[2][("sess", "cpu")]
    assert sess.plan["fine_dtype"] == "bf16"
    g = ansfile.read_ans(str(fixtures / "Temp.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    Ag = np.real(g.values)
    assert d.max() < 1e-12
    assert np.abs(tsol.A[idx] - Ag).max() / np.abs(Ag).max() < 1e-05
