"""Electrostatics of the PyTorch port (models/electrostatics.py) against
the JAX package and the reference's golden solution, on the CPU.

The port runs with ``device="cpu"`` and an explicit ``hbm_bytes``.
ElecTest (the reference test suite's test.fee: an axisymmetric capacitor
with two fixed-voltage conductors, 2,525 nodes) is solved on the port's
band engine and on its ELL-AMG engine; the JAX package runs its f32 band
engine forced as its own tests force it (tests/test_heat_electro.py),
from the same ``ROW_TILE_MIN`` as the port. Tolerances: V within 5e-6
of max|V| of the golden .res (the JAX package's own bound) and 1e-6 of
the JAX package's; conductor voltages within 1e-6 and charges within
1e-6 relative of the golden's.
"""

import collections

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.io import ansfile
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import electrostatics as jelec
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch import models as tmodels
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files as tread_mesh
from xfemm_tpu_torch.models import electrostatics as telec
from xfemm_tpu_torch.ops import solver as tsolver

HBM = 16e9
ON_CPU = dict(device="cpu", hbm_bytes=HBM)

torch.set_num_threads(1)


@pytest.fixture
def engines(monkeypatch):
    """Both packages on the band engine from 4 x 64 unknowns (the JAX
    package's f32 engine forced), fresh caches; the port's CPU path
    fails on any CUDA call. Returns the monkeypatch."""
    monkeypatch.setattr(jsolver, "device_f64_ok", lambda: False)
    monkeypatch.setattr(jsolver, "band_platform_ok", lambda: True)
    monkeypatch.setattr(jsolver, "device_hbm_bytes", lambda: HBM)
    for mod in (jsolver, tsolver):
        monkeypatch.setattr(mod, "ROW_TILE_MIN", 64)
        for name in ("_BAND_CACHE", "_PATTERN_CACHE"):
            monkeypatch.setattr(mod, name, collections.OrderedDict())

    def no_cuda(*a, **k):
        raise AssertionError("a CPU run touched CUDA")

    for name in ("is_available", "mem_get_info", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    return monkeypatch


def elec_test(fixtures, pkg):
    if pkg == "j":
        return (jfemfile.load(str(fixtures / "ElecTest.fee")),
                jread_mesh(str(fixtures / "ElecTest")))
    return (tfemfile.load(str(fixtures / "ElecTest.fee")),
            tread_mesh(str(fixtures / "ElecTest")))


def check_golden(fixtures, mesh, sol):
    """V within 5e-6 of max|V| of the golden .res, the conductor
    voltages within 1e-6 and the charges within 1e-6 relative."""
    g = ansfile.read_ans(str(fixtures / "ElecTest.res.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-12
    scale = np.abs(g.values).max()
    assert np.abs(sol.V[idx] - g.values).max() / scale < 5e-6
    assert len(g.conductor_results) == len(sol.conductor_V) == 2
    for (gv, gq), ov, oq in zip(g.conductor_results, sol.conductor_V,
                                sol.conductor_q):
        assert abs(ov - gv) <= 1e-6 * max(1.0, abs(gv))
        assert abs(oq - gq) <= 1e-6 * max(abs(gq), 1e-12)


@pytest.mark.parametrize("engine", ["band", "ell-amg"])
def test_electest_matches_jax_and_golden(fixtures, engines, engine):
    """ElecTest through ``models.solve`` on the port's band engine (and,
    with ``ROW_TILE_MIN`` raised past its size, its ELL-AMG engine):
    the contract residual, the golden .res and its conductor results,
    and the JAX package's V, node Q and conductor results (1e-6)."""
    engaged = []
    if engine == "ell-amg":
        engines.setattr(tsolver, "ROW_TILE_MIN", 1024)
    real = tsolver._prepare_band
    engines.setattr(tsolver, "_prepare_band",
                    lambda *a, **k: (engaged.append(1), real(*a, **k))[1])
    p, mesh = elec_test(fixtures, "t")
    sol = tmodels.solve(p, mesh, **ON_CPU)
    jsol = jelec.solve(*elec_test(fixtures, "j"))
    assert bool(engaged) == (engine == "band")
    assert sol.residual <= p.Precision and np.isfinite(sol.V).all()
    check_golden(fixtures, mesh, sol)
    assert np.abs(sol.V - jsol.V).max() <= 1e-6 * np.abs(jsol.V).max()
    assert np.array_equal(sol.node_Q, jsol.node_Q)
    assert np.allclose(sol.conductor_V, jsol.conductor_V, rtol=1e-6)
    assert np.allclose(sol.conductor_q, jsol.conductor_q, rtol=1e-6)


def test_total_charge_conductor_matches_jax(fixtures, engines):
    """ElecTest with its 50 V conductor given instead its golden total
    charge (CircType 0: its nodes merged into one reduced DOF, the
    charge on that DOF's right-hand side): the conductor floats back to
    50 V within 1e-4 relative, and V and the conductor results agree
    with the JAX package's within 1e-6."""
    g = ansfile.read_ans(str(fixtures / "ElecTest.res.golden"))
    q50 = g.conductor_results[0][1]
    sols = []
    for key, solve, kw in (("t", telec.solve, ON_CPU),
                           ("j", jelec.solve, {})):
        p, mesh = elec_test(fixtures, key)
        c = p.circproplist[0]
        assert c.V == 50.0
        c.CircType, c.q = 0, q50
        sols.append(solve(p, mesh, **kw))
    sol, jsol = sols
    assert sol.residual <= p.Precision
    assert abs(sol.conductor_V[0] - 50.0) <= 1e-4 * 50.0
    assert sol.conductor_q[0] == q50
    assert np.abs(sol.V - jsol.V).max() <= 1e-6 * np.abs(jsol.V).max()
    assert np.allclose(sol.conductor_V, jsol.conductor_V, rtol=1e-6)
    assert np.allclose(sol.conductor_q, jsol.conductor_q, rtol=1e-6)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(device_mesh=object()), TypeError, "device_mesh"),
    (dict(devices=2, device_mesh=["cpu", "meta"]), NotImplementedError,
     "C.17")], ids=["kw0", "kw1"])
def test_domain_decomposition_raises(fixtures, kw, exc, match):
    """A ``device_mesh`` that is not a device (or a list of them) names
    the parameter; one that names several distinct devices names the
    missing multi-card communicator (ROADMAP C.17), also through the
    dispatch."""
    p, mesh = elec_test(fixtures, "t")
    with pytest.raises(exc, match=match):
        tmodels.solve(p, mesh, **kw, **ON_CPU)


@pytest.mark.parametrize("devices", [2, 8])
def test_domain_decomposition_matches_jax_and_golden(fixtures, engines,
                                                     devices):
    """ElecTest with ``devices=N`` through the dispatch (the capacitor's
    r-weighted operator, on which the Schwarz V-cycle may latch off to
    Jacobi in both packages): the golden .res and its conductor results,
    and the JAX package's ``devices=N`` V (1e-6)."""
    p, mesh = elec_test(fixtures, "t")
    sol = tmodels.solve(p, mesh, devices=devices, **ON_CPU)
    jsol = jelec.solve(*elec_test(fixtures, "j"), devices=devices)
    assert sol.residual <= p.Precision
    check_golden(fixtures, mesh, sol)
    assert np.abs(sol.V - jsol.V).max() <= 1e-6 * np.abs(jsol.V).max()
    assert np.allclose(sol.conductor_q, jsol.conductor_q, rtol=1e-6)


def test_ei_verbs_round_trip_matches_jax(fixtures, engines):
    """ElecTest through the pyFEMM verbs (open on the CPU path,
    ``ei_analyze`` -- which meshes --, ``ei_loadsolution``, point values
    and the 50 V conductor's properties) in the port and in the JAX
    package: the same mesher, so the same mesh; every value within 1e-6
    relative (the field components within 1e-6 of their largest)."""
    import xfemm_tpu.femm_compat as jfemm
    import xfemm_tpu_torch.femm_compat as tfemm

    out = {}
    for name, femm, kw in (("port", tfemm, ON_CPU), ("jax", jfemm, {})):
        femm.opendocument(str(fixtures / "ElecTest.fee"), **kw)
        femm.ei_analyze()
        femm.ei_loadsolution()
        pv = femm.eo_getpointvalues(0.1, 0.0)
        cp = femm.eo_getconductorproperties("m1t")
        out[name] = (np.asarray(pv, float), np.asarray(cp, float))
    (tv, tc), (jv, jc) = out["port"], out["jax"]
    assert np.isfinite(tv).all() and 1.0 < tv[0] < 49.0
    assert abs(tv[0] - jv[0]) <= 1e-6 * abs(jv[0])
    assert np.abs(tv[1:5] - jv[1:5]).max() <= 1e-6 * np.abs(jv[1:5]).max()
    assert np.allclose(tc, jc, rtol=1e-6)
