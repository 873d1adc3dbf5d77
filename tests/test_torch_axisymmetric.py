"""Axisymmetric magnetostatics of the PyTorch port against the JAX
package and the reference's golden solution, on the CPU.

The port runs with ``device="cpu"`` and an explicit ``hbm_bytes`` (the
``cpu_only`` fixture fails the test on any CUDA call). AxiSolenoid.fem
(a nonlinear steel rod on the axis inside a coil, 6,415 nodes) is solved
on the host Newton chain, on the device loop (``newton.run`` with
``axi=True``) and in the loop's scatter mode; each is held to
AxiSolenoid.ans.golden and to the JAX package's solve at 1e-6 of max|A|.
The JAX package's band engine and device loop are forced on the CPU as
its own tests force them (tests/test_axisymmetric.py)."""

import collections

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.io import ansfile
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import axisymmetric as jaxi
from xfemm_tpu.ops import assembly as jasm
from xfemm_tpu.ops import newton as jnewton
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files as tread_mesh
from xfemm_tpu_torch.models import axisymmetric as taxi
from xfemm_tpu_torch.models import magnetostatics as tmag
from xfemm_tpu_torch.ops import assembly as tasm
from xfemm_tpu_torch.ops import newton as tnewton
from xfemm_tpu_torch.ops import solver as tsolver

HBM = 1e9
ON_CPU = dict(device="cpu", hbm_bytes=HBM)

torch.set_num_threads(1)


@pytest.fixture
def cpu_only(monkeypatch):
    """Fail on any CUDA query, and on a band-planner memory read without
    an explicit size (a copy of tests/test_torch_surfaces.py's)."""
    def no_cuda(*a, **k):
        raise AssertionError("a CPU run touched CUDA")

    for name in ("is_available", "mem_get_info", "synchronize",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    real = tsolver.device_hbm_bytes

    def sized(device, hbm=None):
        assert hbm is not None, "device_hbm_bytes reached without a size"
        assert torch.device(device).type == "cpu"
        return real(device, hbm)

    monkeypatch.setattr(tsolver, "device_hbm_bytes", sized)
    for cache in (tsolver._BAND_CACHE, tsolver._PATTERN_CACHE):
        cache.clear()
    yield
    for cache in (tsolver._BAND_CACHE, tsolver._PATTERN_CACHE):
        cache.clear()


@pytest.fixture
def jax_band(monkeypatch):
    """The JAX package's f32 band engine on the CPU (its own tests'
    switches), with fresh caches."""
    monkeypatch.setattr(jsolver, "device_f64_ok", lambda: False)
    monkeypatch.setattr(jsolver, "band_platform_ok", lambda: True)
    monkeypatch.setattr(jsolver, "ROW_TILE_MIN", 64)
    monkeypatch.setattr(jsolver, "_BAND_CACHE", collections.OrderedDict())
    monkeypatch.setattr(jsolver, "_PATTERN_CACHE",
                        collections.OrderedDict())


def load(fixtures):
    return (tfemfile.load(str(fixtures / "AxiSolenoid.fem")),
            tread_mesh(str(fixtures / "AxiSolenoid")))


def jsolve(fixtures):
    return jaxi.solve(jfemfile.load(str(fixtures / "AxiSolenoid.fem")),
                      jread_mesh(str(fixtures / "AxiSolenoid")))


def check(sol, mesh, fixtures, jsol, precision):
    """The contract residual, the golden solution and the JAX package's
    solve, each at 1e-6 of max|A|."""
    assert sol.residual <= precision and np.isfinite(sol.A).all()
    g = ansfile.read_ans(str(fixtures / "AxiSolenoid.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-12
    Ag = np.real(g.values)
    assert np.abs(sol.A[idx] - Ag).max() / np.abs(Ag).max() < 1e-6
    scale = np.abs(jsol.A).max()
    assert np.abs(sol.A - jsol.A).max() <= 1e-6 * scale
    assert np.array_equal(sol.label_case, jsol.label_case)


def test_axi_geometry_matches_jax(fixtures):
    """``axi_geometry`` and ``axi_curl_matrices`` (host numpy, copied)
    field for field against the JAX package's on AxiSolenoid's mesh, in
    cm as the solve uses them: 1e-12 relative."""
    p, mesh = load(fixtures)
    pk = tmag.pack(p, mesh)
    tg = tasm.axi_geometry(pk.xy, pk.tris)
    jg = jasm.axi_geometry(pk.xy, pk.tris)
    assert tg._fields == jg._fields
    for name in tg._fields:
        a, b = getattr(tg, name), np.asarray(getattr(jg, name))
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), name
    assert (np.asarray(tg.rn) < 1e-6).any()          # on-axis corners
    for a, b in zip(tasm.axi_curl_matrices(tg), jasm.axi_curl_matrices(jg)):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()


def test_axi_host_chain_matches_jax_and_golden(fixtures, cpu_only,
                                               monkeypatch):
    """``XFEMM_TPU_NO_DEVICE_NEWTON=1`` in both packages: the host
    Newton chain only (the JAX package's f64 engine on the CPU, the
    port's f32 band CG with host f64 refinement)."""
    monkeypatch.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")
    calls = []
    monkeypatch.setattr(tnewton, "setup",
                        lambda *a, **k: calls.append(1))
    p, mesh = load(fixtures)
    sol = taxi.solve(p, mesh, **ON_CPU)
    assert calls == []
    check(sol, mesh, fixtures, jsolve(fixtures), p.Precision)


def test_axi_device_loop_matches_jax_and_golden(fixtures, cpu_only,
                                                jax_band, monkeypatch):
    """The default path: host it-0, then the Newton middle on the device
    through ``magnetostatics._device_chain`` with ``axi=True``
    (``newton.run``, the energy-form |B|), then the host endgame; held
    to the JAX package's forced device loop, which must engage too."""
    seen = {"jax": [], "torch": []}
    for mod, key in ((jnewton, "jax"), (tnewton, "torch")):
        real = mod.run
        monkeypatch.setattr(
            mod, "run", lambda *a, _r=real, _k=key, **k:
            (seen[_k].append(k.get("axi", False)), _r(*a, **k))[1])
    jsol = jsolve(fixtures)
    p, mesh = load(fixtures)
    sol = taxi.solve(p, mesh, **ON_CPU)
    assert seen["jax"] and all(seen["jax"])
    assert seen["torch"] and all(seen["torch"]), seen
    check(sol, mesh, fixtures, jsol, p.Precision)
    assert sol.newton_iterations > len(seen["torch"])


def test_axi_scatter_mode_matches_jax_and_golden(fixtures, cpu_only,
                                                 jax_band, monkeypatch):
    """The loop's scatter mode (``run_scatter``: one step per call, the
    band refreshed in place), forced by a zero byte threshold in both
    packages."""
    monkeypatch.setenv("XFEMM_TPU_DN_SCATTER_BYTES", "0")
    seen = {"jax": [], "torch": []}
    for mod, key in ((jnewton, "jax"), (tnewton, "torch")):
        real = mod.run_scatter
        monkeypatch.setattr(
            mod, "run_scatter", lambda *a, _r=real, _k=key, **k:
            (seen[_k].append(k.get("axi", False)), _r(*a, **k))[1])
    jsol = jsolve(fixtures)
    p, mesh = load(fixtures)
    sol = taxi.solve(p, mesh, **ON_CPU)
    assert seen["jax"] and all(seen["jax"])
    assert seen["torch"] and all(seen["torch"]), seen
    check(sol, mesh, fixtures, jsol, p.Precision)


def test_axi_scatter_chain_ends_at_its_floor(fixtures, cpu_only,
                                             monkeypatch):
    """A deliberate difference from the JAX package (ROADMAP §C): the
    axisymmetric solve shares the planar ``_device_chain``, so its
    scatter chain also ends once the displacement falls below
    ``magnetostatics.SCATTER_FLOOR``; the JAX package's own axisymmetric
    chain (axisymmetric.py:150-172) steps on to its target or a
    three-step stall. Scripted ``run_scatter`` steps of 7 CG iterations
    that leave V as it is; the host endgame then reaches the golden
    solution either way."""
    script = [1e-3, 9e-5, 5e-5, 3e-5, 4e-5, 3.5e-5, 3.2e-5]
    chains = []

    def scripted(dn, amg, V, state, **kw):
        assert kw.get("axi") is True
        steps = chains[-1]
        res = script[len(steps)]
        steps.append(res)
        return V, None, None, torch.tensor([1.0, res, float(state[1]), 1.0,
                                            7.0])

    real_chain = taxi._device_chain

    def chain(*a, **kw):
        chains.append([])
        return real_chain(*a, **kw)

    monkeypatch.setattr(tnewton, "run_scatter", scripted)
    monkeypatch.setattr(tnewton, "rebuild_band_amg", lambda amg, *a: amg)
    monkeypatch.setattr(taxi, "_device_chain", chain)
    monkeypatch.setenv("XFEMM_TPU_DN_SCATTER_BYTES", "0")
    jsol = jsolve(fixtures)
    p, mesh = load(fixtures)
    sol = taxi.solve(p, mesh, **ON_CPU)
    assert chains and all(steps == script[:2] for steps in chains), chains
    check(sol, mesh, fixtures, jsol, p.Precision)
    # the JAX package's rule alone: on to the three-step stall
    monkeypatch.setattr(tmag, "SCATTER_FLOOR", 0.0)
    chains.clear()
    p, mesh = load(fixtures)
    sol = taxi.solve(p, mesh, **ON_CPU)
    assert chains and all(steps == script for steps in chains), chains
    check(sol, mesh, fixtures, jsol, p.Precision)
