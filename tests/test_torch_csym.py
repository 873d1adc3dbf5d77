"""The complex-symmetric solvers of the PyTorch port against the JAX
package's, on the CPU and on the same inputs.

The JAX package's f32 AC band engine is forced on the CPU as its own
test does (tests/test_harmonic.py:36-61: no f64 device, the band
platform on, fresh caches) with a 1e9-byte device; the first correction
system of ACaxi.fem (4,846 unknowns) and the engine's entry (the shifted
real hierarchy, the Ar and Ai operator bands, the block-tridiagonal
factor) are captured from it and carried across with
``convert.cband_entry``, so both packages run the same operator and
preconditioner. GMRES is held at 1e-5 of max|x| with equal iteration
counts; Jacobi pairs CG (``_pcg_csym_pairs``) at 1e-5 with iteration
counts within 10%. ``solve_complex``'s engine fallbacks (the gate, the
dropped factor, the latch-off to Jacobi pairs) are exercised on the
port alone against the golden solutions."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import harmonicaxi as jharmaxi
from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import pallas_band
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch import convert
from xfemm_tpu_torch import models as tmodels
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.io import ansfile as tans
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files as tread_mesh
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import loop as tloop
from xfemm_tpu_torch.ops import solver as tsolver

from test_torch_axisymmetric import cpu_only  # noqa: F401  (fixture)

HBM = 1e9

torch.set_num_threads(1)


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def captured(fixtures):
    """Run the JAX package's forced AC band engine on ACaxi.fem up to its
    first fused GMRES call, and return that call's arguments, the
    engine's cache entry and the first ``solve_complex`` call's inputs."""
    mp = pytest.MonkeyPatch()
    seen = {}
    real_sc = jsolver.solve_complex

    def solve_complex(blocks, b, fixed_mask, fixed_vals, tol, **kw):
        seen["system"] = (blocks, b, fixed_mask, fixed_vals)
        return real_sc(blocks, b, fixed_mask, fixed_vals, tol, **kw)

    def first(amg, Aop, Ai, br, bi, tol, m=24, cycles=8, bt=None):
        seen["call"] = dict(br=br, bi=bi, tol=tol, m=m)
        raise _Captured

    # the Pallas kernels in interpret mode for the whole module
    keep = pytest.MonkeyPatch()
    keep.delenv("XFEMM_TPU_PALLAS", raising=False)
    keep.setattr(pallas_band, "INTERPRET", True)
    jband._pallas_enabled.cache_clear()
    mp.setattr(jsolver, "device_f64_ok", lambda: False)
    mp.setattr(jsolver, "band_platform_ok", lambda: True)
    mp.setattr(jsolver, "ROW_TILE_MIN", 64)
    mp.setattr(jsolver, "device_hbm_bytes", lambda: HBM)
    mp.setattr(jsolver, "_CBAND_CACHE", collections.OrderedDict())
    mp.setattr(jsolver, "solve_complex", solve_complex)
    mp.setattr(jband, "band_csym_fgmres_fused", first)
    with pytest.raises(_Captured):
        jharmaxi.solve(jfemfile.load(str(fixtures / "ACaxi.fem")),
                       jread_mesh(str(fixtures / "ACaxi")))
    (ent,) = jsolver._CBAND_CACHE.values()
    seen["entry"] = ent
    mp.undo()
    yield seen
    keep.undo()
    jband._pallas_enabled.cache_clear()


def rhs_pair(captured):
    c = captured["call"]
    return (torch.as_tensor(np.array(c["br"])),
            torch.as_tensor(np.array(c["bi"])))


def close(xt, xj, tol=1e-5):
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= tol * np.abs(xj).max()


def test_the_capture_holds_a_factor_and_p_bands(captured):
    """The captured engine is the one the 125k card path runs: GMRES(6)
    with the shifted matrix's factor; its V-cycle has a prolongator band
    on every level, so the port's matrix-free transfers (ROADMAP §C.1)
    do not enter the V-cycle comparison below."""
    ent = captured["entry"]
    assert ent["bt"] is not None and captured["call"]["m"] == 6
    assert all(lv.P is not None for lv in ent["amg"].levels)


@pytest.mark.parametrize("with_bt", [True, False])
def test_band_csym_fgmres_cycle_matches_jax(captured, with_bt):
    """One GMRES cycle on the first correction system: m=6 with the
    factor, m=24 with the V-cycle alone (the engine's two restart
    lengths); x and the least-squares residual against the JAX
    package's."""
    ent = captured["entry"]
    t = convert.cband_entry(ent)
    m = 6 if with_bt else 24
    c = captured["call"]
    jx = jband.band_csym_fgmres(ent["amg"], ent["Aop"], ent["Ai"], c["br"],
                                c["bi"], m=m,
                                bt=ent["bt"] if with_bt else None)
    br, bi = rhs_pair(captured)
    tx = tband.band_csym_fgmres(t["amg"], t["Aop"], t["Ai"], br, bi, m=m,
                                bt=t["bt"] if with_bt else None)
    assert tx[3] == int(jx[3]) == m
    close(tx[0], jx[0])
    close(tx[1], jx[1])
    assert 0.0 < tx[2] < 0.5
    assert abs(tx[2] - float(jx[2])) <= 1e-5 + 0.05 * float(jx[2])


@pytest.mark.parametrize("tol,cycles", [(1e-4, 8), (0.0, 3)])
def test_band_csym_fgmres_fused_matches_jax(captured, tol, cycles):
    """Restarted GMRES(6) with the factor: to a residual the f32 cycles
    reach (1e-4; near the f32 floor of ~2e-6 the two packages' cycle
    counts follow their summation order: at the engine's own 2e-6 stop
    the JAX package ran 8 cycles and the port 3) and for three whole
    cycles; equal iteration counts, x at 1e-5."""
    ent = captured["entry"]
    t = convert.cband_entry(ent)
    c = captured["call"]
    jx = jband.band_csym_fgmres_fused(
        ent["amg"], ent["Aop"], ent["Ai"], c["br"], c["bi"],
        jnp.asarray(tol, jnp.float32), m=6, cycles=cycles, bt=ent["bt"])
    br, bi = rhs_pair(captured)
    tx = tband.band_csym_fgmres_fused(t["amg"], t["Aop"], t["Ai"], br, bi,
                                      tol, m=6, cycles=cycles, bt=t["bt"])
    assert tx[3] == int(jx[3])
    assert tx[3] == (6 * cycles if tol == 0.0 else tx[3])
    close(tx[0], jx[0])
    close(tx[1], jx[1])
    # the true f32 residual after a cycle is at the f32 floor in both
    # (1.98e-6 here, 2.35e-6 in the JAX package)
    assert tx[2] <= 1e-5 and float(jx[2]) <= 1e-5


def test_pcg_csym_pairs_matches_jax(captured):
    """Jacobi CG on (re, im) pairs over the element blocks of ACaxi's
    first system (the engine without a band): the same blocks, diagonal,
    Dirichlet mask and scaled right-hand side in both packages; x at
    1e-5 of max|x|, iteration counts within 10%."""
    blocks, b, fixed_mask, fixed_vals = captured["system"]
    fixed = np.asarray(fixed_mask, bool)
    n = len(b)
    At = tsolver._ac_csr(blocks, n, fixed)
    diag = At.diagonal()
    rhs = np.where(fixed, np.asarray(fixed_vals, complex), b)
    rs = rhs / np.abs(rhs).max()
    jblocks = tuple(
        (jnp.asarray(np.asarray(k.idx)),
         jnp.asarray(np.asarray(k.sign), jnp.float32),
         jnp.asarray(np.asarray(k.mat, complex).real, jnp.float32),
         jnp.asarray(np.asarray(k.mat, complex).imag, jnp.float32))
        for k in blocks)
    jx = jsolver._pcg_csym_pairs(
        jblocks, jnp.asarray(rs.real, jnp.float32),
        jnp.asarray(rs.imag, jnp.float32),
        jnp.asarray(diag.real, jnp.float32),
        jnp.asarray(diag.imag, jnp.float32), jnp.asarray(fixed),
        jnp.asarray(1e-5, jnp.float32), 20000)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)

    tblocks = tuple((torch.as_tensor(np.asarray(k.idx, np.int64)),
                     f32(np.asarray(k.sign, float)),
                     f32(np.asarray(k.mat, complex).real),
                     f32(np.asarray(k.mat, complex).imag)) for k in blocks)
    before = tsolver.MASKED["csym-pairs"]
    tx = tsolver._pcg_csym_pairs(tblocks, f32(rs.real), f32(rs.imag),
                                 f32(diag.real), f32(diag.imag),
                                 torch.as_tensor(fixed), 1e-5, 20000)
    # read IN_FLIGHT iterations late, on the CPU as on the card
    assert 0 <= tsolver.MASKED["csym-pairs"] - before <= tloop.IN_FLIGHT
    assert abs(tx[3] - int(jx[3])) <= 0.1 * int(jx[3]) and tx[2] <= 1e-5
    assert tx[3] > 100
    close(tx[0], jx[0])
    close(tx[1], jx[1])


def golden_error(fixtures, stem, sol, mesh):
    g = tans.read_ans(str(fixtures / f"{stem}.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    return np.abs(sol.A[idx] - g.values).max() / np.abs(g.values).max()


def test_jacobi_pairs_below_the_band_gate(fixtures, cpu_only):
    """A device too small for the shifted band (AC_BAND_GATE of 1e5
    bytes): ``solve_complex`` records the pattern as band-less and
    solves ACaxi400 (its series circuit's bordered rows included) with
    Jacobi pairs CG to the contract and the golden solution."""
    tsolver._CBAND_CACHE.clear()
    p = tfemfile.load(str(fixtures / "ACaxi400.fem"))
    mesh = tread_mesh(str(fixtures / "ACaxi400"))
    sol = tmodels.solve(p, mesh, device="cpu", hbm_bytes=1e5)
    assert list(tsolver._CBAND_CACHE.values()) == [None]
    assert sol.residual <= p.Precision
    assert golden_error(fixtures, "ACaxi400", sol, mesh) < 1e-6


def test_factor_dropped_then_band_latched_off(fixtures, cpu_only,
                                              monkeypatch):
    """The engine's two recovery steps (solver.py:1195-1207 of the JAX
    package): a band pass that does not cut the l2 residual by 10% first
    drops the factor and retries with the V-cycle; a V-cycle pass that
    fails too latches the band engine off for the pattern, and Jacobi
    pairs CG finishes the solve. Scripted here by band passes that
    return no correction."""
    calls = []

    def stalled(amg, Aop, Ai, br, bi, tol, m=24, cycles=8, bt=None):
        calls.append((bt is not None, m))
        return torch.zeros_like(br), torch.zeros_like(bi), 1.0, m

    monkeypatch.setattr(tband, "band_csym_fgmres_fused", stalled)
    tsolver._CBAND_CACHE.clear()
    p = tfemfile.load(str(fixtures / "ACaxi.fem"))
    mesh = tread_mesh(str(fixtures / "ACaxi"))
    sol = tmodels.solve(p, mesh, device="cpu", hbm_bytes=HBM)
    assert calls == [(True, 6), (False, 24)]
    assert list(tsolver._CBAND_CACHE.values()) == [None]
    assert sol.residual <= p.Precision
    assert golden_error(fixtures, "ACaxi", sol, mesh) < 1e-6
