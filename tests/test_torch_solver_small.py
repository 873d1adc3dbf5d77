"""The port's linear solver off the band engine against the JAX package
on the CPU: the element-block operator and Jacobi PCG (``_pcg_impl``)
on float32 inputs, whole solves through the ELL-AMG engine (a problem
of at most 4*ROW_TILE_MIN unknowns, Temp.fem where no band storage tier
fits), the Jacobi engine without DOF coordinates, and the latch-off of
a band V-cycle that stops contracting.

The JAX package runs its CPU engines in f64 and the port in f32 (its
device arithmetic everywhere), so whole solves are held to the
contract: residual <= 1e-8 and A within 1e-5 of max|A| (and
Temp.ans.golden to 1e-5), not bit for bit."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax.numpy as jnp

from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.io import ansfile
from xfemm_tpu.mesh import mesher as jmesher
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu.models import magnetostatics as jmag
from xfemm_tpu.ops import assembly as jassembly
from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files as tread_mesh
from xfemm_tpu_torch.models import benchprob as tbench
from xfemm_tpu_torch.models import magnetostatics as tmag
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import loop as tloop
from xfemm_tpu_torch.ops import solver as tsolver

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_caches():
    for cache in (jsolver._BAND_CACHE, tsolver._BAND_CACHE,
                  jmag._PACK_CACHE, tmag._PACK_CACHE):
        cache.clear()
    yield
    for cache in (jsolver._BAND_CACHE, tsolver._BAND_CACHE,
                  jmag._PACK_CACHE, tmag._PACK_CACHE):
        cache.clear()


def _random_blocks(rng, n, E=400, K=3):
    idx = rng.integers(0, n, size=(E, K))
    sign = rng.choice([-1.0, 1.0], size=(E, K))
    base = rng.standard_normal((E, K, K))
    mat = base @ np.swapaxes(base, 1, 2) + 0.5 * np.eye(K)
    return tsolver.ElementBlock(idx=idx, sign=sign, mat=mat)


def test_block_operator_matches_jax():
    """block_matvec / apply_blocks / assembled_diag in f32: to 1e-6 of
    the largest entry (scatter-add order)."""
    rng = np.random.default_rng(0)
    n = 150
    blocks = [_random_blocks(rng, n), _random_blocks(rng, n, E=60, K=2)]
    x = rng.standard_normal(n).astype(np.float32)
    fixed = rng.random(n) < 0.1
    jb = jsolver._to_device_blocks(blocks, jnp.float32)
    tb = tsolver._to_device_blocks(blocks, torch.float32, "cpu")
    for j, t in ((jsolver.apply_blocks(jb, jnp.asarray(x), n),
                  tsolver.apply_blocks(tb, torch.as_tensor(x), n)),
                 (jsolver.block_matvec(jb[1], jnp.asarray(x), n),
                  tsolver.block_matvec(tb[1], torch.as_tensor(x), n)),
                 (jsolver.assembled_diag(jb, n, jnp.asarray(fixed)),
                  tsolver.assembled_diag(tb, n, torch.as_tensor(fixed)))):
        j = np.asarray(j)
        assert t.dtype == torch.float32
        assert np.abs(t.numpy() - j).max() <= 1e-6 * np.abs(j).max()


def test_pcg_impl_matches_jax():
    """Jacobi PCG on uneliminated blocks with Dirichlet rows inside the
    operator, f32 on both sides, stopping at 1e-5: x to 1e-4 relative
    (l2), iterations within 2."""
    p = jbench.build(2500)
    mesh = jmesher.mesh_problem(p)
    n = mesh.num_nodes
    geom = jassembly.tri_geometry(mesh.nodes, mesh.elements)
    Mx, My, _ = jassembly.curl_matrices(geom)
    blocks = [tsolver.ElementBlock(idx=mesh.elements,
                                   sign=np.ones(mesh.elements.shape),
                                   mat=-np.asarray(Mx + My))]
    A = tsolver.blocks_to_csr(blocks, n)
    fixed = np.zeros(n, bool)
    fixed[::17] = True
    diag = np.where(fixed, 1.0, A.diagonal()).astype(np.float32)
    b = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    jb = jsolver._to_device_blocks(blocks, jnp.float32)
    xj, rj, itj = jsolver._pcg_impl(
        jb, jnp.asarray(b), jnp.asarray(diag), jnp.asarray(fixed),
        jnp.asarray(1e-5, jnp.float32), jnp.zeros(n, jnp.float32), 4000)
    tb = tsolver._to_device_blocks(blocks, torch.float32, "cpu")
    masked0 = tsolver.MASKED["jacobi"]
    xt, rt, itt = tsolver._pcg_impl(
        tb, torch.as_tensor(b), torch.as_tensor(diag),
        torch.as_tensor(fixed), 1e-5, torch.zeros(n), 4000)
    xj = np.asarray(xj)
    assert abs(itt - int(itj)) <= 2, (itt, int(itj))
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-4 * np.linalg.norm(xj)
    assert rt <= 1e-5 and float(rj) <= 1e-5
    assert 0 <= tsolver.MASKED["jacobi"] - masked0 <= tloop.IN_FLIGHT


def _check_golden(fixtures, mesh, A):
    g = ansfile.read_ans(str(fixtures / "Temp.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-12
    Ag = np.real(g.values)
    assert np.abs(A[idx] - Ag).max() / np.abs(Ag).max() < 1e-05


def _same(jsol, tsol):
    assert tsol.residual <= 1e-8 and np.isfinite(tsol.A).all()
    scale = np.abs(jsol.A).max()
    assert np.abs(tsol.A - jsol.A).max() <= 1e-5 * scale


def _session(device="cpu"):
    return next(v[2]["sess"] for k, v in tmag._PACK_CACHE.items()
                if k[1] == device)


def test_small_problem_matches_jax():
    """1,750 unknowns (at most 4*ROW_TILE_MIN): the ELL-AMG engine with
    one level and the dense bottom, no memory size needed."""
    mesh = jmesher.mesh_problem(jbench.build(1500))
    assert mesh.num_nodes <= 4 * tsolver.ROW_TILE_MIN
    jsol = jmag.solve(jbench.build(1500), mesh)
    tsol = tmag.solve(tbench.build(1500), mesh, device="cpu")
    _same(jsol, tsol)
    sess = _session()
    assert sess.band_amg is None and len(sess.amg.levels) == 1
    assert not tsolver._BAND_CACHE


def test_temp_without_band_tier(fixtures):
    """Temp.fem at a 1e6-byte device: no band storage tier fits, so the
    solve takes the ELL-AMG engine (the planner's None plan)."""
    jsol = jmag.solve(jfemfile.load(str(fixtures / "Temp.fem")),
                      jread_mesh(str(fixtures / "Temp")))
    mesh = tread_mesh(str(fixtures / "Temp"))
    tsol = tmag.solve(tfemfile.load(str(fixtures / "Temp.fem")), mesh,
                      device="cpu", hbm_bytes=1e6)
    _same(jsol, tsol)
    _check_golden(fixtures, mesh, tsol.A)
    sess = _session()
    assert sess.plan is None and sess.no_tier == 1e6
    assert sess.band_amg is None and len(sess.amg.levels) == 1
    assert not tsolver._BAND_CACHE


def test_jacobi_without_coords(fixtures):
    """The mask solve of post/fpproc.py (curl matrices, one region at 1,
    the outer boundary at 0) without DOF coordinates: element-block
    Jacobi CG in both packages, x to 1e-6."""
    mesh = jread_mesh(str(fixtures / "Temp"))
    n = mesh.num_nodes
    tris = mesh.elements
    geom = jassembly.tri_geometry(mesh.nodes, tris)
    Mx, My, _ = jassembly.curl_matrices(geom)
    blocks = [tsolver.ElementBlock(idx=tris, sign=np.ones(tris.shape),
                                   mat=-np.asarray(Mx + My))]
    fixed = np.zeros(n, bool)
    vals = np.zeros(n)
    sel = tris[mesh.element_labels == 1].ravel()
    fixed[sel] = True
    vals[sel] = 1.0
    edges = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                    tris[:, [2, 0]]]), axis=1)
    uniq, cnt = np.unique(edges, axis=0, return_counts=True)
    outer = uniq[cnt == 1].ravel()
    fixed[outer[vals[outer] != 1.0]] = True
    xj, rj, _ = jsolver.solve(blocks, np.zeros(n), fixed, vals, 1e-8)
    xt, rt, itt = tsolver.solve(blocks, np.zeros(n), fixed, vals, 1e-8,
                                device="cpu")
    assert rt <= 1e-8 and float(rj) <= 1e-8 and itt > 0
    assert np.abs(xt - np.asarray(xj)).max() <= 1e-6
    assert xt.min() >= -1e-9 and xt.max() <= 1.0 + 1e-9


def test_latch_off_lands_on_ell_amg(fixtures, monkeypatch):
    """Temp.fem at a 2e8-byte plan (the band-AMG V-cycle with a two-grid
    bottom, no fine factor) with a stand-in for ``band_pcg`` that never
    contracts, in both packages: each latches the band engine off, drops
    its cache entry, and finishes on the f32 ELL-AMG engine; the two
    reach the same A, and a repeat solve does not bring the band back."""
    monkeypatch.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")
    monkeypatch.setattr(jsolver, "device_f64_ok", lambda: False)
    monkeypatch.setattr(jsolver, "band_platform_ok", lambda: True)
    monkeypatch.setattr(jsolver, "device_hbm_bytes", lambda: 2e8)
    calls = {"jax": 0, "torch": 0}

    def jstall(amg, b, *a, **kw):
        calls["jax"] += 1
        return jnp.zeros_like(b), jnp.asarray(1.0), jnp.asarray(1, jnp.int32)

    def tstall(amg, b, *a, **kw):
        calls["torch"] += 1
        return torch.zeros_like(b), 1.0, 1

    monkeypatch.setattr(jband, "band_pcg", jstall)
    monkeypatch.setattr(tband, "band_pcg", tstall)
    jsol = jmag.solve(jfemfile.load(str(fixtures / "Temp.fem")),
                      jread_mesh(str(fixtures / "Temp")))
    mesh = tread_mesh(str(fixtures / "Temp"))
    prob = tfemfile.load(str(fixtures / "Temp.fem"))
    tsol = tmag.solve(prob, mesh, device="cpu", hbm_bytes=2e8)
    assert calls["jax"] == calls["torch"] == 1
    _same(jsol, tsol)
    _check_golden(fixtures, mesh, tsol.A)
    sess = _session()
    assert sess.band_disabled and sess.band_amg is None
    assert sess.amg is not None and sess.ell_map is not None
    assert not tsolver._BAND_CACHE and not jsolver._BAND_CACHE
    again = tmag.solve(prob, mesh, device="cpu", hbm_bytes=2e8)
    assert calls["torch"] == 1 and again.residual <= 1e-8
