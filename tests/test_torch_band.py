"""Port's dense-band engine (xfemm_tpu_torch/ops/band.py, the band
matvec K1 on its plain CPU path) against the JAX package: the XLA
lowering of ``band.band_matvec``, the Pallas kernel in interpret mode,
the band packing and refresh, and the drift-guarded CG."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import pallas_band
from xfemm_tpu_torch import convert
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import kernels


@pytest.fixture(autouse=True)
def _xla_band(monkeypatch):
    """The JAX band product through its XLA lowering (the Pallas kernel
    is called explicitly, in interpret mode, where a test wants it)."""
    monkeypatch.delenv("XFEMM_TPU_PALLAS", raising=False)
    monkeypatch.setattr(pallas_band, "INTERPRET", True)
    jband._pallas_enabled.cache_clear()
    yield
    jband._pallas_enabled.cache_clear()


def _random_band(rng, NT, R, K, shift0, frac=0.3):
    W = K * R
    dense = rng.standard_normal((NT, R, W)).astype(np.float32)
    dense *= rng.random((NT, R, W)) < frac
    ncols = NT * R - 17
    x = rng.standard_normal(ncols).astype(np.float32)
    return dense, x, ncols


def _banded_spd(n, bw, seed=0, density=0.25):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        for j in range(max(0, i - bw), i + 1):
            if i == j or rng.random() < density:
                rows.append(i)
                cols.append(j)
                vals.append(rng.normal())
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A = A + A.T
    A = (A + sp.diags(np.abs(A).sum(axis=1).A1 + 1.0)).tocsr()
    A.sum_duplicates()
    return A


@pytest.mark.parametrize("NT,R,K,shift0", [(3, 128, 2, -1), (4, 128, 3, 1),
                                           (3, 256, 3, -1), (2, 256, 2, 0)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_band_matvec_matches_jax(NT, R, K, shift0, dtype):
    rng = np.random.default_rng(NT * 100 + R + K)
    dense, x, ncols = _random_band(rng, NT, R, K, shift0)
    jdense = jnp.asarray(dense)
    if dtype == "bf16":
        jdense = jdense.astype(jnp.bfloat16)
    jbm = jband.BandMatrix(dense=jdense, shift0=shift0, cchunk=R,
                           ncols=ncols)
    tbm = convert.band_matrix(jbm)
    before = dict(kernels.LAUNCHES)
    y = tband.band_matvec(tbm, torch.as_tensor(x)).numpy()
    assert kernels.LAUNCHES == before    # CPU tensors: plain version
    y_xla = np.asarray(jband.band_matvec(jbm, jnp.asarray(x)))
    y_pallas = np.asarray(pallas_band.band_matvec_pallas(jbm,
                                                         jnp.asarray(x)))
    if dtype == "f32":
        np.testing.assert_allclose(y, y_xla, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y, y_pallas, rtol=1e-5, atol=1e-5)
    else:
        # bf16 storage rounds every operand to 8 mantissa bits: bound
        # the error in aggregate against the f32 product, as the JAX
        # package's own kernel test does
        jbm32 = jband.BandMatrix(dense=jnp.asarray(dense), shift0=shift0,
                                 cchunk=R, ncols=ncols)
        ref = np.asarray(jband.band_matvec(jbm32, jnp.asarray(x)))
        scale = np.abs(ref).max()
        for other in (y, y_xla, y_pallas):
            assert np.abs(other - ref).max() / scale < 3e-2
        # the same rounding on both sides: port and XLA lowering agree
        np.testing.assert_allclose(y, y_xla, rtol=1e-5, atol=1e-5)


def test_pack_band_layout_equals_jax():
    A = _banded_spd(900, 150, seed=3)
    for R in (128, 256):
        lt = tband.pack_band_layout(A, R, R)
        lj = jband.pack_band_layout(A, R, R)
        assert len(lt) == len(lj)
        for a, b in zip(lt, lj):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            else:
                assert a == b
        (_, dt), (_, dj) = tband.pack_band(A, R, R), jband.pack_band(A, R, R)
        assert dt.tobytes() == dj.tobytes()


def test_fill_and_update_fine_values():
    A0 = _banded_spd(700, 90, seed=5)
    rng = np.random.default_rng(6)
    A1 = A0.copy()
    A1.data = A1.data * (1.0 + 0.1 * rng.random(A1.nnz))
    amg, lay = tband.setup_fine_band(A0)
    tband.update_fine_values(amg, lay, A1.data)
    layj = jband.pack_band_layout(A1, lay.R, lay.R)
    ref = jband.fill_band_device(layj, A1.data, lay.R)
    got = amg.levels[0].A.dense.numpy()
    assert got.tobytes() == np.asarray(ref.dense).tobytes()
    y = tband.band_apply(amg.levels[0].A, None,
                         torch.ones(A1.shape[0])).numpy()
    np.testing.assert_allclose(y, A1 @ np.ones(A1.shape[0]), rtol=2e-5)


@pytest.mark.parametrize("check_every", [48, 8])
def test_chunked_pcg_matches_jax(check_every):
    """Jacobi-preconditioned drift-guarded CG on a small SPD band: the
    host loop over torch tensors takes the JAX while_loop's iterations
    and reaches its solution."""
    m = 30                           # 2-D Laplacian: ~80 Jacobi-CG its
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    A = (sp.kron(sp.eye(m), T) + sp.kron(T, sp.eye(m))
         + 1e-3 * sp.eye(m * m)).tocsr()
    A.sum_duplicates()
    n = A.shape[0]
    lay = jband.pack_band_layout(A, 128, 128)
    jA = jband.fill_band_device(lay, A.data, 128)
    tA = convert.band_matrix(jA)
    invd = (1.0 / A.diagonal()).astype(np.float32)
    rng = np.random.default_rng(12)
    x_true = rng.normal(size=n)
    rhs = (A @ x_true).astype(np.float32)
    jx, jrel, jit = jband._chunked_pcg(
        lambda v: jband.band_apply(jA, None, v),
        lambda r: jnp.asarray(invd) * r, jnp.asarray(invd),
        jnp.asarray(rhs), jnp.float32(1e-6), jnp.zeros(n, jnp.float32),
        400, 40, check_every=check_every)
    tinvd = torch.as_tensor(invd)
    tx, trel, tit = tband._chunked_pcg(
        lambda v: tband.band_apply(tA, None, v), lambda r: tinvd * r,
        tinvd, torch.as_tensor(rhs), 1e-6, torch.zeros(n), 400, 40,
        check_every=check_every)
    jit = int(jit)
    assert jit > check_every           # the drift checks ran
    assert abs(tit - jit) <= max(2, jit // 20), (tit, jit)
    assert trel <= 1e-6 and float(jrel) <= 1e-6
    err = np.abs(tx.numpy() - np.asarray(jx)).max() / np.abs(x_true).max()
    assert err < 1e-5


def test_setup_fine_band_matches_jax_fine_level():
    """The port's fine-level setup reproduces the fine level of the
    JAX package's ``setup_band_amg(fine_full=True)`` (carried across by
    convert.py): layout, band and inverse diagonal."""
    m = 45
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    A = (sp.kron(sp.eye(m), T) + sp.kron(T, sp.eye(m))).tocsr()
    A.sum_duplicates()
    jamg, jlay = jband.setup_band_amg(A, fine_full=True)
    amg, lay = tband.setup_fine_band(A)
    ref_lay = convert.fine_layout(jlay)
    for a, b in zip(lay, ref_lay):
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert a == b
    ref = convert.band_level(jamg.levels[0])
    got = amg.levels[0]
    assert torch.equal(got.A.dense, ref.A.dense)
    assert (got.A.shift0, got.A.cchunk, got.A.ncols) == \
        (ref.A.shift0, ref.A.cchunk, ref.A.ncols)
    assert torch.equal(got.invd, ref.invd)


def test_chunked_pcg_ends_at_its_floor():
    """A pass whose recurrence drifts from a true residual that stops
    improving ends there (the host's f64 restart goes on from the exact
    residual) instead of restarting every check until its cap. The
    operator here is A plus a fresh perturbation of 1e-4 relative per
    call: the true residual of any iterate floors near 1e-4."""
    m = 30
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    A = (sp.kron(sp.eye(m), T) + sp.kron(T, sp.eye(m))
         + 1e-3 * sp.eye(m * m)).tocsr()
    n = A.shape[0]
    tA = convert.band_matrix(jband.fill_band_device(
        jband.pack_band_layout(A, 128, 128), A.data, 128))
    invd = torch.as_tensor((1.0 / A.diagonal()).astype(np.float32))
    gen = torch.Generator().manual_seed(0)

    def noisy_op(v):
        y = tband.band_apply(tA, None, v)
        return y + 1e-4 * y.abs().max() * torch.randn(n, generator=gen)

    rhs = torch.as_tensor((A @ np.ones(n)).astype(np.float32))
    _x, rel, it = tband._chunked_pcg(noisy_op, lambda r: invd * r, invd,
                                     rhs, 1e-9, torch.zeros(n), 2000, 2000)
    assert it < 500, it          # ended at the floor, far from the cap
    assert rel < 1e-2
