"""The port's fused symmetric band apply (K5 ``kernels.band_sym``, on its
plain CPU path), its transposed product and the COO sidecar against the
JAX package: the Pallas kernel ``band_apply_sym_pallas`` in interpret
mode, the XLA two-pass ``band_matvec + band_rmatvec - d x``, and
``band_apply`` on levels built by both packages' ``setup_band_amg``."""

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
    """The JAX band products through their XLA lowering; the Pallas
    kernel is called explicitly, in interpret mode."""
    monkeypatch.delenv("XFEMM_TPU_PALLAS", raising=False)
    monkeypatch.setattr(pallas_band, "INTERPRET", True)
    jband._pallas_enabled.cache_clear()
    yield
    jband._pallas_enabled.cache_clear()


def _random_band(rng, NT, R, K, shift0, frac=0.3):
    dense = rng.standard_normal((NT, R, K * R)).astype(np.float32)
    dense *= rng.random((NT, R, K * R)) < frac
    ncols = NT * R - 17
    x = rng.standard_normal(ncols).astype(np.float32)
    dvec = rng.standard_normal(ncols).astype(np.float32)
    return dense, x, dvec, ncols


CASES = [(3, 128, 2, -1), (4, 128, 3, 1), (3, 256, 3, -1), (4, 256, 2, 1),
         (3, 128, 2, 0)]


@pytest.mark.parametrize("NT,R,K,shift0", CASES)
def test_band_sym_f32_matches_jax(NT, R, K, shift0):
    rng = np.random.default_rng(NT * 1000 + R + K + shift0)
    dense, x, dvec, ncols = _random_band(rng, NT, R, K, shift0)
    jbm = jband.BandMatrix(dense=jnp.asarray(dense), shift0=shift0,
                           cchunk=R, ncols=ncols)
    before = dict(kernels.LAUNCHES)
    y = kernels.band_sym(torch.as_tensor(dense), torch.as_tensor(dvec),
                         torch.as_tensor(x), shift0, R, ncols).numpy()
    assert kernels.LAUNCHES == before     # CPU tensors: plain version
    y_pallas = np.asarray(pallas_band.band_apply_sym_pallas(
        jbm, jnp.asarray(dvec), jnp.asarray(x)))
    xj = jnp.asarray(x)
    y_xla = (np.asarray(jband.band_matvec(jbm, xj))[:ncols]
             + np.asarray(jband.band_rmatvec(jbm, xj))[:ncols] - dvec * x)
    # the tolerance of the JAX package's own kernel test
    np.testing.assert_allclose(y, y_pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y, y_xla, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("NT,R,K,shift0", [(3, 128, 2, -1), (4, 256, 2, 1)])
def test_band_sym_bf16_matches_jax(NT, R, K, shift0):
    rng = np.random.default_rng(R + K)
    dense, x, dvec, ncols = _random_band(rng, NT, R, K, shift0)
    jbm16 = jband.BandMatrix(dense=jnp.asarray(dense).astype(jnp.bfloat16),
                             shift0=shift0, cchunk=R, ncols=ncols)
    y = kernels.band_sym(convert.tensor(jbm16.dense), torch.as_tensor(dvec),
                         torch.as_tensor(x), shift0, R, ncols).numpy()
    y_pallas = np.asarray(pallas_band.band_apply_sym_pallas(
        jbm16, jnp.asarray(dvec), jnp.asarray(x)))
    jbm32 = jband.BandMatrix(dense=jnp.asarray(dense), shift0=shift0,
                             cchunk=R, ncols=ncols)
    ref = np.asarray(pallas_band.band_apply_sym_pallas(
        jbm32, jnp.asarray(dvec), jnp.asarray(x)))
    # bf16 storage rounds the band and x to 8 mantissa bits: bound the
    # error in aggregate against the f32 product
    scale = np.abs(ref).max()
    for other in (y, y_pallas):
        assert np.abs(other - ref).max() / scale < 3e-2
    # the same rounding on both sides
    assert np.abs(y - y_pallas).max() / scale < 1e-4


@pytest.mark.parametrize("shift0", [-1, 2])
def test_band_rmatvec_matches_jax(shift0):
    rng = np.random.default_rng(5 + shift0)
    dense, x, _dvec, ncols = _random_band(rng, 5, 128, 3, shift0)
    jbm = jband.BandMatrix(dense=jnp.asarray(dense), shift0=shift0,
                           cchunk=128, ncols=ncols)
    y = rng.standard_normal(5 * 128 - 40).astype(np.float32)
    got = tband.band_rmatvec(convert.band_matrix(jbm),
                             torch.as_tensor(y)).numpy()
    ref = np.asarray(jband.band_rmatvec(jbm, jnp.asarray(y)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # and it is the transpose of the band product
    A = np.zeros((5 * 128, ncols))
    for t in range(5):
        for w in range(dense.shape[2]):
            c = (t + shift0) * 128 + w
            if 0 <= c < ncols:
                A[t * 128:(t + 1) * 128, c] = dense[t, :, w]
    np.testing.assert_allclose(got, A[:y.size].T @ y, rtol=1e-4, atol=1e-4)


def _banded_spd_with_outliers(n=8000, bw=6, n_far=40, seed=0):
    """A tight SPD band plus a few symmetric far couplings (the shape a
    partitioned ordering gives), as tests/test_band_sidecar.py builds
    it."""
    rng = np.random.default_rng(seed)
    diags = [4.0 * np.ones(n)]
    offsets = [0]
    for k in range(1, bw + 1):
        v = -0.4 / k * np.ones(n - k)
        diags += [v, v]
        offsets += [k, -k]
    A = sp.diags(diags, offsets, format="lil")
    for i in rng.choice(n // 2 - 10, size=n_far, replace=False):
        A[i, i + n // 2] = -0.05
        A[i + n // 2, i] = -0.05
    A = A.tocsr()
    A.sum_duplicates()
    return A


@pytest.mark.parametrize("sym", [False, True])
def test_band_apply_with_sidecar_matches_jax(sym, monkeypatch):
    """band_apply on the fine level (triu or full band + sidecar) that
    both packages' setup_band_amg build from the same matrix."""
    monkeypatch.setattr(jband, "SYM_MIN_BYTES", 0)
    monkeypatch.setattr(tband, "SYM_MIN_BYTES", 0)
    # triu storage halves the band: the split pays only past ~2e8 bytes
    A = _banded_spd_with_outliers(n=16000 if sym else 8000)
    n = A.shape[0]
    jamg, jlay = jband.setup_band_amg(A, sym=sym)
    tamg, tlay = tband.setup_band_amg(A, sym=sym)
    jlv, tlv = jamg.levels[0], tamg.levels[0]
    assert tlv.oob is not None and (tlv.dvec is not None) == sym
    assert torch.equal(tlv.A.dense, convert.tensor(jlv.A.dense))
    assert torch.equal(tlv.oob.rows, convert.tensor(jlv.oob.rows).long())
    assert torch.equal(tlv.oob.vals, convert.tensor(jlv.oob.vals))
    x = np.cos(np.arange(n) * 0.37).astype(np.float32)
    y = tband.band_apply(tlv.A, tlv.dvec, torch.as_tensor(x),
                         tlv.oob).numpy()
    yj = np.asarray(jband.band_apply(jlv.A, jlv.dvec, jnp.asarray(x),
                                     jlv.oob))
    np.testing.assert_allclose(y, yj, rtol=1e-5, atol=1e-5)
    ref = A @ x.astype(np.float64)
    assert np.abs(y - ref).max() <= 2e-4 * np.abs(ref).max()
    # a value refresh reaches the band, the diagonal and the sidecar
    A2 = (1.07 * A + 0.3 * sp.eye(n)).tocsr()     # symmetric, same pattern
    A2.sum_duplicates()
    assert np.array_equal(A2.indices, A.indices)
    tband.update_fine_values(tamg, tlay, A2.data)
    jamg2 = jband.update_fine_values(jamg, jlay, A2.data)
    jlv2 = jamg2.levels[0]
    assert torch.equal(tlv.A.dense, convert.tensor(jlv2.A.dense))
    assert torch.equal(tlv.oob.vals, convert.tensor(jlv2.oob.vals))
    if sym:
        assert torch.equal(tlv.dvec, convert.tensor(jlv2.dvec))
    y2 = tband.band_apply(tlv.A, tlv.dvec, torch.as_tensor(x),
                          tlv.oob).numpy()
    ref2 = A2 @ x.astype(np.float64)
    assert np.abs(y2 - ref2).max() <= 2e-4 * np.abs(ref2).max()
