"""Port's block-tridiagonal factor (xfemm_tpu_torch/ops/blocktri.py;
the sweep kernels K2-K4 on their plain CPU path) against the JAX
package: layout, the fused and chunked factor builds, the apply (JAX
scan lowering and Pallas kernels in interpret mode), and bt_pcg."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import blocktri as jbt
from xfemm_tpu.ops import pallas_band
from xfemm_tpu_torch import convert
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import blocktri as tbt


@pytest.fixture(autouse=True)
def _scan_lowering(monkeypatch):
    monkeypatch.delenv("XFEMM_TPU_PALLAS", raising=False)
    monkeypatch.setattr(pallas_band, "INTERPRET", True)
    jband._pallas_enabled.cache_clear()
    yield
    jband._pallas_enabled.cache_clear()


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


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_pack_layout_equals_jax():
    A = _banded_spd(700, 90)
    lt, lj = tbt.pack_layout(A, 128), jbt.pack_layout(A, 128)
    for a, b in zip(lt, lj):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("build", ["fused", "chunked"])
def test_factor_build_matches_jax(build):
    A = _banded_spd(900, 100, seed=2)
    lay = jbt.pack_layout(A, 128)
    if build == "fused":
        fj = jbt.build_factor(jbt.device_maps(lay), A.data, b=128,
                              NB=lay.NB)
        ft = tbt.build_factor(tbt.device_maps(tbt.pack_layout(A, 128)),
                              A.data, b=128, NB=lay.NB)
    else:
        fj = jbt.build_factor_chunked(lay, A.data, chunk=2)
        ft = tbt.build_factor_chunked(tbt.pack_layout(A, 128), A.data,
                                      chunk=2)
    for a, b in zip(ft, fj):
        assert tuple(a.shape) == tuple(b.shape)
        assert _rel(a.numpy(), b) < 1e-5


def _random_factor(rng, b, NB):
    Sinv = np.stack([np.eye(b) + 0.01 * rng.standard_normal((b, b))
                     for _ in range(NB)]).astype(np.float32)
    Sinv = (Sinv + Sinv.transpose(0, 2, 1)) / 2
    G = (0.05 * rng.standard_normal((NB - 1, b, b))).astype(np.float32)
    s = (np.abs(rng.standard_normal(NB * b)) + 0.5).astype(np.float32)
    return jbt.BTFactor(Sinv=jnp.asarray(Sinv), G=jnp.asarray(G),
                        s=jnp.asarray(s))


@pytest.mark.parametrize("source", ["random", "factored"])
@pytest.mark.parametrize("path", ["scan", "pallas"])
def test_bt_apply_matches_jax(source, path, monkeypatch):
    rng = np.random.default_rng(4)
    if source == "random":
        fj = _random_factor(rng, 128, 5)
        n = 5 * 128 - 23
    else:
        A = _banded_spd(700, 90, seed=7)
        lay = jbt.pack_layout(A, 128)
        fj = jbt.build_factor(jbt.device_maps(lay), A.data, b=128,
                              NB=lay.NB)
        n = A.shape[0]
    r = rng.standard_normal(n).astype(np.float32)
    if path == "pallas":
        monkeypatch.setenv("XFEMM_TPU_PALLAS", "1")
        jband._pallas_enabled.cache_clear()
    z_ref = np.asarray(jbt.bt_apply(fj, jnp.asarray(r)))
    z = tbt.bt_apply(convert.bt_factor(fj), torch.as_tensor(r)).numpy()
    scale = np.abs(z_ref).max() + 1e-30
    np.testing.assert_allclose(z / scale, z_ref / scale, rtol=1e-5,
                               atol=1e-5)


def test_bt_apply_bf16_factor_close_to_f32():
    """An opt-in bf16 factor: the sweeps round the carried vector to
    bf16 as the JAX kernels do, and stay within the bf16 aggregate
    bound of the f32 apply."""
    rng = np.random.default_rng(9)
    fj = _random_factor(rng, 128, 4)
    f32 = convert.bt_factor(fj)
    f16 = tbt.BTFactor(Sinv=f32.Sinv.bfloat16(), G=f32.G.bfloat16(),
                       s=f32.s)
    r = torch.as_tensor(rng.standard_normal(4 * 128).astype(np.float32))
    z32 = tbt.bt_apply(f32, r).numpy()
    z16 = tbt.bt_apply(f16, r).numpy()
    assert _rel(z16, z32) < 3e-2


def test_bt_pcg_matches_jax():
    A = _banded_spd(700, 90, seed=3)
    rng = np.random.default_rng(4)
    A1 = A.copy()
    A1.data = A1.data * (1.0 + 0.1 * rng.random(A1.nnz))
    A1 = (A1 + A1.T) / 2.0
    A1 = (A1 + sp.diags(np.abs(A1).sum(axis=1).A1 * 0.05)).tocsr()
    A1.sum_duplicates()
    n = A.shape[0]
    lay = jbt.pack_layout(A, 128)
    fj = jbt.build_factor(jbt.device_maps(lay), A.data, b=128, NB=lay.NB)
    layb = jband.pack_band_layout(A1, 128, 128)
    jA = jband.fill_band_device(layb, A1.data, 128)
    invd = (1.0 / A1.diagonal()).astype(np.float32)
    x_true = rng.normal(size=n)
    rhs = (A1 @ x_true).astype(np.float32)
    jx, jrel, jit = jbt.bt_pcg(jA, None, jnp.asarray(invd), fj,
                               jnp.asarray(rhs), jnp.float32(1e-7),
                               jnp.zeros(n, jnp.float32), 100)
    tx, trel, tit = tbt.bt_pcg(convert.band_matrix(jA), None,
                               torch.as_tensor(invd),
                               convert.bt_factor(fj), torch.as_tensor(rhs),
                               1e-7, torch.zeros(n), 100)
    assert abs(tit - int(jit)) <= 1 and tit <= 30
    assert trel <= 1e-7
    err = np.abs(tx.numpy() - x_true).max() / np.abs(x_true).max()
    assert err < 1e-4
    assert _rel(tx.numpy(), np.asarray(jx)) < 1e-5


@pytest.mark.parametrize("build", ["fused", "chunked"])
def test_bf16_store_matches_jax(build):
    """The bf16 factor store of a BTSmoother: the fused and the chunked
    build give the JAX package's fused bf16 factor (f32 recurrence,
    blocks rounded to bf16 on store), within one bf16 rounding."""
    A = _banded_spd(900, 100, seed=11)
    lay = jbt.pack_layout(A, 128)
    fj = jbt.build_factor(jbt.device_maps(lay), A.data, b=128, NB=lay.NB,
                          store_dtype=jnp.bfloat16)
    lt = tbt.pack_layout(A, 128)
    if build == "fused":
        ft = tbt.bt_build(tbt.device_maps(lt), A.data, b=128, NB=lt.NB,
                          store_dtype=torch.bfloat16)
    else:
        ft = tbt.build_factor_chunked(lt, A.data, store_dtype=torch.bfloat16,
                                      chunk=3)
    for a, b in zip(ft[:2], fj[:2]):
        assert a.dtype == torch.bfloat16
        assert tuple(a.shape) == tuple(b.shape)
        assert _rel(a.float().numpy(), np.asarray(b, np.float32)) < 1e-2
    r = np.random.default_rng(2).standard_normal(A.shape[0]) \
        .astype(np.float32)
    zj = np.asarray(jbt.bt_apply(jbt.BTSmoother(*fj), jnp.asarray(r)))
    zt = tbt.bt_apply(tbt.BTSmoother(*ft), torch.as_tensor(r)).numpy()
    assert _rel(zt, zj) < 3e-2


def test_bt_pcg_with_sidecar_matches_jax():
    """bt_pcg's operator carries the sidecar (``oob``) of a split level
    while the factor covers only the kept band."""
    import test_torch_band_sym
    A = test_torch_band_sym._banded_spd_with_outliers()
    n = A.shape[0]
    jamg, jlay = jband.setup_band_amg(A)
    tamg, _tlay = tband.setup_band_amg(A)
    jlv, tlv = jamg.levels[0], tamg.levels[0]
    assert jlv.oob is not None and tlv.oob is not None
    keep = np.zeros(A.nnz, bool)
    keep[jlay.keep_sel] = True
    Ak, _ = jband._split_csr(A, keep)
    lay = jbt.pack_layout(Ak, jbt.pick_block(jbt.bandwidth(Ak)))
    fj = jbt.build_factor(jbt.device_maps(lay), Ak.data, b=lay.b, NB=lay.NB)
    rhs = (A @ np.random.default_rng(3).normal(size=n)).astype(np.float32)
    jx, jrel, jit = jbt.bt_pcg(jlv.A, jlv.dvec, jlv.invd, fj,
                               jnp.asarray(rhs), jnp.float32(1e-6),
                               jnp.zeros(n, jnp.float32), 200, oob=jlv.oob)
    tx, trel, tit = tbt.bt_pcg(tlv.A, tlv.dvec, tlv.invd,
                               convert.bt_factor(fj), torch.as_tensor(rhs),
                               1e-6, torch.zeros(n), 200, oob=tlv.oob)
    assert trel <= 2e-6 and float(jrel) <= 2e-6
    assert abs(tit - int(jit)) <= max(2, int(jit) // 10), (tit, jit)
    assert _rel(tx.numpy(), np.asarray(jx)) < 1e-4
