"""bt_qbwd, the port's fused Sinv product and backward block-Thomas
sweep (xfemm_tpu_torch/ops/kernels.py: the persistent kernel
csrc/bt_qbwd.cu on the card, its plain version on CPU tensors), against
the JAX package's q_kernel and bwd_kernel (Pallas, interpret mode) and
its scan lowering; and the kernel's row split and shared-memory ring
plan, which the card's launch takes from Python."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import blocktri as jbt
from xfemm_tpu.ops import pallas_band
from xfemm_tpu_torch import convert
from xfemm_tpu_torch.ops import blocktri as tbt
from xfemm_tpu_torch.ops import kernels

#: an H100's SM count
H100_SMS = 132
#: kernel against reference, relative to max|z|: only the fp32
#: summation order differs
TOL = 1e-5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def lowering(monkeypatch):
    """Select the JAX package's bt_apply lowering: ``lowering("pallas")``
    (its three Pallas kernels in interpret mode) or ``"scan"``."""
    monkeypatch.setattr(pallas_band, "INTERPRET", True)

    def use(path):
        if path == "pallas":
            monkeypatch.setenv("XFEMM_TPU_PALLAS", "1")
        else:
            monkeypatch.delenv("XFEMM_TPU_PALLAS", raising=False)
        jband._pallas_enabled.cache_clear()

    yield use
    jband._pallas_enabled.cache_clear()


def _factor(rng, b, NB, jdtype, s=None):
    Sinv = np.stack([np.eye(b) + 0.01 * rng.standard_normal((b, b))
                     for _ in range(NB)])
    Sinv = (Sinv + Sinv.transpose(0, 2, 1)) / 2
    G = 0.05 * rng.standard_normal((NB - 1, b, b))
    if s is None:
        s = np.abs(rng.standard_normal(NB * b)) + 0.5
    return jbt.BTFactor(Sinv=jnp.asarray(Sinv, jdtype),
                        G=jnp.asarray(G, jdtype),
                        s=jnp.asarray(s, jnp.float32))


def _apply_via_qbwd(ft, r):
    """bt_apply with the backward half spelled out: bt_fwd, then
    kernels.bt_qbwd."""
    NB, b, _ = ft.Sinv.shape
    n = r.shape[0]
    rs = torch.zeros(NB * b)
    rs[:n] = ft.s[:n] * r
    ys = kernels.bt_fwd(ft.G, rs.view(NB, b))
    z = kernels.bt_qbwd(ft.Sinv, ft.G, ys)
    return (ft.s[:n] * z.view(-1)[:n]).numpy()


def _close(z, ref):
    err = np.abs(z - ref).max() / np.abs(ref).max()
    assert err <= TOL, err


@pytest.mark.parametrize("NB", [2, 5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bt_qbwd_matches_jax_pallas_kernels(dtype, NB, lowering):
    """The JAX package's fwd_kernel, q_kernel and bwd_kernel against
    bt_fwd + bt_qbwd on the same factor, f32 or bf16 stored (both round
    the carried vectors to the storage type)."""
    lowering("pallas")
    rng = np.random.default_rng(10 + NB)
    fj = _factor(rng, 128, NB, DTYPES[dtype][0])
    n = NB * 128 - 23
    r = rng.standard_normal(n).astype(np.float32)
    z_ref = np.asarray(jbt.bt_apply(fj, jnp.asarray(r)))
    ft = convert.bt_factor(fj)
    assert ft.Sinv.dtype == DTYPES[dtype][1]
    _close(_apply_via_qbwd(ft, torch.as_tensor(r)), z_ref)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bt_qbwd_single_block_matches_scan(dtype, lowering):
    """NB = 1 (no G; the JAX package takes its scan lowering there): z =
    Sinv_0 y_0. The input is bf16-representable and the scaling 1, so
    rounding y to the factor's storage changes nothing on either side."""
    lowering("scan")
    rng = np.random.default_rng(3)
    b = 128
    fj = _factor(rng, b, 1, DTYPES[dtype][0], s=np.ones(b))
    r = np.asarray(jnp.asarray(rng.standard_normal(b), jnp.bfloat16),
                   np.float32)
    z_ref = np.asarray(jbt.bt_apply(fj, jnp.asarray(r)))
    ft = convert.bt_factor(fj)
    assert tuple(ft.G.shape) == (0, b, b)
    _close(_apply_via_qbwd(ft, torch.as_tensor(r)), z_ref)


def test_bt_qbwd_cpu_is_plain_and_counts_nothing():
    """On CPU tensors bt_qbwd is its plain version (the Sinv products,
    then the backward sweep), bt_apply goes through it, and no launch is
    counted."""
    rng = np.random.default_rng(5)
    ft = convert.bt_factor(_factor(rng, 128, 4, jnp.float32))
    y = torch.as_tensor(rng.standard_normal((4, 128)).astype(np.float32))
    before = dict(kernels.LAUNCHES)
    z = kernels.bt_qbwd(ft.Sinv, ft.G, y)
    ref = kernels.bt_bwd_plain(ft.G, kernels.bt_q_plain(ft.Sinv, y))
    assert torch.equal(z, ref)
    tbt.bt_apply(ft, torch.as_tensor(rng.standard_normal(500)
                                     .astype(np.float32)))
    assert kernels.LAUNCHES == before
    assert "bt_qbwd" in kernels.LAUNCHES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b", tbt.BLOCK_SIZES)
def test_qbwd_plan(b, dtype):
    """The plan of every supported block size on an H100: the blocks'
    rows cover 0..b-1 exactly once, at most one block per SM, the
    chunks cover a block's rows, the ring has at least two stages, and
    the block's shared memory fits the card's 232,448 bytes."""
    plan = kernels._qbwd_plan(b, dtype, H100_SMS)
    # block k owns rows k*rows .. (the kernel's row0 and myrows)
    ranges = [(k * plan.rows, min(plan.rows, b - k * plan.rows))
              for k in range(plan.blocks)]
    assert len(ranges) == plan.blocks <= H100_SMS
    covered = np.concatenate([np.arange(r0, r0 + c) for r0, c in ranges])
    assert min(c for _, c in ranges) >= 1
    assert np.array_equal(covered, np.arange(b))
    assert plan.chunks * plan.stage_rows >= plan.rows
    assert plan.stages >= 2
    item = torch.empty((), dtype=dtype).element_size()
    assert plan.smem_bytes == kernels._qbwd_smem(
        b, item, plan.rows, plan.blocks, plan.stage_rows, plan.stages)
    assert plan.smem_bytes <= 232_448
