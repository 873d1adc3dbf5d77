"""bt_fwd, the port's forward block-Thomas sweep
(xfemm_tpu_torch/ops/kernels.py: the persistent kernel csrc/bt_fwd.cu on
the card, its plain version on CPU tensors): the plain version against a
float64 numpy recurrence, the whole apply against the JAX package's
Pallas kernels (interpret mode), and the kernel's row split and
shared-memory ring plan, which the card's launch takes from Python."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bt_qbwd import (DTYPES, H100_SMS, _factor,  # noqa: F401
                                lowering)
from xfemm_tpu.ops import blocktri as jbt
from xfemm_tpu_torch import convert
from xfemm_tpu_torch.ops import blocktri as tbt
from xfemm_tpu_torch.ops import kernels

#: against a reference, relative to max|y|: only the fp32 summation
#: order differs (every side rounds the same carry alike)
TOL = 1e-5


def _bf16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even), as
    float64."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32).astype(np.float64)


def _sweep_inputs(rng, b, NB, dtype):
    G = torch.as_tensor((0.3 / b ** 0.5 * rng.standard_normal((NB - 1, b, b)))
                        .astype(np.float32)).to(dtype)
    r = torch.as_tensor(rng.standard_normal((NB, b)).astype(np.float32))
    return G, r


def _rel(y, ref):
    return np.abs(y - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("NB", [1, 2, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bt_fwd_plain_matches_numpy_recurrence(dtype, NB):
    """bt_fwd_plain against y_0 = r_0, y_t = r_t - G_{t-1} y^_{t-1} in
    float64, y^ the carry rounded to the factor's storage type: step by
    step from the plain version's own y_{t-1} (so a bf16 rounding that a
    1e-7 difference could flip sees the same value on both sides), and,
    in f32 where nothing is rounded, as one whole chain."""
    rng = np.random.default_rng(40 + NB)
    b = 128
    G, r = _sweep_inputs(rng, b, NB, dtype)
    y = kernels.bt_fwd_plain(G, r)
    assert y.dtype == torch.float32 and y.shape == (NB, b)
    Gd, rd, yd = (G.float().numpy().astype(np.float64),
                  r.numpy().astype(np.float64), y.numpy())
    rnd = _bf16 if dtype == torch.bfloat16 else \
        (lambda v: np.asarray(v, np.float64))
    if dtype == torch.bfloat16:   # the numpy rounding is torch's
        assert np.array_equal(
            _bf16(yd), y.to(torch.bfloat16).float().numpy())
    assert np.array_equal(yd[0], r.numpy()[0])
    ref = rd.copy()
    for t in range(1, NB):
        ref[t] = rd[t] - Gd[t - 1] @ rnd(yd[t - 1])
    assert _rel(yd, ref) <= TOL
    if dtype == torch.float32:
        chain = rd.copy()
        for t in range(1, NB):
            chain[t] = rd[t] - Gd[t - 1] @ chain[t - 1]
        assert _rel(yd, chain) <= TOL


def test_bt_fwd_cpu_is_plain_and_counts_nothing():
    """On CPU tensors bt_fwd is its plain version and counts no launch."""
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.bfloat16):
        G, r = _sweep_inputs(rng, 128, 5, dtype)
        before = dict(kernels.LAUNCHES)
        assert torch.equal(kernels.bt_fwd(G, r), kernels.bt_fwd_plain(G, r))
        assert kernels.LAUNCHES == before
    assert "bt_fwd" in kernels.LAUNCHES


@pytest.mark.parametrize("NB", [2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bt_apply_b256_matches_jax_pallas_kernels(dtype, NB, lowering):
    """The whole apply (blocktri.bt_apply: bt_fwd, then bt_qbwd) against
    the JAX package's fwd_kernel, q_kernel and bwd_kernel at b=256."""
    lowering("pallas")
    rng = np.random.default_rng(20 + NB)
    b = 256
    fj = _factor(rng, b, NB, DTYPES[dtype][0])
    n = NB * b - 41
    r = rng.standard_normal(n).astype(np.float32)
    z_ref = np.asarray(jbt.bt_apply(fj, jnp.asarray(r)))
    ft = convert.bt_factor(fj)
    assert ft.G.dtype == DTYPES[dtype][1]
    z = tbt.bt_apply(ft, torch.as_tensor(r)).numpy()
    assert _rel(z, z_ref) <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b", tbt.BLOCK_SIZES)
def test_fwd_plan(b, dtype):
    """The plan of every supported block size on an H100: the blocks'
    rows cover 0..b-1 exactly once, at most one block per SM, the chunks
    cover a block's rows, the ring has at least two stages, and the
    block's shared memory is the kernel's formula and fits the card's
    232,448 bytes."""
    plan = kernels._fwd_plan(b, dtype, H100_SMS)
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
    assert plan.smem_bytes == kernels._fwd_smem(b, item, plan.stage_rows,
                                                plan.stages)
    assert plan.smem_bytes == (1024 + plan.stages * plan.stage_rows * b * item
                               + 2 * 4 * b)
    assert plan.smem_bytes <= 232_448
