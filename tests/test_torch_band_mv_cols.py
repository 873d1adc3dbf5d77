"""K1 with one or two columns (xfemm_tpu_torch/ops/kernels.py band_mv:
the persistent kernel csrc/band_mv.cu on the card, its plain version on
CPU tensors) against the JAX package: each column of a two-column
product against ``band.band_matvec`` on that column, through the XLA
lowering and the Pallas kernel in interpret mode; the AC complex apply
(``band._complex_op``, two two-column products) against the JAX
package's four one-column products; and the kernel's work split and
shared-memory ring plan (``kernels._mv_plan``), which the card's launch
takes from Python."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_band import _random_band, _xla_band  # noqa: F401
from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import pallas_band
from xfemm_tpu_torch import convert
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import kernels

#: against the JAX package, relative and in units of max|y| (the AC
#: bands sum 2,560 products a row, so a small entry carries the rounding
#: of the large ones): only the fp32 summation order differs
TOL = 1e-5
#: a bf16 band against the f32 product, in aggregate (8 mantissa bits)
BF16_AGG = 3e-2
H100_SMS = 132
SMEM_LIMIT = 232_448

SHAPES = [(3, 128, 2, -1), (4, 128, 3, 1), (3, 256, 3, -1), (2, 256, 2, 0),
          (3, 512, 5, -2)]          # the last: the AC bands' R and K


def _jbm(dense, shift0, cchunk, ncols, dtype):
    jdense = jnp.asarray(dense)
    if dtype == "bf16":
        jdense = jdense.astype(jnp.bfloat16)
    return jband.BandMatrix(dense=jdense, shift0=shift0, cchunk=cchunk,
                            ncols=ncols)


@pytest.mark.parametrize("NT,R,K,shift0", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_columns_match_jax_per_column(NT, R, K, shift0, dtype):
    rng = np.random.default_rng(NT * 1000 + R + K)
    dense, x0, ncols = _random_band(rng, NT, R, K, shift0)
    X = np.stack([x0, rng.standard_normal(ncols).astype(np.float32)], 1)
    jbm = _jbm(dense, shift0, R, ncols, dtype)
    tbm = convert.band_matrix(jbm)
    before = dict(kernels.LAUNCHES)
    Y = tband.band_matvec(tbm, torch.as_tensor(X)).numpy()
    assert kernels.LAUNCHES == before    # CPU tensors: plain version
    assert Y.shape == (NT * R, 2)
    for c in range(2):
        xc = jnp.asarray(X[:, c])
        y_xla = np.asarray(jband.band_matvec(jbm, xc))
        y_pallas = np.asarray(pallas_band.band_matvec_pallas(jbm, xc))
        atol = TOL * np.abs(y_xla).max()
        if dtype == "f32":
            np.testing.assert_allclose(Y[:, c], y_xla, rtol=TOL, atol=atol)
            np.testing.assert_allclose(Y[:, c], y_pallas, rtol=TOL,
                                       atol=atol)
        else:
            ref = np.asarray(jband.band_matvec(
                _jbm(dense, shift0, R, ncols, "f32"), xc))
            scale = np.abs(ref).max()
            for other in (Y[:, c], y_xla, y_pallas):
                assert np.abs(other - ref).max() / scale < BF16_AGG
            np.testing.assert_allclose(Y[:, c], y_xla, rtol=TOL, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_one_column_block_is_the_vector_product(dtype):
    """An (ncols, 1) block gives the (ncols,) product as a column, and
    each column of a two-column product is the one-column product."""
    rng = np.random.default_rng(5)
    dense, x0, ncols = _random_band(rng, 3, 128, 3, -1)
    td = torch.as_tensor(dense)
    td = td if dtype == "f32" else td.to(torch.bfloat16)
    X = torch.as_tensor(np.stack(
        [x0, rng.standard_normal(ncols).astype(np.float32)], 1))
    y1 = kernels.band_mv(td, X[:, 0].contiguous(), -1, 128, ncols)
    yb = kernels.band_mv(td, X[:, :1].contiguous(), -1, 128, ncols)
    Y2 = kernels.band_mv(td, X, -1, 128, ncols)
    assert y1.shape == (3 * 128,) and yb.shape == (3 * 128, 1)
    np.testing.assert_allclose(yb[:, 0].numpy(), y1.numpy(), rtol=1e-6,
                               atol=1e-6)
    for c in range(2):
        yc = kernels.band_mv(td, X[:, c].contiguous(), -1, 128, ncols)
        np.testing.assert_allclose(Y2[:, c].numpy(), yc.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("NT,R,K,shift0", [(4, 128, 3, -1), (3, 512, 5, -2)])
def test_complex_op_matches_jax_four_products(NT, R, K, shift0):
    """(Ar + i Ai)(xr + i xi) as the port's two two-column products
    against the JAX package's four one-column ones (xfemm_tpu/ops/
    band.py:1507-1512), on two random bands with one layout."""
    rng = np.random.default_rng(NT + R + K)
    dr, xr, ncols = _random_band(rng, NT, R, K, shift0)
    di = rng.standard_normal(dr.shape).astype(np.float32) \
        * (rng.random(dr.shape) < 0.3)
    xi = rng.standard_normal(ncols).astype(np.float32)
    jr = _jbm(dr, shift0, R, ncols, "f32")
    ji = _jbm(di, shift0, R, ncols, "f32")
    n = ncols
    jxr, jxi = jnp.asarray(xr), jnp.asarray(xi)
    ar_xr = jband.band_matvec(jr, jxr)[:n]
    ar_xi = jband.band_matvec(jr, jxi)[:n]
    ai_xr = jband.band_matvec(ji, jxr)[:n]
    ai_xi = jband.band_matvec(ji, jxi)[:n]
    ref_r = np.asarray(ar_xr - ai_xi)
    ref_i = np.asarray(ar_xi + ai_xr)
    opc = tband._complex_op(convert.band_matrix(jr),
                            convert.band_matrix(ji), n)
    yr, yi = opc(torch.as_tensor(xr), torch.as_tensor(xi))
    scale = max(np.abs(ref_r).max(), np.abs(ref_i).max())
    assert np.abs(yr.numpy() - ref_r).max() / scale <= TOL
    assert np.abs(yi.numpy() - ref_i).max() / scale <= TOL


#: every K1 operand class of the port's paths (NT, R, W, dtype): the 250k
#: band in f32 and bf16, the ac125k Ar/Ai bands and the kernel check's
#: double-height one, hierarchy levels, the bf16 prolongator bands
#: (cchunk 32), the axi250k band, and the shortest bands
PLAN_SHAPES = [
    (1949, 128, 2176, torch.float32), (1949, 128, 2176, torch.bfloat16),
    (244, 512, 2560, torch.float32), (488, 512, 2560, torch.float32),
    (975, 128, 1408, torch.float32), (16, 128, 384, torch.float32),
    (975, 128, 352, torch.bfloat16), (16, 128, 96, torch.bfloat16),
    (1962, 128, 1664, torch.float32), (1, 128, 2176, torch.float32),
    (2, 128, 2176, torch.bfloat16), (1, 512, 2560, torch.float32),
]


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("NT,R,W,dtype", PLAN_SHAPES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}-{str(s[3])[6:]}"
                              for s in PLAN_SHAPES])
def test_mv_plan(NT, R, W, dtype, C):
    """The plan on an H100: the blocks' contiguous item ranges (the
    kernel's i0, i1) cover every (tile, row slab) item exactly once, and
    so every band row; every stage copy is whole rows, a multiple of 16
    bytes; the ring's stages are a multiple of the consumer warps; a row's
    lanes are a power of two; the block's shared memory is the kernel's
    formula and fits the card, as many times as blocks per SM."""
    plan = kernels._mv_plan(NT, R, W, dtype, C, H100_SMS)
    item = torch.empty((), dtype=dtype).element_size()
    spt = -(-R // plan.stage_rows)
    assert plan.items == NT * spt
    assert plan.blocks == min(plan.items, H100_SMS * plan.blocks_per_sm)
    bounds = [plan.items * k // plan.blocks for k in range(plan.blocks + 1)]
    assert bounds[0] == 0 and bounds[-1] == plan.items
    assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
    assert max(b1 - b0 for b0, b1 in zip(bounds, bounds[1:])) \
        - min(b1 - b0 for b0, b1 in zip(bounds, bounds[1:])) <= 1
    i = np.arange(plan.items)
    t, s = i // spt, i % spt
    r0 = s * plan.stage_rows
    nr = np.minimum(plan.stage_rows, R - r0)
    assert (nr >= 1).all()
    rows = np.repeat(t * R + r0, nr) + (np.arange(nr.sum())
                                        - np.repeat(np.cumsum(nr) - nr, nr))
    assert np.array_equal(rows, np.arange(NT * R))
    assert (W * item) % 16 == 0 and (nr * W * item % 16 == 0).all()
    assert plan.stages % kernels._MV_WARPS == 0
    assert kernels._MV_WARPS <= plan.stages <= kernels._MV_MAX_STAGES
    lpr = plan.lanes_per_row
    assert lpr in (1, 2, 4, 8, 16, 32)
    slices = W * item // 16
    assert lpr == 32 or -(-slices // lpr) <= 4
    assert plan.smem_bytes == kernels._mv_smem(W, item, C, plan.stage_rows,
                                               plan.stages)
    assert plan.smem_bytes == (1024 + plan.stages * plan.stage_rows * W * item
                               + C * W * item)
    assert plan.smem_bytes <= SMEM_LIMIT
    # the blocks per SM the ring was sized for fit in one SM (228 KB, 1
    # KB reserved per block)
    assert plan.blocks_per_sm in (1, 2)
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= 233_472


def test_mv_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="columns"):
        kernels._mv_plan(4, 128, 2176, torch.float32, 3, H100_SMS)
    with pytest.raises(ValueError, match="16 bytes"):
        kernels._mv_plan(4, 128, 36, torch.bfloat16, 1, H100_SMS)
    with pytest.raises(ValueError, match="no room"):
        kernels._mv_plan(4, 128, 16384, torch.float32, 2, H100_SMS)
