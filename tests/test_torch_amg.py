"""The port's ELL-AMG engine (xfemm_tpu_torch/ops/amg.py and the
solver's ``_pcg_amg_impl``) against the JAX package on the CPU: the f64
host setup level by level, the ELLPACK layouts, and the f32 V-cycle and
AMG-PCG on the same float32 inputs."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from xfemm_tpu.ops import amg as jamg
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch.ops import amg as tamg
from xfemm_tpu_torch.ops import loop as tloop
from xfemm_tpu_torch.ops import solver as tsolver

torch.set_num_threads(1)


def _grid(nx, ny, seed=0):
    """A triangulated grid's 7-point stencil with varying coefficients
    (SPD), its node coordinates, and the boundary as Dirichlet DOFs
    eliminated to identity rows/columns."""
    rng = np.random.default_rng(seed)
    n = nx * ny
    ii = np.arange(n)
    x, y = ii % nx, ii // nx
    rows, cols, vals = [], [], []
    for dx, dy in ((1, 0), (0, 1), (1, 1)):
        ok = (x + dx < nx) & (y + dy < ny)
        a, b = ii[ok], ((y + dy) * nx + (x + dx))[ok]
        w = rng.uniform(0.5, 2.0, a.size)
        rows += [a, b, a, b]
        cols += [b, a, a, b]
        vals += [-w, -w, w, w]
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    fixed = (x == 0) | (y == 0) | (x == nx - 1) | (y == ny - 1)
    keep = sp.diags((~fixed).astype(float))
    At = (keep @ A @ keep + sp.diags(fixed.astype(float))).tocsr()
    At.sum_duplicates()
    coords = np.stack([x, y], 1).astype(np.float64)
    return At, coords, fixed


def _csr_close(a, b, tol=1e-12):
    d = (a - b).tocsr()
    scale = max(abs(b).max(), 1e-300)
    return (abs(d).max() if d.nnz else 0.0) <= tol * scale


@pytest.mark.parametrize("nx", [70, 30])
def test_setup_levels_match_jax(nx):
    """Host setup (f64, same code): every level's A, P, R, 1/diag and
    weight to 1e-12 of each matrix's largest entry. 70x70 = 4900
    unknowns gives two levels and a dense bottom; 30x30 = 900 (at most
    COARSE_MAX) gives the bottom level alone."""
    At, coords, fixed = _grid(nx, nx)
    jl = jamg.setup(At, coords, fixed)
    tl = tamg.setup(At, coords, fixed)
    assert len(tl) == len(jl) == (2 if nx == 70 else 1)
    for a, b in zip(tl, jl):
        assert _csr_close(a.A, b.A)
        assert np.allclose(a.invd, b.invd, rtol=1e-12, atol=0)
        assert float(a.omega) == float(b.omega)
        assert (a.P is None) == (b.P is None)
        if a.P is not None:
            assert _csr_close(a.P, b.P) and _csr_close(a.R, b.R)
    assert tamg.setup(At, None, fixed) is None


def test_ell_layouts_match_jax():
    At, coords, fixed = _grid(40, 40)
    P = tamg.setup(At, coords, fixed)[0].P
    for t, j in ((tamg.csr_to_ell(At), jamg.csr_to_ell(At)),
                 (tamg.csr_to_ell_rect(P), jamg.csr_to_ell_rect(P))):
        assert np.array_equal(t.cols, j.cols)
        assert np.array_equal(t.vals, j.vals) and t.shape == j.shape


@pytest.mark.parametrize("nx", [70, 30])
def test_vcycle_matches_jax(nx):
    """One V-cycle on the same f32 hierarchy: z to 1e-5 of max|z| (the
    restriction's scatter-add sums in another order). With no levels
    (30x30) it is the dense bottom product alone."""
    At, coords, fixed = _grid(nx, nx)
    levels = tamg.setup(At, coords, fixed)
    jd = jamg.to_device(levels, np.float32)
    td = tamg.to_device(levels, np.float32, "cpu")
    assert len(td.levels) == len(jd.levels)
    assert td.coarse_inv.dtype == torch.float32
    r = np.random.default_rng(1).standard_normal(At.shape[0]) \
        .astype(np.float32)
    zj = np.asarray(jamg.vcycle(jd, jnp.asarray(r)))
    zt = tamg.vcycle(td, torch.as_tensor(r)).numpy()
    assert np.abs(zt - zj).max() <= 1e-5 * np.abs(zj).max()


def test_pcg_amg_matches_jax():
    """AMG-PCG on the ELLPACK operator, float32 on both sides, stopping
    at 1e-5: x to 1e-4 relative (l2), iterations within 2, and the
    returned metric at the tolerance."""
    At, coords, fixed = _grid(80, 80, seed=3)
    n = At.shape[0]
    levels = tamg.setup(At, coords, fixed)
    ell = tamg.csr_to_ell(At)
    b = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    b[fixed] = 0.0
    jd = jamg.to_device(levels, np.float32)
    xj, rj, itj = jsolver._pcg_amg_impl(
        jd, jnp.asarray(ell.vals), jnp.asarray(ell.cols), jnp.asarray(b),
        jnp.asarray(1e-5, jnp.float32), jnp.zeros(n, jnp.float32), 500)
    td = tamg.to_device(levels, np.float32, "cpu")
    masked0 = tsolver.MASKED["ell-amg"]
    xt, rt, itt = tsolver._pcg_amg_impl(
        td, torch.as_tensor(ell.vals), torch.as_tensor(ell.cols).long(),
        torch.as_tensor(b), 1e-5, torch.zeros(n), 500)
    xj = np.asarray(xj)
    assert abs(itt - int(itj)) <= 2, (itt, int(itj))
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-4 * np.linalg.norm(xj)
    assert rt <= 1e-5 and float(rj) <= 1e-5
    # the loop driver reads each flag IN_FLIGHT iterations late on the
    # CPU as on the card: at most IN_FLIGHT masked iterations
    assert 0 <= tsolver.MASKED["ell-amg"] - masked0 <= tloop.IN_FLIGHT
