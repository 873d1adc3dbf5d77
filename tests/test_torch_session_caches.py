"""What the port keeps between solves (``ops/solver``), on the CPU and on
small synthetic systems, with no solve on a mesh.

Every cache goes through one recency rule (``lru_get`` / ``lru_put``);
the real and the complex CSR come from one COO->CSR pattern
(``csr_pattern``), held to a plain ``scipy.sparse`` build with the same
Dirichlet elimination; and the band state a session changes after its
entry was stored (the device loop's hierarchy, a refactor, a dropped
factor) is written back (``keep_band``), so the next session that adopts
the entry runs on it.
"""

import collections

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from xfemm_tpu_torch.ops import band, newton, solver
from xfemm_tpu_torch.ops.solver import ElementBlock

torch.set_num_threads(1)

CPU = torch.device("cpu")
HBM = 1e9


@pytest.fixture
def fresh(monkeypatch):
    """Empty band and pattern caches, the band engine from 4 x 64
    unknowns."""
    monkeypatch.setattr(solver, "ROW_TILE_MIN", 64)
    for name in ("_BAND_CACHE", "_PATTERN_CACHE"):
        monkeypatch.setattr(solver, name, collections.OrderedDict())


def grid(nx: int, ny: int):
    """The P1 stiffness blocks of an nx x ny grid of unit squares cut
    into triangles, with the boundary nodes fixed. Returns ``(blocks,
    n, fixed, coords)``."""
    xy = np.stack(np.meshgrid(np.arange(nx, dtype=float),
                              np.arange(ny, dtype=float),
                              indexing="ij"), -1).reshape(-1, 2)
    node = np.arange(nx * ny).reshape(nx, ny)
    a, b = node[:-1, :-1].ravel(), node[1:, :-1].ravel()
    c, d = node[:-1, 1:].ravel(), node[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])
    v = xy[tris]
    p = np.roll(v[:, :, 1], -1, 1) - np.roll(v[:, :, 1], 1, 1)
    q = np.roll(v[:, :, 0], 1, 1) - np.roll(v[:, :, 0], -1, 1)
    area = 0.5 * np.abs(p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0])
    mat = (p[:, :, None] * p[:, None, :]
           + q[:, :, None] * q[:, None, :]) / (4.0 * area[:, None, None])
    blocks = (ElementBlock(idx=tris, sign=np.ones(tris.shape), mat=mat),)
    ij = np.indices((nx, ny)).reshape(2, -1).T
    fixed = ((ij == 0) | (ij == [nx - 1, ny - 1])).any(1)
    return blocks, nx * ny, fixed, xy


def scipy_csr(blocks, n: int, fixed, dtype):
    """The Dirichlet-eliminated CSR as a plain COO build: entries of
    fixed rows and columns zeroed, every diagonal present, unit
    diagonals on fixed and empty rows."""
    rows, cols, vals = [], [], []
    for b in blocks:
        K = b.idx.shape[1]
        rows.append(np.repeat(b.idx, K, axis=1).ravel())
        cols.append(np.tile(b.idx, (1, K)).ravel())
        vals.append((b.sign[:, :, None] * b.sign[:, None, :]
                     * np.asarray(b.mat, dtype)).ravel())
    r, c, v = map(np.concatenate, (rows, cols, vals))
    v = v * (~fixed[r] & ~fixed[c])
    diag = np.arange(n)
    A = sp.coo_matrix((np.concatenate([v, np.zeros(n, dtype)]),
                       (np.concatenate([r, diag]), np.concatenate([c, diag]))),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    d = A.diagonal()
    d[fixed | (d == 0)] = 1.0
    A.setdiag(d)
    return A


def test_the_lru_rule_refreshes_a_hit_and_evicts_the_oldest():
    cache = collections.OrderedDict()
    for k in "abc":
        solver.lru_put(cache, k, k.upper(), 3)
    assert solver.lru_get(cache, "a") == "A"
    solver.lru_put(cache, "d", "D", 3)
    assert list(cache) == ["c", "a", "d"]
    # a miss gives the default and moves nothing; a stored None (the AC
    # cache's "no band engine") is an entry, told apart by the default
    assert solver.lru_get(cache, "b", "miss") == "miss"
    solver.lru_put(cache, "c", None, 3)
    assert list(cache) == ["a", "d", "c"]
    assert solver.lru_get(cache, "c", "miss") is None
    solver.lru_put(cache, "e", "E", 2)
    assert list(cache) == ["c", "e"]


def test_real_and_complex_csr_share_one_pattern(fresh):
    """Two blocks (triangles with antiperiodic signs, and 2-node edges),
    a Dirichlet set and DOFs no element touches: the real CSR of a
    Session and the complex CSR of an AC solve equal the scipy build
    (the same pattern, the values to rounding) and share one entry."""
    rng = np.random.default_rng(7)
    (tri,), n, fixed, _xy = grid(7, 6)
    n += 3
    fixed = np.concatenate([fixed[:-5], np.zeros(8, bool)])
    edges = rng.integers(0, n - 3, (20, 2))
    idx = (tri.idx, edges)
    sign = tuple(rng.choice([-1.0, 1.0], i.shape) for i in idx)
    real = tuple(rng.normal(size=i.shape + (i.shape[1],)) for i in idx)
    imag = tuple(rng.normal(size=i.shape + (i.shape[1],)) for i in idx)
    blocks_r = [ElementBlock(*t) for t in zip(idx, sign, real)]
    blocks_c = [ElementBlock(i, s, r + 1j * m)
                for i, s, r, m in zip(idx, sign, real, imag)]
    Ar = solver.Session().csr_values(blocks_r, n, fixed)
    Ac = solver._ac_csr(blocks_c, n, fixed)
    for A, blocks, dtype in ((Ar, blocks_r, np.float64),
                             (Ac, blocks_c, np.complex128)):
        ref = scipy_csr(blocks, n, fixed, dtype)
        assert A.dtype == dtype
        assert np.array_equal(A.indptr, ref.indptr)
        assert np.array_equal(A.indices, ref.indices)
        np.testing.assert_allclose(A.data, ref.data, rtol=1e-13,
                                   atol=1e-13)
    assert len(solver._PATTERN_CACHE) == 1


def test_a_new_session_adopts_what_the_last_one_wrote_back(fresh,
                                                           monkeypatch):
    """The bt-alone band of a 24 x 24 grid: after the device loop's tail,
    a refactor and a dropped factor, each new Session adopts the written
    back hierarchy and factor, the same objects. The V-cycle coarsens
    down to 100 unknowns, so the dropped factor's hierarchy has a fine
    level at this size."""
    monkeypatch.setattr(band, "COARSE_MAX", 100)
    blocks, n, fixed, xy = grid(24, 24)
    zero = np.zeros(n)
    first = solver.Session()
    solver.solve(blocks, np.ones(n), fixed, zero, 1e-8, coords=xy,
                 session=first, device=CPU, hbm=HBM)
    assert first.bt is not None and len(solver._BAND_CACHE) == 1

    def adopt():
        sess = solver.Session()
        At = sess.csr_values(blocks, n, fixed)
        solver._prepare_band(sess, At, fixed, xy, n, CPU, HBM)
        return sess, At

    old = first.band_amg
    newton.keep_loop_band(first, old.levels[0].dvec, None)
    assert first.band_amg is not old
    sess, At = adopt()
    assert sess.band_amg is first.band_amg and sess.bt is first.bt

    # a stale factor is refactored and written back
    sess.first_iters, sess.last_iters = 1, 100
    solver._prepare_band(sess, At, fixed, xy, n, CPU, HBM)
    assert sess.bt is not first.bt
    again, At = adopt()
    assert again.bt is sess.bt

    # a dropped factor: the V-cycle's coarse levels are built and kept
    solver._drop_factor(again, At, xy, CPU)
    assert again.bt is None and len(again.band_amg.levels) > 1
    last, _At = adopt()
    assert last.bt is None
    assert last.band_amg is again.band_amg
    assert last.band_layout is again.band_layout
