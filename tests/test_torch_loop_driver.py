"""The port's one host driver of its masked device loops
(``xfemm_tpu_torch/ops/loop.py``): a bounded in-flight window that reads
each iteration's "still active" flag ``IN_FLIGHT`` iterations late, on
the CPU as on the card.

A synthetic loop stops at every position around a chunk boundary: the
driver launches at most ``IN_FLIGHT`` masked iterations (exactly
``min(IN_FLIGHT, iterations left in the chunk)``) and its state equals a
direct early exit bit for bit. The engines (``bt_pcg``, ``band_pcg``,
``_while_pcg`` through ``_pcg_impl``, ``_while_csym`` through
``_pcg_csym_pairs``) give x, metric and iterations bit for bit those of
the direct early exit (``IN_FLIGHT = 0``: the flag read at once), held
to the JAX package's ``while_loop`` at the tolerances of
tests/test_torch_band.py and tests/test_torch_csym.py (x within 1e-5,
iteration counts within 5-10%), with at most ``IN_FLIGHT`` masked
iterations per driver run.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import blocktri as jbt
from xfemm_tpu.ops import pallas_band
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch import convert
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import blocktri as tbt
from xfemm_tpu_torch.ops import loop as tloop
from xfemm_tpu_torch.ops import solver as tsolver

torch.set_num_threads(1)

#: the synthetic loop's chunk (``_chunked_pcg``'s ``check_every``)
CHUNK = 5


@pytest.fixture(autouse=True)
def _xla_band(monkeypatch):
    """The JAX band product through its XLA lowering."""
    monkeypatch.delenv("XFEMM_TPU_PALLAS", raising=False)
    monkeypatch.setattr(pallas_band, "INTERPRET", True)
    jband._pallas_enabled.cache_clear()
    yield
    jband._pallas_enabled.cache_clear()


def _synthetic(stop_at: int):
    """A loop whose flag is ``it < stop_at``; a step adds 1/(it + 1) to
    x where active (masked: adds zero, ``it`` stays)."""
    st = dict(x=torch.zeros((), dtype=torch.float32),
              it=torch.zeros((), dtype=torch.int32))

    def running():
        return st["it"] < stop_at

    def step(active):
        inc = 1.0 / (st["it"].to(torch.float32) + 1.0)
        st["x"] = st["x"] + torch.where(active, inc, torch.zeros_like(inc))
        st["it"] = st["it"] + active.to(torch.int32)

    return st, running, step


def _drive(stop_at: int, limit):
    """The synthetic loop through the driver in runs of ``limit``
    iterations (None: one run), with a host check between runs as in
    ``band._chunked_pcg``. Returns (state, launched, driver runs)."""
    st, running, step = _synthetic(stop_at)
    loops0 = tloop.LOOPS["band"]
    launched = 0
    while True:
        launched += tloop.masked_loop(running, step, "band", limit)
        if not bool(running()):
            break
    return st, launched, tloop.LOOPS["band"] - loops0


def _direct(stop_at: int):
    """The synthetic loop's direct early exit."""
    st, running, step = _synthetic(stop_at)
    while bool(running()):
        step(running())
    return st


@pytest.mark.parametrize("limit", [CHUNK, None])
@pytest.mark.parametrize("stop_at", range(2 * CHUNK + 2))
def test_driver_stops_within_the_window(stop_at, limit):
    st, launched, runs = _drive(stop_at, limit)
    assert torch.equal(st["x"], _direct(stop_at)["x"])
    assert int(st["it"]) == stop_at
    masked = launched - stop_at
    if limit is None:
        want = tloop.IN_FLIGHT
        assert runs == 1
    elif stop_at > 0 and stop_at % CHUNK == 0:
        want = 0                            # the chunk ended at the stop
    else:
        want = min(tloop.IN_FLIGHT, CHUNK - stop_at % CHUNK)
    assert masked == want <= tloop.IN_FLIGHT


@pytest.mark.parametrize("in_flight", [0, 1, 3])
def test_window_width(in_flight, monkeypatch):
    """Another width gives the same state; ``IN_FLIGHT = 0`` reads each
    flag before its step (the direct early exit: nothing masked)."""
    monkeypatch.setattr(tloop, "IN_FLIGHT", in_flight)
    st, launched, _runs = _drive(7, None)
    assert launched - 7 == in_flight
    assert torch.equal(st["x"], _direct(7)["x"]) and int(st["it"]) == 7


# ------------------------------ engines ------------------------------ #
def _laplacian(m: int):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    A = (sp.kron(sp.eye(m), T) + sp.kron(T, sp.eye(m))
         + 1e-3 * sp.eye(m * m)).tocsr()
    A.sum_duplicates()
    return A


def _bt_pcg():
    """``bt_pcg`` on a 2-D Laplacian's band, preconditioned by the
    block-tridiagonal factor of the Laplacian with its diagonal raised
    30% (an inexact factor: tens of iterations)."""
    A = _laplacian(30)
    n = A.shape[0]
    jA = jband.fill_band_device(jband.pack_band_layout(A, 128, 128),
                                A.data, 128)
    Af = (A + 0.3 * sp.diags(A.diagonal())).tocsr()
    Af.sum_duplicates()
    bsize = jbt.pick_block(jbt.bandwidth(Af))
    lay = jbt.pack_layout(Af, bsize)
    jf = jbt.build_factor(jbt.device_maps(lay), Af.data, b=bsize,
                          NB=lay.NB)
    invd = (1.0 / A.diagonal()).astype(np.float32)
    rhs = (A @ np.random.default_rng(12).normal(size=n)).astype(np.float32)
    jx, jrel, jit = jbt.bt_pcg(jA, None, jnp.asarray(invd), jf,
                               jnp.asarray(rhs), jnp.float32(1e-6),
                               jnp.zeros(n, jnp.float32), 400)
    tA, tf = convert.band_matrix(jA), convert.bt_factor(jf)

    def port():
        return tbt.bt_pcg(tA, None, torch.as_tensor(invd), tf,
                          torch.as_tensor(rhs), 1e-6, torch.zeros(n), 400)

    return port, (np.asarray(jx), float(jrel), int(jit)), "bt"


def _band_pcg():
    """``band_pcg`` with the band V-cycle of the JAX package's hierarchy
    of a 2-D Laplacian (carried across by convert.py)."""
    A = _laplacian(40)
    n = A.shape[0]
    jamg, _ = jband.setup_band_amg(A)
    rhs = (A @ np.random.default_rng(3).normal(size=n)).astype(np.float32)
    jx, jrel, jit = jband.band_pcg(jamg, jnp.asarray(rhs),
                                   jnp.float32(1e-6),
                                   jnp.zeros(n, jnp.float32), 400)
    tamg = convert.band_amg(jamg)

    def port():
        return tband.band_pcg(tamg, torch.as_tensor(rhs), 1e-6,
                              torch.zeros(n), 400)

    return port, (np.asarray(jx), float(jrel), int(jit)), "band"


def _element_blocks(m: int, shift):
    """A 2-D grid's linear triangles as one element block: the stiffness
    plus ``shift`` times the consistent mass (complex for the AC pair),
    every 17th node fixed."""
    ii = np.arange(m * m).reshape(m, m)
    a, b = ii[:-1, :-1].ravel(), ii[:-1, 1:].ravel()
    c, d = ii[1:, :-1].ravel(), ii[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])
    K = np.array([[1.0, -1.0, 0.0], [-1.0, 2.0, -1.0], [0.0, -1.0, 1.0]])
    M = (np.ones((3, 3)) + np.eye(3)) / 24.0
    mat = np.broadcast_to(K + shift * M, (len(tris), 3, 3)).copy()
    fixed = np.zeros(m * m, bool)
    fixed[::17] = True
    return tris, mat, fixed


def _while_pcg():
    """``_while_pcg`` through the element-block Jacobi PCG."""
    tris, mat, fixed = _element_blocks(40, 0.1)
    n = fixed.size
    blocks = [tsolver.ElementBlock(idx=tris, sign=np.ones(tris.shape),
                                   mat=mat)]
    A = tsolver.blocks_to_csr(blocks, n)
    diag = np.where(fixed, 1.0, A.diagonal()).astype(np.float32)
    b = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    jx, jrel, jit = jsolver._pcg_impl(
        jsolver._to_device_blocks(blocks, jnp.float32), jnp.asarray(b),
        jnp.asarray(diag), jnp.asarray(fixed),
        jnp.asarray(1e-5, jnp.float32), jnp.zeros(n, jnp.float32), 4000)
    tb = tsolver._to_device_blocks(blocks, torch.float32, "cpu")

    def port():
        return tsolver._pcg_impl(tb, torch.as_tensor(b),
                                 torch.as_tensor(diag),
                                 torch.as_tensor(fixed), 1e-5,
                                 torch.zeros(n), 4000)

    return port, (np.asarray(jx), float(jrel), int(jit)), "jacobi"


def _while_csym():
    """``_while_csym`` through the complex-symmetric Jacobi CG on
    (re, im) pairs, from x0 = 0 (its x is (xr, xi))."""
    tris, mat, fixed = _element_blocks(30, 0.5j)
    n = fixed.size
    rng = np.random.default_rng(5)
    rs = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    rs[fixed] = 0.0
    diag = np.zeros(n, complex)
    np.add.at(diag, tris.ravel(), np.einsum("ekk->ek", mat).ravel())
    diag[fixed] = 1.0
    sign = np.ones(tris.shape)

    def f32(a):
        return np.ascontiguousarray(a, np.float32)

    jx = jsolver._pcg_csym_pairs(
        ((jnp.asarray(tris), jnp.asarray(f32(sign)),
          jnp.asarray(f32(mat.real)), jnp.asarray(f32(mat.imag))),),
        jnp.asarray(f32(rs.real)), jnp.asarray(f32(rs.imag)),
        jnp.asarray(f32(diag.real)), jnp.asarray(f32(diag.imag)),
        jnp.asarray(fixed), jnp.asarray(1e-5, jnp.float32), 20000)
    tblocks = ((torch.as_tensor(tris.astype(np.int64)),
                torch.as_tensor(f32(sign)), torch.as_tensor(f32(mat.real)),
                torch.as_tensor(f32(mat.imag))),)

    def port():
        xr, xi, rel, it = tsolver._pcg_csym_pairs(
            tblocks, torch.as_tensor(f32(rs.real)),
            torch.as_tensor(f32(rs.imag)), torch.as_tensor(f32(diag.real)),
            torch.as_tensor(f32(diag.imag)), torch.as_tensor(fixed), 1e-5,
            20000)
        return torch.stack([xr, xi]), rel, it

    want = (np.stack([np.asarray(jx[0]), np.asarray(jx[1])]),
            float(jx[2]), int(jx[3]))
    return port, want, "csym-pairs"


@pytest.mark.parametrize("case", [_bt_pcg, _band_pcg, _while_pcg,
                                  _while_csym],
                         ids=["bt_pcg", "band_pcg", "while_pcg",
                              "while_csym"])
def test_engines_bitwise_under_the_window(case, monkeypatch):
    port, (jx, jrel, jit), engine = case()
    width = tloop.IN_FLIGHT
    monkeypatch.setattr(tloop, "IN_FLIGHT", 0)
    x0, rel0, it0 = port()
    monkeypatch.setattr(tloop, "IN_FLIGHT", width)
    loops0, masked0 = tloop.LOOPS[engine], tloop.MASKED[engine]
    x, rel, it = port()
    assert torch.equal(x, x0) and rel == rel0 and it == it0
    loops = tloop.LOOPS[engine] - loops0
    assert loops >= 1
    assert 0 <= tloop.MASKED[engine] - masked0 <= tloop.IN_FLIGHT * loops
    # held to the JAX while_loop as the engines' own tests hold them
    assert it > 5 and abs(it - jit) <= max(2, jit // 10), (it, jit)
    assert rel <= 2e-6 if engine in ("bt", "band") else rel <= 1e-5
    x = x.numpy()
    assert np.abs(x - jx).max() <= 1e-5 * np.abs(jx).max()
