"""The coarse-level block-tridiagonal smoothers of the port's band-AMG
hierarchy (``band.setup_band_amg(coarse_bt_smooth=True)``, ``BandLevel.bts``
and its use in ``band_vcycle``) against the JAX package's, on the CPU.

A split coarse level that is not stored as its upper triangle takes a
bf16 factor of its kept band when the factor fits 1.6 GB and the
hierarchy's budget. On the 120 x 120 grid in a 4-part RCB ordering, a
budget of 1.5 x the fine band truncates level 1 to a split band and
leaves room for its factor: the case the switch exists for.

Tolerances: which levels take a factor, and the hierarchy's bands, are
equal; the two packages' bf16 factors are built by two f32 libraries and
rounded to bf16, and the port's sweeps (as its kernels) round the
carried vector to the factor's bf16 where the JAX scan multiplies it in
f32: their applications agree to 2^-7 of max|z|, and one V-cycle with the
SAME factors (the JAX package's carried by ``convert``) to bf16's unit
roundoff 2^-8 (l2) and 2^-7 (max) of z; without the coarse smoothers the
V-cycle moves by far more than that. A band PCG solve on each package's
own hierarchy meets 2e-6 with iteration counts within 10%."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_band_amg import _partitioned, _same_levels, _xla_band  # noqa: F401
from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import blocktri as jbt
from xfemm_tpu_torch import convert
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import blocktri as tbt
from xfemm_tpu_torch.ops import solver as tsolver

torch.set_num_threads(1)


def _case(switch: bool):
    """The 120-grid hierarchy at 1.5 x its fine band's bytes, built by
    both packages with ``coarse_bt_smooth=switch``."""
    Ap, cp, key = _partitioned(120, 120, 4)
    n = Ap.shape[0]
    rows = np.repeat(np.arange(n), np.diff(Ap.indptr))
    R, cut, _s = jband.plan_level(np.abs(rows - Ap.indices), n, False)
    kw = dict(coords=cp, band_key=key, fine_abf=False,
              budget_bytes=1.5 * jband._band_est(n, cut, R, False),
              coarse_bt_smooth=switch)
    jamg, _ = jband.setup_band_amg(Ap, **kw)
    tamg, _ = tband.setup_band_amg(Ap, **kw)
    return Ap, jamg, tamg


def test_levels_that_take_a_factor_match_jax():
    """With the switch, level 1 (split by the budget, not triu) takes a
    bf16 factor in both packages and no other level does; the bands are
    equal. Without it no level takes one."""
    _Ap, jamg, tamg = _case(True)
    jhas = [lv.bts is not None for lv in jamg.levels]
    thas = [lv.bts is not None for lv in tamg.levels]
    assert thas == jhas and thas[0] is False and any(thas)
    _same_levels(tamg, jamg)
    for tl, jl in zip(tamg.levels, jamg.levels):
        if tl.bts is None:
            continue
        assert tl.oob is not None and tl.dvec is None
        assert tl.bts.Sinv.dtype == tl.bts.G.dtype == torch.bfloat16
        assert tuple(tl.bts.Sinv.shape) == tuple(jl.bts.Sinv.shape)
        assert tuple(tl.bts.G.shape) == tuple(jl.bts.G.shape)
        r = np.random.default_rng(1).standard_normal(
            tl.A.ncols).astype(np.float32)
        zj = np.asarray(jbt.bt_apply(jl.bts, jnp.asarray(r)))
        zt = tbt.bt_apply(tl.bts, torch.as_tensor(r)).numpy()
        assert np.abs(zt - zj).max() <= 2.0 ** -7 * np.abs(zj).max()
    _Ap, _jamg, off = _case(False)
    assert all(lv.bts is None for lv in off.levels)


def test_vcycle_with_coarse_smoothers_matches_jax():
    """One V-cycle through the coarse factor (the JAX hierarchy carried
    across, its bf16 factors with it) against the JAX package's; and the
    coarse smoother is really applied (the V-cycle without it differs)."""
    Ap, jamg, _tamg = _case(True)
    tamg = convert.band_amg(jamg)
    assert [lv.bts is not None for lv in tamg.levels] == \
        [lv.bts is not None for lv in jamg.levels]
    r = np.random.default_rng(3).standard_normal(Ap.shape[0]) \
        .astype(np.float32)
    zj = np.asarray(jband.band_vcycle(jamg, jnp.asarray(r)))
    zt = tband.band_vcycle(tamg, torch.as_tensor(r)).numpy()
    assert np.linalg.norm(zt - zj) <= 2.0 ** -8 * np.linalg.norm(zj)
    assert np.abs(zt - zj).max() <= 2.0 ** -7 * np.abs(zj).max()
    for lv in tamg.levels:
        lv.bts = None
    z0 = tband.band_vcycle(tamg, torch.as_tensor(r)).numpy()
    assert np.linalg.norm(z0 - zj) > 2.0 ** -4 * np.linalg.norm(zj)


def test_pcg_with_coarse_smoothers_matches_jax():
    """A band PCG solve on each package's own hierarchy with the
    switch: both to 2e-6, iteration counts within 10%."""
    Ap, jamg, tamg = _case(True)
    n = Ap.shape[0]
    rng = np.random.default_rng(4)
    b = (Ap @ rng.standard_normal(n)).astype(np.float32)
    b /= np.abs(b).max()
    _xj, relj, itj = jband.band_pcg(
        jamg, jnp.asarray(b), jnp.asarray(1e-6, jnp.float32),
        jnp.zeros(n, jnp.float32), 400, stall_window=48)
    xt, relt, itt = tband.band_pcg(tamg, torch.as_tensor(b), 1e-6,
                                   torch.zeros(n), 400, stall_window=48)
    assert relt <= 2e-6 and float(relj) <= 2e-6
    assert abs(itt - int(itj)) <= max(1, int(itj) // 10), (itt, int(itj))


@pytest.mark.parametrize("env", [None, "1"])
def test_solver_reads_the_switch(monkeypatch, env):
    """``solver`` passes ``XFEMM_TPU_COARSE_BT_SMOOTH`` to the hierarchy
    build, as the JAX package's solver does; off when unset."""
    if env is None:
        monkeypatch.delenv("XFEMM_TPU_COARSE_BT_SMOOTH", raising=False)
    else:
        monkeypatch.setenv("XFEMM_TPU_COARSE_BT_SMOOTH", env)
    seen = []

    def spy(*a, **kw):
        seen.append(kw["coarse_bt_smooth"])
        raise _Stop

    monkeypatch.setattr(tband, "setup_band_amg", spy)
    Ap, cp, _key = _partitioned(120, 120, 4)
    sess = tsolver.Session()
    sess.perm = (np.arange(Ap.shape[0]), np.arange(Ap.shape[0]))
    sess.plan = dict(sym=False, fine_dtype=None, bt_budget=0.0,
                     bt_transient=0.0, hier_budget=None, fine_full=False,
                     bt_smooth=False)
    with pytest.raises(_Stop):
        tsolver._setup_hierarchy(sess, Ap, cp, "cpu", fine_only=False)
    assert seen == [env is not None]


class _Stop(Exception):
    pass
