"""The whole planar magnetostatic solve with the device Newton loop on,
the JAX package's default configuration: host iteration 0, the loop
(``newton.run``, or ``run_scatter`` steps), then the f64 host endgame.
The port against the JAX package on the same problems (band engine
forced on the CPU in both, as in test_torch_magnetostatics.py, but
without ``XFEMM_TPU_NO_DEVICE_NEWTON``), and against the reference
fsolver's golden Temp.ans.

Each case asserts that the loop engaged in both packages or in neither,
A within 1e-5 of max|A|, the contract residual, and CG iterations at
most 30% plus 10 above the JAX package's. The number of device steps is
not held equal: past the loop's f32 displacement floor each step's
outcome is rounding noise, and the JAX package's own loop changes its
step and CG counts when its start vector moves by 1e-7
(tests/test_torch_newton.py); at 10-30 CG iterations per solve one such
step moves the count by one or two, hence the 10. Nor is the count held
from below: on the triu V-cycle, whose bf16 bands make the
preconditioner non-symmetric (ROADMAP C), the count follows the fp32
summation order (391 here against the JAX package's 579, and 570 with
four torch threads), and fewer iterations to the same contract and the
same A are no fault.

The block-tridiagonal smoother regime (a partitioned ordering whose
in-part factor smooths the V-cycle) is not reached by a problem small
enough for the CPU: the JAX planner reserves a fixed 3.5e9 bytes for the
coarse levels there (its plan_band_hierarchy), so the plan must exceed
~4.3e9 bytes while the fine factor must not fit in 0.78 of it -- a
problem of roughly a million nodes. ``chip_smoke.py`` drives that regime
at 4.47M nodes on the card."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.io import ansfile
from xfemm_tpu.mesh import mesher as jmesher
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu.models import magnetostatics as jmag
from xfemm_tpu.ops import band as jband
from xfemm_tpu.ops import newton as jnewton
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files as tread_mesh
from xfemm_tpu_torch.models import benchprob as tbench
from xfemm_tpu_torch.models import magnetostatics as tmag
from xfemm_tpu_torch.ops import band as tband
from xfemm_tpu_torch.ops import newton as tnewton
from xfemm_tpu_torch.ops import solver as tsolver

torch.set_num_threads(1)

#: case: (device memory, triu, RCB parts, environment). Temp.fem in the
#: bt-alone regime; the V-cycle regimes of test_vcycle_regimes_match_jax
#: (at 2e8 and 1.5e8 the band and its bf16 copy exceed the loop's 0.45
#: share of device memory, so neither package engages the loop; triu
#: engages it); a partitioned ordering with the fine level's COO sidecar
#: (pick_parts = 2, a test setting); the scatter mode (every band above
#: 0 bytes); a CG budget of 3 that cuts every dispatch
CASES = {
    "temp": (16e9, False, 0, {}),
    "vcycle-2e8": (2e8, False, 0, {}),
    "vcycle-1.5e8": (1.5e8, False, 0, {}),
    "vcycle-triu": (1.5e8, True, 0, {}),
    "sidecar": (1.5e8, False, 2, {}),
    "scatter": (16e9, False, 0, {"XFEMM_TPU_DN_SCATTER_BYTES": "0"}),
    "budget": (16e9, False, 0, {"XFEMM_TPU_DN_CG_BUDGET": "3"}),
}


@pytest.fixture
def fused_engine(monkeypatch):
    """Both packages on the band engine with the device loop on; every
    loop dispatch and host linear solve recorded, per package."""
    monkeypatch.delenv("XFEMM_TPU_NO_DEVICE_NEWTON", raising=False)
    monkeypatch.setattr(jsolver, "device_f64_ok", lambda: False)
    monkeypatch.setattr(jsolver, "band_platform_ok", lambda: True)
    events = {"j": [], "t": []}
    for key, mods in (("j", (jnewton, jsolver)), ("t", (tnewton, tsolver))):
        for mod, name in ((mods[0], "run"), (mods[0], "run_scatter"),
                          (mods[1], "solve")):
            real = getattr(mod, name)

            def rec(*a, _real=real, _k=key, _n=name, **kw):
                out = _real(*a, **kw)
                # a loop's stats end its outputs; steps at index 3
                steps = 0 if _n == "solve" else int(np.asarray(out[-1])[3])
                events[_k].append((_n, steps))
                return out

            monkeypatch.setattr(mod, name, rec)
    caches = (jsolver._BAND_CACHE, tsolver._BAND_CACHE, jmag._PACK_CACHE,
              tmag._PACK_CACHE)
    for cache in caches:
        cache.clear()
    yield monkeypatch, events
    for cache in caches:
        cache.clear()


def _loops(ev):
    return [e for e in ev if e[0] != "solve"]


def _compare(jsol, tsol, events):
    scale = np.abs(jsol.A).max()
    assert np.abs(tsol.A - jsol.A).max() <= 1e-5 * scale
    assert tsol.residual <= 1e-8 and np.isfinite(tsol.A).all()
    assert tsol.iterations <= 1.3 * jsol.iterations + 10
    jl, tl = _loops(events["j"]), _loops(events["t"])
    assert bool(jl) == bool(tl)
    if tl:
        assert sum(s for _n, s in jl) >= 1 and sum(s for _n, s in tl) >= 1
        assert tsol.newton_iterations > sum(s for _n, s in tl)
    return jl, tl


def _check_golden(fixtures, mesh, tsol):
    g = ansfile.read_ans(str(fixtures / "Temp.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-12
    Ag = np.real(g.values)
    assert np.abs(tsol.A[idx] - Ag).max() / np.abs(Ag).max() < 1e-05


@pytest.mark.parametrize("case", list(CASES))
def test_fused_solve_matches_jax(fixtures, fused_engine, case):
    mp, events = fused_engine
    hbm, triu, parts, env = CASES[case]
    mp.setattr(jsolver, "device_hbm_bytes", lambda: hbm)
    if triu:
        mp.setattr(jband, "SYM_MIN_BYTES", 0)
        mp.setattr(tband, "SYM_MIN_BYTES", 0)
    if parts:
        mp.setattr(jband, "pick_parts", lambda n, **kw: parts)
        mp.setattr(tband, "pick_parts", lambda n, **kw: parts)
    for k, v in env.items():
        mp.setenv(k, v)
    jsol = jmag.solve(jfemfile.load(str(fixtures / "Temp.fem")),
                      jread_mesh(str(fixtures / "Temp")))
    mesh = tread_mesh(str(fixtures / "Temp"))
    tsol = tmag.solve(tfemfile.load(str(fixtures / "Temp.fem")), mesh,
                      device="cpu", hbm_bytes=hbm)
    jl, tl = _compare(jsol, tsol, events)
    _check_golden(fixtures, mesh, tsol)
    engaged = case not in ("vcycle-2e8", "vcycle-1.5e8")
    assert bool(tl) == engaged
    entry = next(iter(tsolver._BAND_CACHE.values()))
    lv0 = entry["band_amg"].levels[0]
    assert (lv0.dvec is not None) == triu
    assert (lv0.oob is not None) == bool(parts)
    if case == "scatter":
        assert {n for n, _s in jl} == {n for n, _s in tl} == {"run_scatter"}
    else:
        assert {n for n, _s in tl} <= {"run"}
    if case == "budget":
        # the budget cut every dispatch: each package chained several
        assert len(jl) > 1 and len(tl) > 1
    if engaged:
        # the loop leaves the fine level without its bf16 copy
        assert lv0.Abf is None


def test_repeat_solve_enters_loop_at_iteration_0(fused_engine):
    """benchprob.build(10_000) cold, then again: the cold solve runs host
    iteration 0 before the loop, the repeat solve reuses the cached
    it-0 solution and starts with the loop, in both packages."""
    mp, events = fused_engine
    mp.setattr(jsolver, "device_hbm_bytes", lambda: 16e9)
    mesh = jmesher.mesh_problem(jbench.build(10_000))
    jp, tp = jbench.build(10_000), tbench.build(10_000)
    sols = []
    for label in ("cold", "warm"):
        events["j"].clear()
        events["t"].clear()
        jsol = jmag.solve(jp, mesh)
        tsol = tmag.solve(tp, mesh, device="cpu", hbm_bytes=16e9)
        _compare(jsol, tsol, events)
        first = "solve" if label == "cold" else "run"
        assert events["j"][0][0] == events["t"][0][0] == first
        assert _loops(events["t"])
        sols.append(tsol)
    scale = np.abs(sols[0].A).max()
    assert np.abs(sols[1].A - sols[0].A).max() <= 1e-5 * scale


def test_no_device_newton_calls_no_loop(fixtures, fused_engine):
    """``XFEMM_TPU_NO_DEVICE_NEWTON=1`` keeps every Newton iteration on
    the host chain: no loop function of the port is called."""
    mp, events = fused_engine
    mp.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")

    def refuse(*a, **kw):
        raise AssertionError("device Newton loop called")

    for name in ("setup", "run", "run_scatter"):
        mp.setattr(tnewton, name, refuse)
    mesh = tread_mesh(str(fixtures / "Temp"))
    tsol = tmag.solve(tfemfile.load(str(fixtures / "Temp.fem")), mesh,
                      device="cpu", hbm_bytes=16e9)
    assert tsol.residual <= 1e-8
    _check_golden(fixtures, mesh, tsol)
    assert _loops(events["t"]) == []
    extra = next(iter(tmag._PACK_CACHE.values()))[2]
    assert "dn" not in extra
