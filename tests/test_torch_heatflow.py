"""Heat flow of the PyTorch port (models/heatflow.py and the K(T) loop of
ops/newton.py) against the JAX package and the reference's golden
solution, on the CPU.

The port runs with ``device="cpu"`` and an explicit ``hbm_bytes`` (16 GB,
the size the JAX package plans against on the CPU). The JAX package is
forced onto its f32 band engine and its fused heat loop as its own tests
force it (tests/test_heat_electro.py), and both packages take the band
engine from the same size (``ROW_TILE_MIN`` = 64 in both). Tolerances:
the K(T) lookup 1e-6 relative; the loop's device data equal (integer
maps) or within 1e-6 of their largest (f32 values); one loop step from
the same state on the same hierarchy 1e-5 of max|V|; whole solves 1e-6
of max|T| against the JAX package and against HeatTemp0.anh.golden.
"""

import collections
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp
from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.io import ansfile
from xfemm_tpu.mesh import mesher as jmesher
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu.models import heatflow as jheat
from xfemm_tpu.ops import newton as jnewton
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu_torch import convert
from xfemm_tpu_torch import models as tmodels
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files as tread_mesh
from xfemm_tpu_torch.models import benchprob as tbench
from xfemm_tpu_torch.models import heatflow as theat
from xfemm_tpu_torch.ops import blocktri as tbt
from xfemm_tpu_torch.ops import newton as tnewton
from xfemm_tpu_torch.ops import solver as tsolver

FIXTURES = Path(__file__).parent / "fixtures"
HBM = 16e9
ON_CPU = dict(device="cpu", hbm_bytes=HBM)

torch.set_num_threads(1)


@pytest.fixture
def port_band(monkeypatch):
    """The port on the band engine from 4 x 64 unknowns, the device loop
    on, fresh caches; its CPU path fails on any CUDA call."""
    monkeypatch.delenv("XFEMM_TPU_NO_DEVICE_NEWTON", raising=False)
    monkeypatch.setattr(tsolver, "ROW_TILE_MIN", 64)
    for name in ("_BAND_CACHE", "_PATTERN_CACHE"):
        monkeypatch.setattr(tsolver, name, collections.OrderedDict())
    monkeypatch.setattr(theat, "_HEAT_SETUP_CACHE", collections.OrderedDict())

    def no_cuda(*a, **k):
        raise AssertionError("a CPU run touched CUDA")

    for name in ("is_available", "mem_get_info", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    return monkeypatch


@pytest.fixture
def band_engines(port_band):
    """Both packages on the band engine from 4 x 64 unknowns (the JAX
    package's f32 engine forced as its own tests force it), the device
    loop on, fresh caches."""
    mp = port_band
    mp.setattr(jsolver, "device_f64_ok", lambda: False)
    mp.setattr(jsolver, "band_platform_ok", lambda: True)
    mp.setattr(jsolver, "device_hbm_bytes", lambda: HBM)
    mp.setattr(jsolver, "ROW_TILE_MIN", 64)
    for name in ("_BAND_CACHE", "_PATTERN_CACHE"):
        mp.setattr(jsolver, name, collections.OrderedDict())
    mp.setattr(jheat, "_HEAT_SETUP_CACHE", collections.OrderedDict())
    return mp


def heat_temp0(fixtures, pkg):
    if pkg == "j":
        return (jfemfile.load(str(fixtures / "HeatTemp0.feh")),
                jread_mesh(str(fixtures / "HeatTemp0")))
    return (tfemfile.load(str(fixtures / "HeatTemp0.feh")),
            tread_mesh(str(fixtures / "HeatTemp0")))


def golden_distance(fixtures, mesh, T):
    g = ansfile.read_ans(str(fixtures / "HeatTemp0.anh.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-12
    Tg = np.real(g.values)
    return float(np.abs(T[idx] - Tg).max() / np.abs(Tg).max())


def count_calls(mp, mod, name):
    calls = []
    real = getattr(mod, name)

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls.append(out)
        return out

    mp.setattr(mod, name, counted)
    return calls


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------- #
# the K(T) lookup                                                         #
# ---------------------------------------------------------------------- #

def _random_heat_elements(seed: int = 0):
    """S elements over n DOFs with two materials: an 18-knot curve with a
    repeated knot (a zero-width interval) and a 3-knot curve padded to
    18 knots as ``setup_heat`` pads it; temperatures below, above, inside
    and exactly on the knots."""
    rng = np.random.default_rng(seed)
    S, n, P = 120, 200, 18
    T1 = np.sort(rng.uniform(200.0, 2000.0, P))
    T1[7] = T1[6]
    K1 = rng.uniform(0.01, 0.2, P)
    T2 = [250.0, 600.0, 900.0]
    K2 = [1.0, 3.0, 2.0]
    while len(T2) < P:
        T2.append(T2[-1] + 1e6)
        K2.append(K2[-1])
    two = np.arange(S) % 2 == 1
    Tc = np.where(two[:, None], np.asarray(T2)[None], T1[None])
    Kc = np.where(two[:, None], np.asarray(K2)[None], K1[None])
    idxT = rng.integers(0, n, (S, 3))
    sgnT = np.ones((S, 3))
    V = rng.uniform(100.0, 2200.0, n)
    V[idxT[:10, 0]] = 50.0                           # below every knot
    V[idxT[10:20, 1]] = 5000.0                       # above
    V[idxT[20:40, 2]] = Tc[20:40, 5]                 # exactly on a knot
    V[idxT[40:44, 0]] = T1[6]                        # on the repeated knot
    A = rng.standard_normal((S, 3, 3))
    mat_k = A + A.transpose(0, 2, 1)
    mat_0 = np.eye(3)[None] * rng.uniform(0.0, 1.0, (S, 1, 1))
    return dict(idxT=idxT, sgnT=sgnT, Tc=Tc, Kc=Kc, mat_k=mat_k,
                mat_0=mat_0), V


def test_heat_elements_match_jax_interp():
    """``_heat_elements`` (a batched ``searchsorted`` lookup) against the
    JAX package's ``vmap(jnp.interp)`` on the same f32 inputs: the
    element conductivity and the block matrices within 1e-6 relative,
    and the lookup itself against ``jnp.interp`` element by element."""
    f, V = _random_heat_elements()
    f32 = np.float32
    jf = {k: jnp.asarray(v.astype(np.int32 if k == "idxT" else f32))
          for k, v in f.items()}
    tf = {k: torch.as_tensor(v.astype(np.int64 if k == "idxT" else f32))
          for k, v in f.items()}
    jdh = jnewton.DeviceHeat(**{k: None for k in jnewton.DeviceHeat._fields}
                             | jf)
    tdh = tnewton.DeviceHeat(**{k: None for k in tnewton.DeviceHeat._fields}
                             | tf)
    Vf = V.astype(f32)
    jk, jm = jnewton._heat_elements(jdh, jnp.asarray(Vf))
    tk, tm = tnewton._heat_elements(tdh, torch.as_tensor(Vf))
    assert _rel(tk.numpy(), jk) <= 1e-6
    assert _rel(tm.numpy(), jm) <= 1e-6
    Tl = Vf[f["idxT"]]
    ref = np.asarray(jax.vmap(jnp.interp)(jnp.asarray(Tl), jf["Tc"],
                                          jf["Kc"]))
    got = tnewton.interp_rows(torch.as_tensor(Tl), tf["Tc"], tf["Kc"])
    assert _rel(got.numpy(), ref) <= 1e-6
    # every branch of the rule was taken
    Tc = f["Tc"].astype(f32)
    assert (Tl < Tc[:, :1]).any() and (Tl > Tc[:, -1:]).any()
    assert np.isin(Tl[20:40, 2], Tc[20:40]).all()


# ---------------------------------------------------------------------- #
# the loop's device data and one step                                     #
# ---------------------------------------------------------------------- #

class _Stop(Exception):
    pass


def _first_run_heat(mp, fixtures):
    """Drive both packages' HeatTemp0 solves up to their first
    ``run_heat`` call; returns ``{"j": (args, kwargs), "t": (...)}``."""
    seen = {}
    real = {"j": jnewton.run_heat, "t": tnewton.run_heat}
    for key, mod in (("j", jnewton), ("t", tnewton)):
        def stop(*a, _k=key, **kw):
            seen[_k] = (a, kw)
            raise _Stop
        mp.setattr(mod, "run_heat", stop)
    with pytest.raises(_Stop):
        jheat.solve(*heat_temp0(fixtures, "j"))
    with pytest.raises(_Stop):
        theat.solve(*heat_temp0(fixtures, "t"), **ON_CPU)
    mp.setattr(jnewton, "run_heat", real["j"])
    mp.setattr(tnewton, "run_heat", real["t"])
    return seen


def test_setup_heat_matches_jax(fixtures, band_engines):
    """The DeviceHeat ``setup_heat`` builds on HeatTemp0 (18-knot K(T)
    air, convection walls): every field the port carries equals the JAX
    package's carried across by ``convert.device_heat`` (integer maps
    exactly, f32 values to 1e-6 of their largest); the maps are those
    ``_band_refresh_maps`` returns."""
    seen = _first_run_heat(band_engines, fixtures)
    jdh, tdh = seen["j"][0][0], seen["t"][0][0]
    cdh = convert.device_heat(jdh)
    checked = 0
    for name in tnewton.DeviceHeat._fields:
        a, b = getattr(tdh, name), getattr(cdh, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        a, b = a.numpy(), b.numpy()
        if a.dtype.kind in "iu":
            assert np.array_equal(a, b), name
        else:
            assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1e-30), \
                name
        checked += 1
    assert checked >= 25
    assert tdh.Tc.shape == (tdh.idxT.shape[0], 18)
    su = next(iter(theat._HEAT_SETUP_CACHE.values()))[1]
    maps = tnewton._band_refresh_maps(su.sess, su.fixed_mask, "cpu")
    assert np.array_equal(maps["fields"]["delta_rows"].numpy(),
                          tdh.delta_rows.numpy())


def _bt(jbt):
    if jbt is None:
        return None
    f = convert.bt_factor(jbt)
    return tbt.BTSmoother(*f) if type(jbt).__name__ == "BTSmoother" else f


def test_one_run_heat_step_matches_jax(fixtures, band_engines):
    """One step of the real loop (its preconditioned CG included) on the
    JAX package's hierarchy and device data at its first ``run_heat``
    call, carried across (``convert.band_amg``,
    ``convert.device_heat``), from 0.9 x the JAX package's it-0 iterate
    (the it-0 iterate itself leaves a residual at the f32 rounding
    floor, ~1e-4 of the right-hand side, where the two packages' sums
    differ by tens of percent): V within 1e-5 of max|V|, the same step
    and CG counts, the residual within 1e-4."""
    seen = _first_run_heat(band_engines, fixtures)
    (jdh, jrest, jdense, jV, jstate), jkw = seen["j"]
    jamg = jnewton.rebuild_band_amg(jrest, jdense, None, jrest.levels[0].dvec)
    tamg = convert.band_amg(jamg)
    tdh = convert.device_heat(jdh)
    jV = 0.9 * jV
    V = torch.as_tensor(np.array(jV))
    state = torch.as_tensor(np.array(jstate))
    kw = dict(tol_floor=jkw["tol_floor"], target_res=jkw["target_res"],
              cg_budget=jkw["cg_budget"], max_steps=1)
    tout = tnewton.run_heat(tdh, tamg, V, state, bt=_bt(jkw["bt"]), **kw)
    jout = jnewton.run_heat(jdh, jrest, jdense, jV, jstate, bt=jkw["bt"],
                            **kw)
    jVo = np.asarray(jout[0])
    assert np.abs(tout[0].numpy() - jVo).max() <= 1e-5 * np.abs(jVo).max()
    ts, js = tout[-1].numpy(), np.asarray(jout[-1])
    assert ts[1] == js[1] == 1 and ts[2] == js[2] and ts[2] >= 1
    assert abs(ts[0] - js[0]) <= 1e-4 * abs(js[0])
    # the step moved the iterate (the comparison is not vacuous)
    assert _rel(jVo, np.asarray(jV)) > 1e-6


# ---------------------------------------------------------------------- #
# whole solves                                                           #
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("chain", ["loop", "host"])
def test_heat_temp0_matches_jax_and_golden(fixtures, band_engines, chain):
    """HeatTemp0 (planar, convection walls, an 18-point K(T) curve) on
    the K(T) loop (``run_heat`` engaged in both packages) and on the
    host chain (``XFEMM_TPU_NO_DEVICE_NEWTON=1`` in both, no loop call):
    the contract residual, and T within 1e-6 of max|T| of the JAX
    package's and of the golden .anh; a second solve of the cached
    problem takes the loop again and gives the same T."""
    if chain == "host":
        band_engines.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")
    jcalls = count_calls(band_engines, jnewton, "run_heat")
    tcalls = count_calls(band_engines, tnewton, "run_heat")
    p, mesh = heat_temp0(fixtures, "t")
    sol = theat.solve(p, mesh, **ON_CPU)
    jsol = jheat.solve(*heat_temp0(fixtures, "j"))
    assert sol.residual <= p.Precision and np.isfinite(sol.T).all()
    scale = np.abs(jsol.T).max()
    assert np.abs(sol.T - jsol.T).max() <= 1e-6 * scale
    assert golden_distance(fixtures, mesh, sol.T) <= 1e-6
    assert np.array_equal(sol.node_Q, jsol.node_Q)
    if chain == "loop":
        assert jcalls and tcalls
        assert sum(int(c[-1][1]) for c in tcalls) >= 1
    else:
        assert not jcalls and not tcalls
    n = len(tcalls)
    again = theat.solve(p, mesh, **ON_CPU)
    assert (len(tcalls) > n) == (chain == "loop")
    assert np.abs(again.T - sol.T).max() <= 1e-6 * scale


def test_radiation_boundary_host_chain(fixtures, band_engines):
    """HeatTemp0 with its convection wall turned to radiation
    (BdryFormat 3, emissivity 0.9 toward its 300 K), re-linearized every
    pass: the loop
    declines it in both packages (``setup_heat`` does not re-linearize a
    boundary), and the host chain meets the residual and the JAX
    package's T within 1e-6 of max|T|."""
    jcalls = count_calls(band_engines, jnewton, "run_heat")
    tcalls = count_calls(band_engines, tnewton, "run_heat")
    sols = []
    for key, solve, kw in (("t", theat.solve, ON_CPU),
                           ("j", jheat.solve, {})):
        p, mesh = heat_temp0(fixtures, key)
        bp = p.lineproplist[0]
        bp.BdryFormat, bp.beta = 3, 0.9
        sols.append(solve(p, mesh, **kw))
    assert not jcalls and not tcalls
    sol, jsol = sols
    assert sol.residual <= p.Precision and np.isfinite(sol.T).all()
    assert np.abs(sol.T - jsol.T).max() <= 1e-6 * np.abs(jsol.T).max()
    # radiation moved the answer (~0.27 K) far beyond the tolerance
    plain = jheat.solve(*heat_temp0(fixtures, "j"))
    assert np.abs(plain.T - jsol.T).max() > 1e-4 * np.abs(jsol.T).max()


def _transient_problem(P, C, nonlinear: bool, max_area: float):
    """tests/test_chaining.py's lumped cooling block (a 1 m square at
    400 K toward a 300 K wall, dT 10 s), with an optional K(T) curve;
    ``P`` / ``C`` are a package's geometry.problem and constants."""
    p = P.Problem(filetype=C.FileType.HEATFLOW)
    p.LengthUnits = C.LengthUnit.METERS
    p.Precision = 1e-8
    p.Depth = 1.0
    p.dT = 10.0
    m = P.HeatMaterial(name="m", Kx=10.0, Ky=10.0, Kt=1.0)
    if nonlinear:
        m.Tdata = [250.0, 320.0, 360.0, 420.0]
        m.Kdata = [14.0, 10.0, 7.0, 5.0]
    p.blockproplist = [m]
    p.lineproplist = [P.BoundaryProp(name="wall", BdryFormat=0, Tset=300.0)]
    n = [p.add_node(0, 0), p.add_node(1, 0), p.add_node(1, 1),
         p.add_node(0, 1)]
    for a, b in zip(n, n[1:] + n[:1]):
        p.linelist.append(P.Segment(n0=a, n1=b, BoundaryMarker=0))
    p.labellist = [P.BlockLabel(x=0.5, y=0.5, BlockType=0,
                                MaxArea=max_area)]
    return p


def _transient_pair(nonlinear: bool, max_area: float):
    """The problem in both packages and the JAX package's mesh of it."""
    import xfemm_tpu.constants as jc
    import xfemm_tpu.geometry.problem as jprob
    import xfemm_tpu_torch.constants as tc
    import xfemm_tpu_torch.geometry.problem as tprob
    jp = _transient_problem(jprob, jc, nonlinear, max_area)
    tp = _transient_problem(tprob, tc, nonlinear, max_area)
    return jp, tp, jmesher.mesh_problem(jp)


@pytest.mark.parametrize("nonlinear", [False, True])
def test_transient_stepping_matches_jax(port_band, nonlinear):
    """Three dT steps of tests/test_chaining.py's lumped cooling (linear:
    the one-pass solve; with a K(T) curve: the port's loop from the
    second pass), each step's Tprev the last step's T, in both packages
    on the same mesh, the JAX package on its CPU default engine as in
    tests/test_chaining.py: T within 1e-6 of max|T| of the JAX
    package's at every step, cooling monotonically toward the wall."""
    jp, tp, mesh = _transient_pair(nonlinear, 0.01)
    tcalls = count_calls(port_band, tnewton, "run_heat")
    Tj = Tt = np.full(mesh.num_nodes, 400.0)
    avgs = []
    for _ in range(3):
        Tj = jheat.solve(jp, mesh, Tprev=Tj).T
        sol = theat.solve(tp, mesh, Tprev=Tt, **ON_CPU)
        Tt = sol.T
        assert sol.residual <= tp.Precision
        assert np.abs(Tt - Tj).max() <= 1e-6 * np.abs(Tj).max()
        avgs.append(Tt.mean())
    assert avgs[0] > avgs[1] > avgs[2] > 300.0 - 1e-5
    assert bool(tcalls) == nonlinear


def test_transient_loop_rebuilds_its_rhs_per_step(port_band):
    """The loop's right-hand side carries the transient term of the
    step's Tprev. The port keeps a cached DeviceHeat only for the Tprev
    it was built with (the JAX package reuses the first step's for every
    later step, ROADMAP C): after a second step the cached DeviceHeat's
    right-hand side equals (1e-6) the one a solve from empty caches
    builds for that step's Tprev, and differs from the first step's."""
    _jp, tp, mesh = _transient_pair(True, 0.01)
    built = count_calls(port_band, tnewton, "setup_heat")
    T1 = theat.solve(tp, mesh, Tprev=np.full(mesh.num_nodes, 400.0),
                     **ON_CPU).T
    theat.solve(tp, mesh, Tprev=T1, **ON_CPU)
    assert len(built) == 2 and built[1] is not None
    su = next(iter(theat._HEAT_SETUP_CACHE.values()))[1]
    cached = su.dev_heat[1]
    theat._HEAT_SETUP_CACHE.clear()
    tsolver._BAND_CACHE.clear()
    theat.solve(tp, mesh, Tprev=T1, **ON_CPU)
    fresh = built[2]
    assert np.abs(cached.rhs_pre - fresh.rhs_pre).max() <= \
        1e-6 * np.abs(fresh.rhs_pre).max()
    # the first step's differs far beyond that tolerance
    assert np.abs(built[0].rhs_pre - fresh.rhs_pre).max() > \
        1e-4 * np.abs(fresh.rhs_pre).max()


def _conductor_pair(circ_type: int):
    """HeatTemp0 in both packages with a conductor on the segment from
    (1, 0.5) to (1.5, 0.5), between the brick and the K(T) air: a fixed
    500 K (CircType 1: a Dirichlet set of nonzero value next to K(T)
    elements) or a total flux of 50 W (CircType 0: its nodes merged into
    one reduced DOF), and the JAX package's mesh of it."""
    import xfemm_tpu.geometry.problem as jprob
    import xfemm_tpu_torch.geometry.problem as tprob
    out = []
    for P, load in ((jprob, jfemfile.load), (tprob, tfemfile.load)):
        p = load(str(FIXTURES / "HeatTemp0.feh"))
        p.circproplist = [P.Conductor(name="c", V=500.0, q=50.0,
                                      CircType=circ_type)]
        seg = p.linelist[8]
        assert (p.nodelist[seg.n0].x, p.nodelist[seg.n1].x) == (1.0, 1.5)
        seg.InConductor = 0
        out.append(p)
    return out[0], out[1], jmesher.mesh_problem(out[0])


@pytest.mark.parametrize("circ_type", [1, 0])
def test_heat_conductors_match_jax(band_engines, circ_type):
    """A fixed-temperature and a total-flux conductor (module docstring of
    models/heatflow.py) on the loop in both packages: the residual, T
    within 1e-6 of max|T| of the JAX package's, the conductor's
    temperature and flux within 1e-6 relative (the flux of a fixed-T
    conductor from the indicator-gradient integral)."""
    jp, tp, mesh = _conductor_pair(circ_type)
    tcalls = count_calls(band_engines, tnewton, "run_heat")
    jcalls = count_calls(band_engines, jnewton, "run_heat")
    sol = theat.solve(tp, mesh, **ON_CPU)
    jsol = jheat.solve(jp, mesh)
    assert tcalls and jcalls
    assert sol.residual <= tp.Precision
    assert np.abs(sol.T - jsol.T).max() <= 1e-6 * np.abs(jsol.T).max()
    assert np.allclose(sol.conductor_V, jsol.conductor_V, rtol=1e-6)
    assert np.allclose(sol.conductor_q, jsol.conductor_q, rtol=1e-6)
    assert np.array_equal(sol.node_Q, jsol.node_Q) and (sol.node_Q == 0).any()
    if circ_type == 1:
        assert sol.conductor_V[0] == 500.0 and abs(sol.conductor_q[0]) > 0
    else:
        assert sol.conductor_q[0] == 50.0 and sol.conductor_V[0] > 300.0


def test_axisymmetric_heat_matches_jax(fixtures, band_engines):
    """HeatTemp0 solved as an axisymmetric problem (2 pi r element depth,
    r-weighted convection edges) on the loop in both packages: the
    residual, and T within 1e-6 of max|T| of the JAX package's."""
    from xfemm_tpu.constants import ProblemType as JPT
    from xfemm_tpu_torch.constants import ProblemType as TPT
    jcalls = count_calls(band_engines, jnewton, "run_heat")
    tcalls = count_calls(band_engines, tnewton, "run_heat")
    p, mesh = heat_temp0(fixtures, "t")
    p.ProblemType = TPT.AXISYMMETRIC
    jp, jmesh = heat_temp0(fixtures, "j")
    jp.ProblemType = JPT.AXISYMMETRIC
    sol = theat.solve(p, mesh, **ON_CPU)
    jsol = jheat.solve(jp, jmesh)
    assert jcalls and tcalls
    assert sol.residual <= p.Precision
    assert np.abs(sol.T - jsol.T).max() <= 1e-6 * np.abs(jsol.T).max()
    planar = jheat.solve(*heat_temp0(fixtures, "j"))
    assert np.abs(planar.T - jsol.T).max() > 1e-4 * np.abs(jsol.T).max()


def test_prevsoln_file_matches_tprev(tmp_path, port_band):
    """A transient step whose previous T comes from the file named by
    ``PrevSoln`` (a .anh the port wrote; nodes matched by coordinates)
    equals the step given the same T as ``Tprev`` (1e-9 of max|T|) and
    the JAX package's step from the same file (1e-6)."""
    from xfemm_tpu_torch.io import ansfile as tans
    jp, tp, mesh = _transient_pair(False, 0.01)
    first = theat.solve(tp, mesh, Tprev=np.full(mesh.num_nodes, 400.0),
                        **ON_CPU)
    path = str(tmp_path / "step1.anh")
    tans.write_scalar_solution(tp, mesh, first.T, first.node_Q, [], path)
    direct = theat.solve(tp, mesh, Tprev=first.T, **ON_CPU)
    tp.PrevSoln = jp.PrevSoln = path
    from_file = theat.solve(tp, mesh, **ON_CPU)
    jsol = jheat.solve(jp, mesh)
    scale = np.abs(direct.T).max()
    assert np.abs(from_file.T - direct.T).max() <= 1e-9 * scale
    assert np.abs(from_file.T - jsol.T).max() <= 1e-6 * scale
    # the step moved T (~0.07 K) far beyond those tolerances
    assert np.abs(direct.T - first.T).max() > 1e-4 * scale


# ---------------------------------------------------------------------- #
# entry points                                                           #
# ---------------------------------------------------------------------- #

def test_build_heat_matches_jax():
    """``benchprob.build_heat`` field by field against the JAX
    package's: the settings, materials (the K(T) curve), boundaries,
    nodes, segments, arcs and block labels."""
    for n in (10_000, 230_000):
        a, b = tbench.build_heat(n), jbench.build_heat(n)
        for name in ("filetype", "Precision", "MinAngle", "Depth",
                     "LengthUnits", "ProblemType", "DoSmartMesh"):
            assert getattr(a, name) == getattr(b, name), name
        for name in ("blockproplist", "lineproplist", "nodeproplist",
                     "nodelist", "linelist", "arclist", "labellist"):
            xs, ys = getattr(a, name), getattr(b, name)
            assert len(xs) == len(ys)
            for x, y in zip(xs, ys):
                assert vars(x) == vars(y), (name, vars(x), vars(y))
        assert a.blockproplist[1].npts == 5


def test_small_build_heat_solve_matches_jax(band_engines):
    """``benchprob.build_heat`` at ~3k nodes (the heat230k cell's
    problem, cut in size) through ``models.solve``: the loop engaged in
    both packages, the residual, T within 1e-6 of max|T| of the JAX
    package's."""
    jp, tp = jbench.build_heat(3_000), tbench.build_heat(3_000)
    mesh = jmesher.mesh_problem(jp)
    jcalls = count_calls(band_engines, jnewton, "run_heat")
    tcalls = count_calls(band_engines, tnewton, "run_heat")
    sol = tmodels.solve(tp, mesh, **ON_CPU)
    jsol = jheat.solve(jp, mesh)
    assert jcalls and tcalls
    assert sol.residual <= tp.Precision
    assert np.abs(sol.T - jsol.T).max() <= 1e-6 * np.abs(jsol.T).max()


@pytest.mark.parametrize("kw,exc,match", [
    (dict(device_mesh=object()), TypeError, "device_mesh"),
    (dict(devices=2, device_mesh=["cpu", "meta"]), NotImplementedError,
     "C.17")], ids=["kw0", "kw1"])
def test_domain_decomposition_raises(fixtures, kw, exc, match):
    """A ``device_mesh`` that is not a device (or a list of them) names
    the parameter; one that names several distinct devices names the
    missing multi-card communicator (ROADMAP C.17)."""
    p, mesh = heat_temp0(fixtures, "t")
    with pytest.raises(exc, match=match):
        theat.solve(p, mesh, **kw, **ON_CPU)


@pytest.mark.parametrize("devices", [2, 8])
def test_domain_decomposition_matches_jax_and_golden(fixtures, port_band,
                                                     devices):
    """HeatTemp0 with ``devices=N``: every linear solve of the
    substitution chain as a domain decomposition (the K(T) loop not
    taken), against the JAX package's ``devices=N`` T and the golden
    solution at 1e-6 of max|T|."""
    calls = count_calls(port_band, tnewton, "run_heat")
    p, mesh = heat_temp0(fixtures, "t")
    sol = theat.solve(p, mesh, devices=devices, **ON_CPU)
    jsol = jheat.solve(*heat_temp0(fixtures, "j"), devices=devices)
    assert not calls
    assert sol.residual <= p.Precision
    assert np.abs(sol.T - jsol.T).max() <= 1e-6 * np.abs(jsol.T).max()
    assert golden_distance(fixtures, mesh, sol.T) < 1e-6


def test_hi_verbs_round_trip_matches_jax(fixtures, band_engines):
    """HeatTemp0 through the pyFEMM verbs (open on the CPU path,
    ``hi_analyze`` -- which meshes --, ``hi_loadsolution``, point values)
    in the port and in the JAX package: the same mesher, so the same
    mesh; T within 1e-6 relative, the flux and gradient components
    within 1e-5 of their largest (one element's derivatives of T), the
    conductivities within 1e-6 relative."""
    import xfemm_tpu.femm_compat as jfemm
    import xfemm_tpu_torch.femm_compat as tfemm

    out = {}
    for name, femm, kw in (("port", tfemm, ON_CPU), ("jax", jfemm, {})):
        femm.opendocument(str(fixtures / "HeatTemp0.feh"), **kw)
        femm.hi_analyze()
        femm.hi_loadsolution()
        out[name] = np.asarray(femm.ho_getpointvalues(0.5, 0.5), float)
    tv, jv = out["port"], out["jax"]
    assert np.isfinite(tv).all() and tv[0] > 300.0
    assert abs(tv[0] - jv[0]) <= 1e-6 * abs(jv[0])
    assert np.abs(tv[1:5] - jv[1:5]).max() <= 1e-5 * np.abs(jv[1:5]).max()
    assert np.allclose(tv[5:], jv[5:], rtol=1e-6)


def test_cli_solve_heat_matches_jax_and_golden(tmp_path, fixtures):
    """``python -m xfemm_tpu_torch solve HeatTemp0.feh --premeshed
    --device cpu`` (a subprocess on the port's default settings: the
    band engine and the K(T) loop) against the JAX package's CLI on its
    CPU default and against the golden .anh: T within 1e-6 of max|T|."""
    import os
    import shutil
    import subprocess
    import sys

    from xfemm_tpu.__main__ import main as jmain
    from xfemm_tpu_torch.io import ansfile as tans
    repo = fixtures.parent.parent
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        for ext in (".feh", ".node", ".ele", ".edge", ".pbc"):
            shutil.copy(fixtures / f"HeatTemp0{ext}",
                        tmp_path / d / f"HeatTemp0{ext}")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "xfemm_tpu_torch", "solve", "HeatTemp0.feh",
         "--premeshed", "--device", "cpu", "--hbm-bytes", str(HBM)],
        cwd=tmp_path / "port", env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "solved in" in proc.stdout
    assert jmain(["solve", str(tmp_path / "jax" / "HeatTemp0.feh"),
                  "--premeshed"]) == 0
    t = tans.read_ans(str(tmp_path / "port" / "HeatTemp0.anh"))
    j = ansfile.read_ans(str(tmp_path / "jax" / "HeatTemp0.anh"))
    a, b = np.real(t.values), np.real(j.values)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    mesh = tread_mesh(str(fixtures / "HeatTemp0"))
    assert golden_distance(fixtures, mesh, a) <= 1e-6
