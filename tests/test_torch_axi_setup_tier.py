"""The axisymmetric model's set-up tier
(``models/axisymmetric._SETUP_CACHE``) on the CPU, on the premeshed
AxiSolenoid fixture (6,415 nodes).

The pack, geometry, J-free static terms, the solver Session, the it-0
element blocks and the device Newton loop's data are kept per mesh,
device, device memory size, Kelvin radii and every property but the
blocks' J: a new problem on the same mesh whose block properties differ
only in J refreshes J, the circuits, the static and it-0 right-hand
sides and the loop's ``rhs_base`` ("axi setup (sources)"), the same
problem again takes all of it ("axi setup (reused)"), and any other
change builds anew ("axi setup (built)"). A solve from the kept state
is bit for bit the solve of the same problem with the set-up cache
cleared, and every answer is held to the JAX package's solve of the same
problem at 1e-6 of max|A| (``test_torch_axisymmetric.check``, the golden
solution too at the fixture's own J). Each host Newton pass writes the
nonlinear elements' slots of the kept volume block alone.
"""

import collections
import copy

import numpy as np
import pytest
import torch

from test_torch_axisymmetric import check
from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import axisymmetric as jaxi
from xfemm_tpu_torch.constants import C_APOT, MU0
from xfemm_tpu_torch.geometry import femfile
from xfemm_tpu_torch.geometry.problem import Problem
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files
from xfemm_tpu_torch.models import axisymmetric
from xfemm_tpu_torch.models.magnetostatics import _rhs
from xfemm_tpu_torch.ops import assembly, newton, solver
from xfemm_tpu_torch.utils import profiling

ON_CPU = dict(device="cpu", hbm_bytes=1e9)
CACHES = ((solver, "_BAND_CACHE"), (solver, "_PATTERN_CACHE"),
          (axisymmetric, "_SETUP_CACHE"))
#: the fixture's coil current density (MA/m^2), the golden solution's
GOLDEN_J = 3.0

torch.set_num_threads(1)


@pytest.fixture
def port(monkeypatch):
    """Fresh caches, the device loop on; the CPU path fails on any CUDA
    call."""
    monkeypatch.delenv("XFEMM_TPU_NO_DEVICE_NEWTON", raising=False)
    for mod, name in CACHES:
        monkeypatch.setattr(mod, name, collections.OrderedDict())

    def no_cuda(*a, **k):
        raise AssertionError("a CPU run touched CUDA")

    for name in ("is_available", "mem_get_info", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    return monkeypatch


@pytest.fixture
def tracing(monkeypatch):
    """Tracing on, with no spans from before."""
    monkeypatch.setattr(profiling, "ENABLED", True)
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def mesh(fixtures):
    return read_mesh_files(str(fixtures / "AxiSolenoid"))


def solenoid(fixtures, J: float = GOLDEN_J, jax: bool = False):
    """AxiSolenoid.fem with its coil at ``J``; ``jax``: the JAX
    package's problem."""
    p = (jfemfile if jax else femfile).load(str(fixtures / "AxiSolenoid.fem"))
    p.blockproplist[2].J = J
    return p


def external(p):
    """The air region made the Kelvin transform's external region."""
    p.labellist[0].IsExternal = True
    p.extRo, p.extRi, p.extZo = 10.0, 10.0, 0.0
    return p


_JAX_ANSWERS = {}


def jax_answer(fixtures, J: float):
    """The JAX package's solve of ``solenoid(J)`` (once per module)."""
    if J not in _JAX_ANSWERS:
        _JAX_ANSWERS[J] = jaxi.solve(
            solenoid(fixtures, J, jax=True),
            jread_mesh(str(fixtures / "AxiSolenoid")))
    return _JAX_ANSWERS[J]


def held(sol, mesh, fixtures, J: float, precision: float = 1e-8):
    """``check`` where the golden solution applies (the fixture's J);
    elsewhere its JAX half: the contract residual, the JAX package's
    answer at 1e-6 of max|A| and its circuit cases."""
    jsol = jax_answer(fixtures, J)
    if J == GOLDEN_J:
        check(sol, mesh, fixtures, jsol, precision)
        return
    assert sol.residual <= precision and np.isfinite(sol.A).all()
    assert np.abs(sol.A - jsol.A).max() <= 1e-6 * np.abs(jsol.A).max()
    assert np.array_equal(sol.label_case, jsol.label_case)


def cold(mp, problem, mesh):
    """``problem`` solved from empty caches."""
    for mod, name in CACHES:
        mp.setattr(mod, name, collections.OrderedDict())
    return axisymmetric.solve(problem, mesh, **ON_CPU)


def same(a, b):
    assert np.array_equal(a.A, b.A)
    assert a.iterations == b.iterations
    assert a.newton_iterations == b.newton_iterations


def kinds():
    """The set-up kind of each axisymmetric solve traced, in order;
    every one under an "axi static setup" span."""
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        if s.name.startswith("axi setup ("):
            assert by_id[s.parent].name == "axi static setup"
            out.append(s.name[len("axi setup ("):-1])
    return out


def count_calls(mp, mod, name):
    calls = []
    real = getattr(mod, name)

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls.append(out)
        return out

    mp.setattr(mod, name, counted)
    return calls


def the_entry():
    (entry,) = axisymmetric._SETUP_CACHE.values()
    return entry


@pytest.mark.parametrize("chain", ["device loop", "host chain"])
def test_current_sweep_builds_once(port, tracing, fixtures, mesh, chain):
    """A J sweep on one mesh, new problems as the benchmark's traffic
    sends them: the set-up is built once and then refreshed for each J.
    Each answer is held to the JAX package's (and the golden where it
    applies), and the answers of different J differ."""
    if chain == "host chain":
        port.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")
    packs = count_calls(port, axisymmetric, "pack")
    loops = count_calls(port, newton, "setup")
    sweep = (GOLDEN_J, 1.5, 4.0)
    sols = [axisymmetric.solve(solenoid(fixtures, J), mesh, **ON_CPU)
            for J in sweep]
    assert kinds() == ["built", "sources", "sources"]
    assert len(packs) == 1
    if chain == "device loop":
        assert len(loops) == 1 and loops[0] is not None
    else:
        assert loops == []
    for J, sol in zip(sweep, sols):
        held(sol, mesh, fixtures, J)
    assert np.abs(sols[1].A - sols[0].A).max() > 0.1 * np.abs(sols[0].A).max()


@pytest.mark.parametrize("chain", ["device loop", "host chain"])
def test_kept_state_is_bit_for_bit_a_fresh_set_up(port, tracing, fixtures,
                                                  mesh, chain):
    """A "sources" and a "reused" solve equal, bit for bit, the solve of
    the same problem after the set-up cache alone is cleared (the band
    and pattern caches kept): the kept state runs the fresh set-up's
    Newton schedule on the same systems."""
    if chain == "host chain":
        port.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")
    axisymmetric.solve(solenoid(fixtures, GOLDEN_J), mesh, **ON_CPU)
    kept = axisymmetric.solve(solenoid(fixtures, 1.5), mesh, **ON_CPU)
    again = axisymmetric.solve(solenoid(fixtures, 1.5), mesh, **ON_CPU)
    axisymmetric._SETUP_CACHE.clear()
    fresh = axisymmetric.solve(solenoid(fixtures, 1.5), mesh, **ON_CPU)
    assert kinds() == ["built", "sources", "reused", "built"]
    same(kept, fresh)
    same(again, fresh)
    held(fresh, mesh, fixtures, 1.5)


def test_kept_loop_takes_the_new_rhs(port, fixtures, mesh):
    """After a "sources" solve the kept loop's ``rhs_base`` equals the one
    a fresh ``newton.setup`` builds for that J, and differs from the
    previous J's; every other field is the one built for the first J."""
    loops = count_calls(port, newton, "setup")
    axisymmetric.solve(solenoid(fixtures, GOLDEN_J), mesh, **ON_CPU)
    axisymmetric.solve(solenoid(fixtures, 1.5), mesh, **ON_CPU)
    assert len(loops) == 1
    kept, kept_lam = the_entry()["dn"]
    cold(port, solenoid(fixtures, 1.5), mesh)
    (first, first_lam), (fresh, _) = loops
    assert kept_lam == first_lam
    assert torch.equal(kept.rhs_base, fresh.rhs_base)
    scale = float(fresh.rhs_base.abs().max())
    assert float((first.rhs_base - fresh.rhs_base).abs().max()) \
        > 1e-2 * scale
    for name in newton.DeviceNewton._fields:
        if name != "rhs_base":
            assert getattr(kept, name) is getattr(first, name), name


def test_loop_data_follow_the_band_layout(port, fixtures, mesh):
    """The kept loop data address the kept Session's band layout: once
    the band is rebuilt (a new layout) the next solve builds them anew,
    and the answer holds."""
    loops = count_calls(port, newton, "setup")
    axisymmetric.solve(solenoid(fixtures, GOLDEN_J), mesh, **ON_CPU)
    sess = the_entry()["sess"]
    sess.band_layout = copy.copy(sess.band_layout)
    sol = axisymmetric.solve(solenoid(fixtures, 1.5), mesh, **ON_CPU)
    assert len(loops) == 2 and loops[1] is not None
    assert the_entry()["dn"] is loops[1]
    held(sol, mesh, fixtures, 1.5)


def _bh_point(p):
    # as pyFEMM's mi_addbhpoint: one point moved, the curve set up anew
    steel = p.blockproplist[1]
    steel.Hdata[3] = 1.2 * steel.Hdata[3]
    steel.slope = []


def _block_mu(p):
    p.blockproplist[0].mu_x = p.blockproplist[0].mu_y = 1.5


def _precision(p):
    p.Precision = 1e-9


def _kelvin_radii(p):
    p.extRi = 12.0


@pytest.mark.parametrize("edit", [_bh_point, _block_mu, _precision,
                                  _kelvin_radii],
                         ids=["B-H point", "block mu", "Precision",
                              "Kelvin radii"])
def test_other_edits_build_again(port, tracing, fixtures, mesh, edit):
    """A change of anything but the blocks' J between two solves on one
    mesh (the same problem edited in place) builds the set-up again; a
    new problem of the edited content then takes that set-up. The Kelvin
    radii are not in the problem's fingerprint, so the Kelvin case runs
    on a problem with an external region and holds the key to them. The
    answers equal the cold solve, and differ from the unedited problem's
    where the edit moves the field."""
    def problem():
        p = solenoid(fixtures)
        return external(p) if edit is _kelvin_radii else p

    packs = count_calls(port, axisymmetric, "pack")
    p = problem()
    base = axisymmetric.solve(p, mesh, **ON_CPU)
    edit(p)
    sol = axisymmetric.solve(p, mesh, **ON_CPU)
    q = problem()
    edit(q)
    again = axisymmetric.solve(q, mesh, **ON_CPU)
    assert kinds() == ["built", "built", "reused"]
    assert len(packs) == 2
    ref = cold(port, q, mesh)
    precision = q.Precision
    for s in (sol, again):
        assert s.residual <= precision
        assert np.abs(s.A - ref.A).max() <= 1e-6 * np.abs(ref.A).max()
    if edit is not _precision:
        assert np.abs(sol.A - base.A).max() > 1e-3 * np.abs(base.A).max()
    else:
        held(sol, mesh, fixtures, GOLDEN_J, precision)


def test_another_mesh_builds_its_own(port, fixtures, mesh):
    """Equal problems on two meshes each build their own set-up, the
    entry holds no problem, and an entry whose mesh is another never
    serves a mesh, even under its key (as when a freed mesh's id passes
    to a new one)."""
    other = read_mesh_files(str(fixtures / "AxiSolenoid"))
    packs = count_calls(port, axisymmetric, "pack")
    axisymmetric.solve(solenoid(fixtures), mesh, **ON_CPU)
    sol = axisymmetric.solve(solenoid(fixtures, 1.5), other, **ON_CPU)
    assert len(packs) == 2
    cache = axisymmetric._SETUP_CACHE
    assert len(cache) == 2
    for entry in cache.values():
        assert entry["pk"].problem is None
        assert not any(isinstance(v, Problem) for v in entry.values())
    (key, entry), = [(k, v) for k, v in cache.items()
                     if v["pk"].mesh is mesh]
    cache.clear()
    cache[(id(other),) + key[1:]] = entry
    again = axisymmetric.solve(solenoid(fixtures, 1.5), other, **ON_CPU)
    assert len(packs) == 3
    assert packs[2].mesh is other
    held(sol, other, fixtures, 1.5)
    same(again, sol)


def test_host_pass_writes_the_nonlinear_slots_alone(port, fixtures, mesh):
    """On the host chain, each pass after iteration 0 leaves the linear
    elements' slots of the volume block as iteration 0 set them, bit for
    bit, and its nonlinear slots and right-hand side are a full rebuild's
    of every element at the pass's V (the unlaminated steel's
    energy-form |B|, B-H curve and Newton matrices, staticaxi.cpp:
    510-600)."""
    port.setenv("XFEMM_TPU_NO_DEVICE_NEWTON", "1")
    passes = []
    real = solver.solve

    def host_solve(blocks, b, *a, **kw):
        passes.append((blocks[0].mat.copy(), np.array(b), kw.get("x0")))
        return real(blocks, b, *a, **kw)

    port.setattr(solver, "solve", host_solve)
    axisymmetric.solve(solenoid(fixtures, 1.5), mesh, **ON_CPU)
    first = len(passes)
    sol = axisymmetric.solve(solenoid(fixtures, GOLDEN_J), mesh, **ON_CPU)
    held(sol, mesh, fixtures, GOLDEN_J)
    entry = the_entry()
    pk, geom, (Mx, My) = entry["pk"], entry["geom"], entry["M"]
    _, mu1_0, mu2_0, _ = entry["terms"]
    be_static = axisymmetric._be_static(pk, geom, entry["terms"][0])
    nl = pk.nonlinear
    assert nl.any() and (~nl).any() and (pk.lam_type[nl] == 0).all()
    mat0, b0, _ = passes[first]
    assert np.array_equal(mat0, -(Mx / mu2_0[:, None, None]
                                  + My / mu1_0[:, None, None]))
    assert len(passes) - first >= 3
    c = C_APOT
    for mat, b, V in passes[first + 1:]:
        assert np.array_equal(mat[~nl], mat0[~nl])
        # the full rebuild: every element's matrix, the steel's |B|, mu
        # and Newton matrix at V
        Vl = pk.rsign[pk.tris] * V[pk.ridx[pk.tris]]
        S = (Mx + My)[nl]
        vol = np.asarray(geom.vol)[nl]
        B = np.sqrt(np.abs(np.einsum("tj,tjk,tk->t", Vl[nl], S, Vl[nl])
                           * 1e4 * c * c / vol))
        vv, dv = assembly.hermite_vdv(B, pk.bh_B[nl], pk.bh_H[nl],
                                      pk.bh_S[nl])
        mu1, mu2 = mu1_0.copy(), mu2_0.copy()
        mu1[nl] = mu2[nl] = 1.0 / (MU0 * vv)
        v0 = np.einsum("tjk,tk->tj", S, Vl[nl])
        Mn = np.zeros_like(Mx)
        Mn[nl] = (-200.0 * c ** 3 * dv / vol)[:, None, None] \
            * v0[:, :, None] * v0[:, None, :]
        Me = Mx / mu2[:, None, None] + My / mu1[:, None, None] + Mn
        scale = np.abs(Me[nl]).max()
        assert np.abs(mat[nl] + Me[nl]).max() <= 1e-12 * scale
        be = be_static + np.einsum("tjk,tk->tj", Mn, Vl)
        full_b = _rhs(pk, geom, be)
        assert np.abs(b - full_b).max() <= 1e-12 * np.abs(full_b).max()
