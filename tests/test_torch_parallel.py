"""The port's domain decomposition (``xfemm_tpu_torch/parallel``): the
partition, the communicator, the f64 element-block PCG with one ring halo
(Jacobi, the additive-Schwarz AMG and the global coarse solve), the
complex-symmetric PCG, and the models' ``devices=`` / ``device_mesh=``,
each held against the JAX package's ``parallel/`` on the 8 virtual CPU
devices of tests/conftest.py (x64 on) and the port on ``device="cpu"``.

Tolerances: the partition and the Schwarz host arrays are bit for bit;
the halo PCGs run f64 on both sides and differ only in the order of
their scatter-adds, so solutions agree to 1e-10 of max|x| and iteration
counts within 1; whole model solves are held to the JAX package's
``devices=8`` solve and the golden files at 1e-6 of max|A| (the
tolerance of tests/test_parallel.py)."""

import functools

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax
from jax.sharding import Mesh

from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.mesh import mesher as jmesher
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import axisymmetric as jaxi
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu.models import harmonic as jharm
from xfemm_tpu.models import harmonicaxi as jharmaxi
from xfemm_tpu.models import magnetostatics as jmag
from xfemm_tpu.ops import assembly as jassembly
from xfemm_tpu.ops import solver as jsolver
from xfemm_tpu.parallel import halo as jhalo
from xfemm_tpu.parallel import partition as jpart
from xfemm_tpu.parallel import schwarz as jschwarz
from xfemm_tpu.parallel.driver import DistributedSession as JSession
from xfemm_tpu_torch import convert
from xfemm_tpu_torch import models as tmodels
from xfemm_tpu_torch.__main__ import main as tmain
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.io import ansfile as tans
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files as tread_mesh
from xfemm_tpu_torch.models import benchprob as tbench
from xfemm_tpu_torch.ops import solver as tsolver
from xfemm_tpu_torch.parallel import comm
from xfemm_tpu_torch.parallel import driver as tdriver
from xfemm_tpu_torch.parallel import halo as thalo
from xfemm_tpu_torch.parallel import partition as tpart
from xfemm_tpu_torch.parallel import schwarz as tschwarz

ON_CPU = dict(device="cpu", hbm_bytes=1e9)

# several worker processes on a few cores: one torch thread each
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _system():
    """The 2,500-node linear magnetostatic system of
    tests/test_parallel.py: element blocks, right-hand side and DOF
    coordinates (numpy, fed to both packages)."""
    p = jbench.build(2500)
    mesh = jmesher.mesh_problem(p)
    pk = jmag.pack(p, mesh)
    geom = jassembly.tri_geometry(pk.xy, pk.tris)
    Mx, My, _ = jassembly.curl_matrices(geom)
    mu = np.where(pk.nonlinear, 1000.0, pk.mu_x)
    Me = np.asarray(Mx) / mu[:, None, None] \
        + np.asarray(My) / mu[:, None, None]
    idx = pk.ridx[pk.tris]
    sign = pk.rsign[pk.tris]
    b = np.zeros(pk.nreduced)
    np.add.at(b, idx.reshape(-1),
              -(sign * (-(pk.Jre * np.asarray(geom.area) / 3.0)[:, None]
                        * np.ones((1, 3)))).reshape(-1))
    coords = np.zeros((pk.nreduced, 2))
    coords[pk.ridx] = pk.xy
    return pk, [(idx, sign, -Me)], b, coords


def _partitions(ndev):
    pk, blocks, _b, coords = _system()
    args = (blocks, pk.nreduced, pk.fixed_mask, pk.fixed_vals, coords, ndev)
    return jpart.partition(*args), tpart.partition(*args)


def _mesh(ndev):
    return Mesh(np.array(jax.devices()[:ndev]), ("d",))


# --------------------------- partition ------------------------------- #
@pytest.mark.parametrize("ndev", [4, 6, 8])
def test_partition_matches_jax(ndev):
    """The port's partition is the JAX package's bit for bit, also for a
    part count that is not a power of two."""
    jps, tps = _partitions(ndev)
    for name in ("ndev", "nmax", "hmax", "nreduced"):
        assert getattr(tps, name) == getattr(jps, name), name
    for name in ("counts", "fixed_mask", "fixed_vals", "valid", "dof_dev",
                 "dof_slot"):
        a, b = getattr(tps, name), getattr(jps, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for tb, jb in zip(tps.blocks, jps.blocks):
        for a, b in zip(tb, jb):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tps.valid.sum() == tps.nreduced


# ---------------------------- comm ----------------------------------- #
def test_comm_matches_numpy():
    """Ring shifts (both ways, the open end zeroed), the part-order sum,
    the all-gather and the global dot product against numpy."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((5, 7, 3))
    t = torch.as_tensor(x)
    right = np.roll(x, 1, axis=0)
    right[0] = 0.0
    left = np.roll(x, -1, axis=0)
    left[-1] = 0.0
    assert np.array_equal(comm.ring_shift(t, 1).numpy(), right)
    assert np.array_equal(comm.ring_shift(t, -1).numpy(), left)
    acc = x[0].copy()
    for p in range(1, 5):
        acc = acc + x[p]
    assert np.array_equal(comm.psum(t).numpy(), acc)
    assert np.array_equal(comm.all_gather(t[:, :, 0]).numpy(),
                          x[:, :, 0].reshape(-1))
    # each part's own dot product, then the part-order sum
    dots = (t[:, :, 0] * t[:, :, 1]).sum(dim=1).numpy()
    want = dots[0]
    for p in range(1, 5):
        want = want + dots[p]
    assert comm.pdot(t[:, :, 0], t[:, :, 1]).item() == want
    with pytest.raises(ValueError):
        comm.ring_shift(t, 2)


# -------------------------- halo PCG --------------------------------- #
@pytest.mark.parametrize("schwarz,ndev", [(False, 8), (True, 8),
                                           (True, 4)])
def test_halo_pcg_matches_jax(schwarz, ndev):
    """The f64 ring-halo PCG, Jacobi and two-level Schwarz (at 8 parts
    each part's block is its own bottom level; at 4 it has a V-cycle), on
    the SAME partition in both packages (carried by ``convert``):
    solutions within 1e-10 of max|x|, iteration counts within 1, both at
    1e-10."""
    pk, blocks, b, coords = _system()
    jps, _ = _partitions(ndev)
    tps = convert.partitioned_system(jps)
    xj, rj, ij = jhalo.solve_distributed(jps, b, 1e-10, _mesh(ndev),
                                         schwarz=schwarz)
    xt, rt, it = thalo.solve_distributed(tps, b, 1e-10, "cpu",
                                         schwarz=schwarz)
    assert rt <= 1e-10 and rj <= 1e-10
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()
    assert abs(it - ij) <= 1, (it, ij)


def test_halo_matvec_and_diag_match_jax():
    """One distributed product and the assembled diagonal in part
    layout, against the JAX package's (f64, scatter order only)."""
    jps, _ = _partitions(8)
    tps = convert.partitioned_system(jps)
    mesh = _mesh(8)
    jda = jhalo.device_arrays(jps)
    tda = thalo.device_arrays(tps)
    x = np.random.default_rng(2).standard_normal((8, jps.nmax))
    yj = np.asarray(jhalo.make_distributed_matvec(mesh, jps.hmax)(
        jda, jax.numpy.asarray(x)))
    yt = thalo.make_distributed_matvec(tps.hmax)(tda, torch.as_tensor(x))
    assert np.abs(yt.numpy() - yj).max() <= 1e-12 * np.abs(yj).max()
    dj = np.asarray(jhalo.distributed_diag(mesh, jda, jps.hmax))
    dt = thalo.distributed_diag(tda, tps.hmax).numpy()
    assert np.abs(dt - dj).max() <= 1e-12 * np.abs(dj).max()


def test_schwarz_host_arrays_match_jax():
    """The per-part Schwarz hierarchies and the global coarse inverse:
    the JAX package's host arrays bit for bit (``omega`` carries one
    broadcast axis in the port)."""
    jps, tps = _partitions(4)
    jamg = jschwarz.build_schwarz_amg(jps, dtype=np.float64)
    tamg = tschwarz.build_schwarz_amg(tps, dtype=np.float64)
    assert len(tamg.levels) == len(jamg.levels) >= 1
    for tl, jl in zip(tamg.levels, jamg.levels):
        for name in ("ell_vals", "ell_cols", "invd", "p_vals", "p_cols"):
            assert np.array_equal(getattr(tl, name).numpy(),
                                  np.asarray(getattr(jl, name))), name
        assert np.array_equal(tl.omega.numpy().ravel(),
                              np.asarray(jl.omega))
    assert np.array_equal(tamg.coarse_inv.numpy(),
                          np.asarray(jamg.coarse_inv))
    cj, aj = jschwarz.build_global_coarse(jps)
    ct, at = tschwarz.build_global_coarse(tps)
    assert at == aj and np.array_equal(ct.numpy(), np.asarray(cj))


def _eddy_system():
    """tests/test_parallel.py's complex-symmetric system: the stiffness
    plus i*0.3 times the consistent mass on every element."""
    pk, blocks, b, coords = _system()
    idx, sign, negMe = blocks[0]
    E = idx.shape[0]
    mass = np.tile((np.full((3, 3), 1.0) + np.eye(3)) / 12.0, (E, 1, 1))
    matc = negMe.astype(complex) + 1j * 0.3 * mass
    return pk, idx, sign, matc, b.astype(complex), coords


def test_csym_pcg_matches_jax():
    """The distributed complex-symmetric PCG on (re, im) pairs through
    both packages' sessions (``schwarz=False``, the AC models' choice):
    solutions within 1e-10 of max|x|, iterations within 1, and the
    single-device complex solve to 1e-7 (tests/test_parallel.py)."""
    pk, idx, sign, matc, bc, coords = _eddy_system()
    fv = pk.fixed_vals.astype(complex)
    js = JSession(8, schwarz=False)
    xj, rj, ij = js.solve_complex(
        [jsolver.ElementBlock(idx=idx, sign=sign, mat=matc)], bc,
        pk.fixed_mask, fv, 1e-9, coords=coords)
    ts = tdriver.DistributedSession(8, schwarz=False, device="cpu")
    xt, rt, it = ts.solve_complex(
        [tsolver.ElementBlock(idx=idx, sign=sign, mat=matc)], bc,
        pk.fixed_mask, fv, 1e-9, coords=coords)
    assert rt <= 1e-9 and rj <= 1e-9
    xj = np.asarray(xj)
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()
    assert abs(it - ij) <= 1, (it, ij)
    x_ref, _, _ = jsolver.solve_complex(
        [jsolver.ElementBlock(idx=idx, sign=sign, mat=matc)], bc,
        pk.fixed_mask, fv, 1e-9)
    x_ref = np.asarray(x_ref)
    assert np.abs(xt - x_ref).max() <= 1e-7 * np.abs(x_ref).max()


def test_session_halo_path_and_refresh():
    """``DistributedSession.solve`` below the band engine's size gate:
    the Schwarz PCG cold gives ``halo.solve_distributed``'s solution (held
    to the JAX package's above) to 1e-10 of max|x|; a value refresh on
    the same session (the matrices scaled by 2, the hierarchy kept)
    gives half of it, to 1e-10."""
    pk, blocks, b, coords = _system()
    idx, sign, mat = blocks[0]
    args = (pk.fixed_mask, pk.fixed_vals, 1e-10)
    x_ref, _r, _it = thalo.solve_distributed(_partitions(8)[1], b, 1e-10,
                                             "cpu", schwarz=True)
    ts = tdriver.DistributedSession(8, device="cpu")
    xt, rt, _it = ts.solve([tsolver.ElementBlock(idx=idx, sign=sign,
                                                 mat=mat)], b, *args,
                           coords=coords)
    assert ts._bdd is None and ts._amg is not None
    assert rt <= 1e-10
    assert np.abs(xt - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    amg = ts._amg
    x2, r2, _it2 = ts.solve([tsolver.ElementBlock(idx=idx, sign=sign,
                                                  mat=2.0 * mat)], b, *args,
                            coords=coords)
    assert ts._amg is amg and r2 <= 1e-10
    assert np.abs(2.0 * x2 - xt).max() <= 1e-10 * np.abs(xt).max()


# ------------------------- device_mesh ------------------------------- #
def test_device_mesh_names_one_device():
    """``device_mesh``: a device or a list of the same device holds every
    part there; something else raises a TypeError naming the parameter;
    several distinct devices raise NotImplementedError naming ROADMAP
    C.17. Without a device the session asks for the card."""
    s = tdriver.DistributedSession(4, mesh=["cpu"] * 4)
    assert s.device == torch.device("cpu")
    assert tdriver.DistributedSession(2, mesh="cpu").device.type == "cpu"
    with pytest.raises(TypeError, match="device_mesh"):
        tdriver.DistributedSession(2, mesh=object())
    with pytest.raises(NotImplementedError, match="C.17"):
        tdriver.DistributedSession(2, mesh=["cpu", "meta"])
    assert tdriver.session(None) is None
    with pytest.raises(TypeError, match="device_mesh"):
        tdriver.session(None, device_mesh=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdriver.DistributedSession(2)


# ----------------------------- models -------------------------------- #
def _golden(fixtures, stem, mesh, A, tol=1e-6):
    g = tans.read_ans(str(fixtures / f"{stem}.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-12
    Ag = g.values
    assert np.abs(A[idx] - Ag).max() <= tol * np.abs(Ag).max()


def _close(a, b, tol=1e-6):
    assert np.abs(np.asarray(a) - np.asarray(b)).max() \
        <= tol * np.abs(np.asarray(b)).max()


def test_magnetostatics_devices_matches_jax():
    """The nonlinear 3,000-node benchmark problem with ``devices=8``
    (every linear solve below the band engine's gate: the halo Schwarz
    PCG): the JAX package's ``devices=8`` A at 1e-6 of max|A|, with
    several Newton iterations."""
    jp, tp = jbench.build(3000), tbench.build(3000)
    mesh = jmesher.mesh_problem(jp)
    jsol = jmag.solve(jp, mesh, devices=8)
    sol = tmodels.solve(tp, mesh, devices=8, **ON_CPU)
    assert sol.residual <= tp.Precision and sol.newton_iterations > 1
    _close(sol.A, jsol.A)


def test_axisymmetric_devices_matches_jax_and_golden(fixtures):
    """AxiSolenoid with ``devices=8``: the Newton chain on the host, each
    linear solve distributed; the JAX package's ``devices=8`` A and the
    golden solution at 1e-6 of max|A|."""
    p = tfemfile.load(str(fixtures / "AxiSolenoid.fem"))
    mesh = tread_mesh(str(fixtures / "AxiSolenoid"))
    sol = tmodels.solve(p, mesh, devices=8, **ON_CPU)
    jsol = jaxi.solve(jfemfile.load(str(fixtures / "AxiSolenoid.fem")),
                      jread_mesh(str(fixtures / "AxiSolenoid")), devices=8)
    assert sol.residual <= p.Precision
    _close(sol.A, jsol.A)
    _golden(fixtures, "AxiSolenoid", mesh, np.real(sol.A))


def _no_circuits(p, coil_j=None):
    for lab in p.labellist:
        lab.InCircuit = -1
    if coil_j is not None:
        for m in p.blockproplist:
            if m.name == "Coil":
                m.J = coil_j
    return p


@pytest.mark.parametrize("stem", ["ACwound", "ACtest"])
def test_harmonic_devices_matches_jax_and_golden(fixtures, stem, monkeypatch):
    """``harmonic.solve(devices=8)`` against the golden solution at 1e-6:
    ACwound through the f64 complex halo PCG, also held to the JAX
    package's ``devices=8`` solve; ACtest on the single-device path (its
    circuit Case-2 DOFs couple every part, so no session is made)."""
    made = []
    real = tdriver.DistributedSession.__init__
    monkeypatch.setattr(tdriver.DistributedSession, "__init__",
                        lambda self, *a, **k: (made.append(1),
                                               real(self, *a, **k))[1])
    p = tfemfile.load(str(fixtures / f"{stem}.fem"))
    mesh = tread_mesh(str(fixtures / stem))
    sol = tmodels.solve(p, mesh, devices=8, **ON_CPU)
    assert sol.residual <= p.Precision
    assert bool(made) == (stem == "ACwound")
    _golden(fixtures, stem, mesh, sol.A)
    if stem == "ACwound":
        jp = jfemfile.load(str(fixtures / f"{stem}.fem"))
        _close(sol.A, jharm.solve(jp, jread_mesh(str(fixtures / stem)),
                                  devices=8).A)


def test_harmonicaxi_devices_matches_jax(fixtures):
    """ACaxi with its circuit replaced by a fixed J (no Case-2 rows, as
    tests/test_parallel.py): ``devices=8`` against the JAX package's
    ``devices=8`` and the port's single-device solve at 1e-6."""
    p = _no_circuits(tfemfile.load(str(fixtures / "ACaxi.fem")), 2.0 + 0.0j)
    mesh = tread_mesh(str(fixtures / "ACaxi"))
    sol = tmodels.solve(p, mesh, devices=8, **ON_CPU)
    assert sol.residual <= p.Precision
    jp = _no_circuits(jfemfile.load(str(fixtures / "ACaxi.fem")),
                      2.0 + 0.0j)
    _close(sol.A, jharmaxi.solve(jp, jread_mesh(str(fixtures / "ACaxi")),
                                 devices=8).A)
    one = tmodels.solve(
        _no_circuits(tfemfile.load(str(fixtures / "ACaxi.fem")),
                     2.0 + 0.0j), mesh, **ON_CPU)
    _close(sol.A, one.A)


def test_cli_solve_devices(tmp_path, fixtures, capsys):
    """``python -m xfemm_tpu_torch solve --devices 4 --device cpu``: the
    written .ans equals the golden solution at 1e-6 of max|A|."""
    import shutil
    for ext in (".fem", ".node", ".ele", ".edge", ".pbc"):
        shutil.copy(fixtures / f"ACwound{ext}", tmp_path / f"ACwound{ext}")
    assert tmain(["solve", str(tmp_path / "ACwound.fem"), "--premeshed",
                  "--devices", "4", "--device", "cpu",
                  "--hbm-bytes", "1e9"]) == 0
    assert "solved in" in capsys.readouterr().out
    out = tans.read_ans(str(tmp_path / "ACwound.ans"))
    g = tans.read_ans(str(fixtures / "ACwound.ans.golden"))
    d, idx = cKDTree(out.mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-9
    _close(out.values[idx], g.values)
