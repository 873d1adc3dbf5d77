"""The domain decomposition over a ``torch.distributed`` process group:
four gloo ranks on the CPU (``parallel/launch.spawn``), each holding its
own part, against the stacked one-process path on the same inputs.

The ranks run bodies of the port (``parallel/rankjobs.py``), never this
file, which imports JAX. Each launch has a wall limit and a process-group
timeout, so a rank that fails or a collective that does not match ends
in an error, not a hang.

Tolerances: ``GroupComm``'s operations are the stacked functions' rows
bit for bit; the sharded band engine (f32 CG passes in the f64
refinement) gives x within 1e-6 of max|x| and CG counts within 1 per
pass; the f64 halo PCGs (Jacobi, Schwarz, complex-symmetric) give x
within 1e-12 of max|x| and equal iteration counts; a whole
``magnetostatics.solve(devices=4)`` is within 1e-9 of max|A| of the
stacked port's and 1e-6 of the JAX package's ``devices=4`` solve (on
conftest's virtual devices); every rank returns the same x.
"""

import functools
import shutil

import numpy as np
import pytest
import torch

from xfemm_tpu.mesh import mesher as jmesher
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu.models import magnetostatics as jmag
from xfemm_tpu_torch import models as tmodels
from xfemm_tpu_torch.__main__ import main as tmain
from xfemm_tpu_torch.io import ansfile as tans
from xfemm_tpu_torch.mesh import mesher as tmesher
from xfemm_tpu_torch.models import benchprob as tbench
from xfemm_tpu_torch.models import magnetostatics as tmag
from xfemm_tpu_torch.ops import assembly as tassembly
from xfemm_tpu_torch.parallel import comm, launch, rankjobs

# several worker processes on a few cores: one torch thread each
torch.set_num_threads(1)

P = 4
TOL = 1e-10
ON_CPU = dict(device="cpu", hbm_bytes=1e9)
#: seconds for one four-rank launch, and for one of its collectives
WALL, PG_TIMEOUT = 120.0, 60.0


def _spawn(fn, *args):
    return launch.spawn(fn, P, "gloo", "cpu", args=args, wall=WALL,
                        pg_timeout=PG_TIMEOUT)


@functools.lru_cache(maxsize=None)
def _systems():
    """The 2,500-node linear magnetostatic system of
    tests/test_torch_parallel.py (2,400-odd unknowns: above the band
    engine's 4*4*128 gate) as numpy element blocks, right-hand side,
    Dirichlet set and DOF coordinates, and its complex-symmetric twin
    (the stiffness plus i*0.3 times the consistent mass)."""
    p = tbench.build(2500)
    pk = tmag.pack(p, tmesher.mesh_problem(p))
    geom = tassembly.tri_geometry(pk.xy, pk.tris)
    Mx, My, _ = tassembly.curl_matrices(geom)
    mu = np.where(pk.nonlinear, 1000.0, pk.mu_x)
    Me = Mx / mu[:, None, None] + My / mu[:, None, None]
    idx = pk.ridx[pk.tris]
    sign = pk.rsign[pk.tris]
    b = np.zeros(pk.nreduced)
    np.add.at(b, idx.reshape(-1),
              -(sign * (-(pk.Jre * geom.area / 3.0)[:, None]
                        * np.ones((1, 3)))).reshape(-1))
    coords = np.zeros((pk.nreduced, 2))
    coords[pk.ridx] = pk.xy
    fixed = np.asarray(pk.fixed_mask, bool)
    real = ([(idx, sign, -Me)], b, fixed, pk.fixed_vals, coords)
    mass = np.tile((np.full((3, 3), 1.0) + np.eye(3)) / 12.0,
                   (idx.shape[0], 1, 1))
    eddy = ([(idx, sign, -Me.astype(complex) + 1j * 0.3 * mass)],
            b.astype(complex), fixed, pk.fixed_vals.astype(complex), coords)
    return real, eddy


@functools.lru_cache(maxsize=None)
def _ranks_solves():
    """The four solves over four ranks ("group"), and rank 0's same
    solves on the stacked communicator ("stacked")."""
    real, eddy = _systems()
    res = _spawn(rankjobs.linear_solves, real, eddy, TOL)
    return [r["group"] for r in res], res[0]["stacked"]


def _same_on_every_rank(results, key):
    x0 = results[0][key][0]
    for r in results[1:]:
        assert np.array_equal(r[key][0], x0)
        assert r[key][1:] == results[0][key][1:]
    return results[0][key]


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


# ---------------------------- comm ----------------------------------- #
X_COMM = np.random.default_rng(12).standard_normal((P, 7, 3))


@functools.lru_cache(maxsize=None)
def _comm_runs():
    return _spawn(rankjobs.comm_ops, X_COMM)


def test_group_comm_matches_stacked_bitwise():
    """Each rank's ring shifts (both ways, the open end zeroed by global
    rank), part-order sum, global dot product and all-gather equal the
    stacked functions' rows bit for bit."""
    t = torch.as_tensor(X_COMM)
    res = _comm_runs()
    for r, got in enumerate(res):
        assert np.array_equal(got["right"], comm.ring_shift(t, 1)[r:r + 1])
        assert np.array_equal(got["left"], comm.ring_shift(t, -1)[r:r + 1])
        assert np.array_equal(got["psum"], comm.psum(t))
        assert got["pdot"] == comm.pdot(t[:, :, 0], t[:, :, 1]).item()
        assert np.array_equal(got["gather"], comm.all_gather(t[:, :, 0]))
    assert not res[0]["right"].any() and not res[-1]["left"].any()


def test_check_same_raises_on_every_rank_when_ranks_drift():
    """``GroupComm.check_same``, which ends every session solve: silent
    when every rank holds the same vector; when the ranks' vectors
    differ, RuntimeError on every rank (so none goes on to a collective
    the others never reach)."""
    for got in _comm_runs():
        assert got["drift"] and "differ" in got["drift"]


# ------------------------ linear solvers ----------------------------- #
def test_band_dd_ranks_match_stacked():
    """The sharded band engine over four ranks: x within 1e-6 of max|x|
    of the stacked engine's (in one process of the same environment),
    CG counts within 1 per refinement pass, every rank the same x."""
    res, want = _ranks_solves()
    x, rel, _it = _same_on_every_rank(res, "band_dd")
    assert rel <= TOL
    _close(x, want["band_dd"][0], 1e-6)
    got, ref = res[0]["band_dd_passes"], want["band_dd_passes"]
    assert len(got) == len(ref)
    assert all(abs(a - b) <= 1 for a, b in zip(got, ref)), (got, ref)
    for r in res:
        assert r["band_dd_passes"] == got


@pytest.mark.parametrize("name", ["jacobi", "schwarz", "csym"])
def test_halo_pcgs_ranks_match_stacked(name):
    """The f64 element-block PCGs over four ranks (Jacobi; the Schwarz
    V-cycle per part with the replicated global coarse solve; the
    complex-symmetric pairs): x within 1e-12 of max|x| of the stacked
    path's (in one process of the same environment), the same iteration
    count, every rank the same x."""
    res, want = _ranks_solves()
    x, rel, it = _same_on_every_rank(res, name)
    xs, rels, its = want[name]
    assert rel <= TOL and rels <= TOL
    _close(x, xs, 1e-12)
    assert it == its


# ------------------------- whole solves ------------------------------ #
@functools.lru_cache(maxsize=None)
def _model_runs():
    tp = tbench.build(3000)
    mesh = tmesher.mesh_problem(tp)      # a rank unpickles only the port
    res = _spawn(rankjobs.model_solve, tp, mesh, ON_CPU["hbm_bytes"])
    stacked = tmodels.solve(tbench.build(3000), mesh, devices=P, **ON_CPU)
    jp = jbench.build(3000)
    jsol = jmag.solve(jp, jmesher.mesh_problem(jp), devices=P)
    return res, stacked, jsol


def test_magnetostatics_ranks_match_stacked_and_jax():
    """The nonlinear 3,000-node benchmark problem with ``devices=4`` over
    four ranks (every linear solve on the sharded band engine): the same
    A on every rank, within 1e-9 of max|A| of the stacked port's and
    1e-6 of the JAX package's ``devices=4`` solve."""
    res, stacked, jsol = _model_runs()
    A = res[0]["A"]
    for r in res:
        assert np.array_equal(r["A"], A)
        assert r["newton"] == res[0]["newton"] > 1
    assert res[0]["residual"] <= tbench.build(3000).Precision
    _close(A, stacked.A, 1e-9)
    _close(A, jsol.A, 1e-6)


def test_group_size_must_equal_devices():
    """``devices=8`` with a group of four ranks raises ValueError on
    every rank, before any collective (the launch then goes on)."""
    res, _stacked, _j = _model_runs()
    for r in res:
        assert r["mismatch"] and "devices=8" in r["mismatch"]


def test_cli_ranks_write_one_file(tmp_path, fixtures):
    """``python -m xfemm_tpu_torch solve --devices 4`` in four ranks, each
    on its own copy of ACwound (the complex-symmetric PCG over the
    ranks): rank 0 alone prints and writes its .ans, equal to the
    stacked CLI's; the other copies get none."""
    argvs = []
    for r in range(P + 1):
        d = tmp_path / f"rank{r}"
        d.mkdir()
        for ext in (".fem", ".node", ".ele", ".edge", ".pbc"):
            shutil.copy(fixtures / f"ACwound{ext}", d / f"ACwound{ext}")
        argvs.append(["solve", str(d / "ACwound.fem"), "--premeshed",
                      "--devices", str(P), "--device", "cpu",
                      "--hbm-bytes", "1e9"])
    res = _spawn(rankjobs.cli, argvs[:P])
    assert [rc for rc, _out in res] == [0] * P
    assert "solved in" in res[0][1]
    assert all(out == "" for _rc, out in res[1:])
    assert [(tmp_path / f"rank{r}" / "ACwound.ans").exists()
            for r in range(P)] == [True] + [False] * (P - 1)
    assert tmain(argvs[P]) == 0
    got = tans.read_ans(str(tmp_path / "rank0" / "ACwound.ans"))
    want = tans.read_ans(str(tmp_path / f"rank{P}" / "ACwound.ans"))
    _close(got.values, want.values, 1e-12)


def test_spawn_reports_a_failing_rank():
    """A rank that raises fails the launch with its traceback, and the
    ranks left waiting in a collective are killed, within the wall
    limit."""
    # rank 3 has no row of a three-part array and raises; ranks 0-2 wait
    # for it in their first collective
    with pytest.raises(RuntimeError, match="rank 3 failed"):
        _spawn(rankjobs.comm_ops, np.zeros((P - 1, 2, 2)))
