"""The models' mesh bookkeeping of the PyTorch port against the JAX
package, bit for bit, on the CPU: ``magnetostatics.build_prolongation``
(the signed union-find of (anti)periodic pairs and the numbering of its
reduced DOFs) and ``heatflow.decode_markers`` (the node / edge marker
decoding of the heat and electrostatic models, edge conductors written
to their end nodes, the last edge winning), and the conductor
prolongation composed of both. The JAX package keeps the per-node and
per-edge loops; the port's array versions must give the same values of
the same dtypes.
"""

import types
from pathlib import Path

import numpy as np
import pytest

from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.mesh import mesher as jmesher
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import heatflow as jheat
from xfemm_tpu.models import magnetostatics as jmag
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.models import heatflow as theat
from xfemm_tpu_torch.models import magnetostatics as tmag

FIXTURES = Path(__file__).parent / "fixtures"


def _same(ours, theirs):
    """Equal values, dtypes and shapes; a Python int as a Python int."""
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        if isinstance(t, np.ndarray):
            assert isinstance(o, np.ndarray)
            assert o.dtype == t.dtype and o.shape == t.shape
            assert np.array_equal(o, t)
        else:
            assert type(o) is type(t) and o == t


def _random_pairs(seed: int):
    """A seeded (anti)periodic pair set over n nodes: chains of pairs in
    both directions, pairs a == b, repeated pairs, pairs that close a
    cycle (their roots already coincide), and random pairs, shuffled."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 3000))
    rows = []
    for _ in range(int(rng.integers(3, 12))):
        length = int(rng.integers(2, 40))
        chain = rng.choice(n, length, replace=False)
        for a, b in zip(chain[:-1], chain[1:]):
            rows.append((a, b) if rng.random() < 0.5 else (b, a))
        rows.append((chain[-1], chain[0]))          # roots coincide
    for a in rng.integers(0, n, 5):
        rows.append((a, a))                         # a == b
    k = int(rng.integers(10, n // 2))
    rows += list(zip(rng.integers(0, n, k), rng.integers(0, n, k)))
    pairs = np.array([(a, b, rng.integers(0, 2)) for a, b in rows],
                     np.int64)
    pairs = np.concatenate([pairs, pairs[rng.integers(0, len(pairs), 20)]])
    return n, pairs[rng.permutation(len(pairs))]


def _prolongation_case(case):
    if case == "none-249469":
        return 249_469, np.zeros((0, 3), np.int64)
    if case.startswith("random-"):
        return _random_pairs(int(case.split("-")[1]))
    mesh = jread_mesh(str(FIXTURES / case))
    assert len(mesh.pbc_pairs)
    return len(mesh.nodes), mesh.pbc_pairs


@pytest.mark.parametrize("case", ["none-249469"]
                         + [f"random-{s}" for s in (1, 2, 3, 4, 5, 1700000101)]
                         + ["Temp", "AntiperiodicFluxRefMesh"])
def test_build_prolongation_matches_jax(case):
    """(ridx, rsign, nreduced) of the port equal the JAX package's: no
    pairs at the 250k benchmark's size, seeded random pair sets, and the
    periodic (Temp) and antiperiodic fixtures' own pairs."""
    n, pairs = _prolongation_case(case)
    theirs = jmag.build_prolongation(n, pairs)
    ours = tmag.build_prolongation(n, pairs)
    _same(ours, theirs)
    assert ours[0].dtype == np.int64 and ours[1].dtype == np.float64
    assert ours[2] < n if len(pairs) else ours[2] == n


def _synthetic_mesh(seed: int):
    """A marker-only mesh: nodes with and without a point property and a
    conductor, edges with no marker, a boundary alone or a conductor, in
    scattered order, and a few hub nodes touched by conductor edges of
    different conductors from both ends."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 800))
    ne = int(rng.integers(n, 4 * n))
    edges = rng.integers(0, n, (ne, 2))
    hubs = rng.choice(n, 4, replace=False)
    for h in hubs:
        at = rng.choice(ne, 6, replace=False)
        edges[at, rng.integers(0, 2, 6)] = h
    pp = rng.integers(0, 5, n)
    cond = rng.integers(0, 4, n)
    node_markers = np.where(rng.random(n) < 0.4, 0,
                            (cond << 16) | (pp + 1)).astype(np.int32)
    bdry = rng.integers(0, 5, ne)
    econd = rng.integers(0, 6, ne)
    kind = rng.random(ne)
    edge_markers = np.where(kind < 0.3, 0, -((econd << 16) | (bdry + 1)))
    edge_markers = np.where(kind > 0.9, -(bdry + 2), edge_markers)
    return types.SimpleNamespace(node_markers=node_markers,
                                 edge_markers=edge_markers.astype(np.int32),
                                 edges=edges)


def _conductor_problems(circ_type: int):
    """HeatTemp0 in both packages with a conductor on the segment from
    (1, 0.5) to (1.5, 0.5), as tests/test_torch_heatflow.py builds it,
    and the JAX package's mesh of it."""
    import xfemm_tpu.geometry.problem as jprob
    import xfemm_tpu_torch.geometry.problem as tprob
    out = []
    for P, load in ((jprob, jfemfile.load), (tprob, tfemfile.load)):
        p = load(str(FIXTURES / "HeatTemp0.feh"))
        p.circproplist = [P.Conductor(name="c", V=500.0, q=50.0,
                                      CircType=circ_type)]
        p.linelist[8].InConductor = 0
        out.append(p)
    return out[0], out[1], jmesher.mesh_problem(out[0])


def _marker_case(case):
    """(JAX problem, port problem, mesh); no problems for a synthetic
    mesh."""
    if case.startswith("synthetic-"):
        return None, None, _synthetic_mesh(int(case.split("-")[1]))
    if case == "ElecTest":
        return (jfemfile.load(str(FIXTURES / "ElecTest.fee")),
                tfemfile.load(str(FIXTURES / "ElecTest.fee")),
                jread_mesh(str(FIXTURES / "ElecTest")))
    return _conductor_problems(int(case.rsplit("-", 1)[1]))


@pytest.mark.parametrize("case", [f"synthetic-{s}"
                                  for s in (1, 2, 3, 4, 5, 1700000101)]
                         + ["heat-conductor-1", "heat-conductor-0",
                            "ElecTest"])
def test_decode_markers_matches_jax(case):
    """Every array of ``decode_markers`` equals the JAX package's (values
    and dtype) on synthetic meshes and on the heat and electrostatic
    conductor fixtures; on the fixtures the conductor prolongation built
    from them too."""
    jp, tp, mesh = _marker_case(case)
    theirs = jheat.decode_markers(mesh)
    ours = theat.decode_markers(mesh)
    _same(ours, theirs)
    edge_cond = theirs[3]
    assert (edge_cond >= 0).any()
    if jp is None:
        assert len(np.unique(edge_cond[edge_cond >= 0])) > 1
        return
    n = len(mesh.nodes)
    _same(theat.conductor_prolongation(n, mesh.pbc_pairs, ours[1],
                                       tp.circproplist),
          jheat.conductor_prolongation(n, mesh.pbc_pairs, theirs[1],
                                       jp.circproplist))
