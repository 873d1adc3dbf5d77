"""Previous-solution inputs and the solution file: the port's own
``io/ansfile.py`` against the JAX package's (the same text written, a
write/read round trip), the previous solution's element B and the
incremental / frozen permeability tensors, and the static linear-limit
identity of tests/test_chaining.py: with an exactly linear B-H curve
(mu_r = 500) the incremental (PrevType 1) and frozen (2) permeabilities
about any solution equal mu_r, so a [PrevSoln] solve matches the
genuinely linear twin."""

import numpy as np
import pytest
import torch

from xfemm_tpu.constants import MU0
from xfemm_tpu.io import ansfile as jans
from xfemm_tpu.materials.magnetic import MagneticMaterial as JMaterial
from xfemm_tpu.mesh import mesher as jmesher
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu.models import magnetostatics as jmag
from xfemm_tpu_torch.io import ansfile as tans
from xfemm_tpu_torch.materials.magnetic import MagneticMaterial as TMaterial
from xfemm_tpu_torch.models import benchprob as tbench
from xfemm_tpu_torch.models import magnetostatics as tmag
from xfemm_tpu_torch.ops import solver as tsolver

MUR = 500.0
HBM = 16e9

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_caches():
    for cache in (tsolver._BAND_CACHE, jmag._PACK_CACHE, tmag._PACK_CACHE):
        cache.clear()
    yield
    for cache in (tsolver._BAND_CACHE, jmag._PACK_CACHE, tmag._PACK_CACHE):
        cache.clear()


@pytest.fixture(scope="module")
def mesh():
    return jmesher.mesh_problem(jbench.build(2500))


def _linear_steel(build, material, twin):
    """benchprob.build(2500) whose steel has an exactly linear B-H curve
    (``twin``: the linear material itself)."""
    p = build(2500)
    if twin:
        p.blockproplist[1] = material(name="Steel", mu_x=MUR, mu_y=MUR)
        return p
    steel = p.blockproplist[1]
    steel.Bdata, steel.Hdata, steel.slope = [], [], []
    for b in (0.0, 0.5, 1.0, 1.5, 2.0, 2.5):
        steel.Bdata.append(b)
        steel.Hdata.append(complex(b / (MU0 * MUR)))
    return p


@pytest.mark.parametrize("source", ["golden", "solver"])
def test_write_ans_text_equals_jax(fixtures, tmp_path, mesh, source):
    """The same solution written by both packages gives the same text
    (the reference's Temp.ans.golden as read, and a solver-style file
    from the benchprob mesh with random nodal values); the port reads
    its own file back exactly."""
    if source == "golden":
        jsf = jans.read_ans(str(fixtures / "Temp.ans.golden"))
        tsf = tans.read_ans(str(fixtures / "Temp.ans.golden"))
    else:
        vals = np.random.default_rng(5).standard_normal(mesh.num_nodes)
        lc = np.array([[1, 0.0], [0, 2.5e-3], [1, 0.0], [1, 0.0]])
        jsf = jans.SolutionFile(
            problem=jbench.build(2500), values=vals, label_case=lc,
            mesh=jans.solution_mesh_from_solver(mesh, 1.0))
        tsf = tans.SolutionFile(
            problem=tbench.build(2500), values=vals, label_case=lc,
            mesh=tans.solution_mesh_from_solver(mesh, 1.0))
    jpath, tpath = tmp_path / "j.ans", tmp_path / "t.ans"
    jans.write_ans(jsf, str(jpath))
    tans.write_ans(tsf, str(tpath))
    assert tpath.read_text() == jpath.read_text()
    back = tans.read_ans(str(tpath))
    assert np.array_equal(back.values, tsf.values)
    assert np.array_equal(back.mesh.nodes, tsf.mesh.nodes)
    assert np.array_equal(back.mesh.elements, tsf.mesh.elements)
    assert np.array_equal(back.label_case, tsf.label_case)


def test_prev_element_B_and_incremental_mu_match_jax(mesh):
    """Element B of a previous solution (planar) and the incremental /
    frozen permeability tensors of the nonlinear steel about it, to
    1e-12 relative."""
    A = np.random.default_rng(6).standard_normal(mesh.num_nodes) * 1e-2
    jp, tp = jbench.build(2500), tbench.build(2500)
    jB = jmag.prev_element_B(jp, mesh, A)
    tB = tmag.prev_element_B(tp, mesh, A)
    for a, b in zip(tB, jB):
        assert np.allclose(a, b, rtol=1e-12, atol=0)
    for ptype in (1, 2):
        jp.PrevType = tp.PrevType = ptype
        jk = jmag.pack(jp, mesh)
        tk = tmag.pack(tp, mesh)
        jmu = jmag.incremental_mu(jp, jk, *jB, jp.blockproplist)
        tmu = tmag.incremental_mu(tp, tk, *tB, tp.blockproplist)
        for a, b in zip(tmu, jmu):
            assert np.allclose(a, b, rtol=1e-12, atol=1e-300)
        assert (tmu[2] != 0).any() == (ptype == 1)


def test_static_prevsoln_linear_limit(tmp_path, mesh):
    """Chain a static solve from a written .ans (PrevType 1 and 2) on the
    linear-curve steel: one linear pass whose A matches the linear twin
    to 1e-6 of max|A| and the JAX package's chained solve to 1e-5."""
    base = _linear_steel(tbench.build, TMaterial, twin=False)
    sol = tmag.solve(base, mesh, device="cpu", hbm_bytes=HBM)
    path = tmp_path / "base.ans"
    tans.write_ans(tans.SolutionFile(
        problem=base, mesh=tans.solution_mesh_from_solver(mesh, 1.0),
        values=sol.A, label_case=sol.label_case), str(path))
    lin = tmag.solve(_linear_steel(tbench.build, TMaterial, twin=True),
                     mesh, device="cpu", hbm_bytes=HBM)
    scale = np.abs(lin.A).max()
    for ptype in (1, 2):
        q = _linear_steel(tbench.build, TMaterial, twin=False)
        q.PrevSoln, q.PrevType = str(path), ptype
        inc = tmag.solve(q, mesh, device="cpu", hbm_bytes=HBM)
        assert inc.newton_iterations == 1 and inc.residual <= 1e-8
        assert np.abs(inc.Aprev - sol.A).max() <= 1e-15 * np.abs(sol.A).max()
        assert np.abs(inc.A - lin.A).max() <= 1e-6 * scale
        jq = _linear_steel(jbench.build, JMaterial, twin=False)
        jq.PrevSoln, jq.PrevType = str(path), ptype
        jinc = jmag.solve(jq, mesh)
        assert np.abs(inc.A - jinc.A).max() <= 1e-5 * scale
