"""The port's postprocessors (``xfemm_tpu_torch/post``) against the JAX
package's, call for call, on the reference's golden solution files read
by each package's own ``io/ansfile.read_ans``.

The host code is a copy, so every result is held to 1e-12 relative (of
the largest magnitude compared). The one device step, the weighted-
stress-tensor mask's Laplace solve (``make_mask``), differs in
arithmetic: the JAX CPU reference solves it in f64, the port in f32 CG
under host f64 refinement to 1e-8, so masks are held to 1e-7 of their
maximum (1) (see ``test_make_mask_and_stress_tensor_force`` for the
reference's own solve error) and the forces computed from each
package's own mask to 1e-6 relative. The block integrals that read the
mask (18-23) are compared at 1e-12 with one mask given to both
postprocessors.
"""

import math
import pathlib

import numpy as np
import pytest

from xfemm_tpu.io import ansfile as jans
from xfemm_tpu.post import fpproc as jfp
from xfemm_tpu.post import scalarproc as jsp
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.io import ansfile as tans
from xfemm_tpu_torch.mesh import mesher as tmesher
from xfemm_tpu_torch.models import magnetostatics as tmag
from xfemm_tpu_torch.post import fpproc as tfp
from xfemm_tpu_torch.post import scalarproc as tsp

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
REL = 1e-12
MAG_FILES = ["Temp.ans.golden", "AxiSolenoid.ans.golden",
             "ACtest.ans.golden", "ACwound.ans.golden", "ACaxi.ans.golden"]
#: block integral types of fpproc.block_integral (higher ones raise)
BLOCK_TYPES = range(0, 27)


def assert_close(got, ref, rel=REL, what=""):
    """Recursive comparison of postprocessor results (numbers, complex
    numbers, arrays, tuples, dicts) within ``rel`` of the largest
    reference magnitude."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            assert_close(got[k], ref[k], rel, f"{what}[{k}]")
        return
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close(g, r, rel, f"{what}[{i}]")
        return
    g = np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape, what
    scale = float(np.abs(r).max()) if r.size else 0.0
    err = float(np.abs(g - r).max()) if r.size else 0.0
    assert err <= rel * scale or err == 0.0, (what, err, scale)


def call_both(fn_j, fn_t):
    """Both calls' results, or both calls' exception types."""
    try:
        ref = fn_j()
    except (NotImplementedError, KeyError, ValueError,
            ZeroDivisionError) as e:
        with pytest.raises(type(e)):
            fn_t()
        return None, None
    return fn_t(), ref


def mag_pair(name):
    path = str(FIXTURES / name)
    gj, gt = jans.read_ans(path), tans.read_ans(path)
    pj = jfp.MagPostProcessor(gj.problem, gj.mesh, gj.values, gj.label_case)
    pt = tfp.MagPostProcessor(gt.problem, gt.mesh, gt.values, gt.label_case,
                              device="cpu")
    return pj, pt


def sample_points(mesh, k=3):
    """Centroids of k elements spread over the mesh (inside it)."""
    T = mesh.num_elements
    idx = [int(i) for i in np.linspace(0, T - 1, k)]
    return [tuple(mesh.nodes[mesh.elements[t]].mean(axis=0)) for t in idx]


def contour(mesh):
    """A closed rectangle at 30-60% of the mesh's bounding box."""
    lo, hi = mesh.nodes.min(axis=0), mesh.nodes.max(axis=0)
    a = lo + 0.3 * (hi - lo)
    b = lo + 0.6 * (hi - lo)
    return [(a[0], a[1]), (b[0], a[1]), (b[0], b[1]), (a[0], b[1]),
            (a[0], a[1])]


@pytest.fixture(scope="module", params=MAG_FILES)
def mag(request):
    return mag_pair(request.param)


def test_mag_geometry_and_B(mag):
    pj, pt = mag
    for k in ("B1", "B2", "da", "area_m2", "ctr", "blk", "magdir"):
        assert_close(getattr(pt, k), getattr(pj, k), what=k)
    assert_close(pt.nodal_B(), pj.nodal_B(), what="nodal_B")
    assert_close(pt.element_JA(), pj.element_JA(), what="element_JA")


def test_mag_block_integrals(mag):
    pj, pt = mag
    labels = set(range(len(pj.labels)))
    sel = {1} if len(pj.labels) > 1 else {0}
    # one mask for both, so types 18-23 compare the host code alone
    mask = np.linspace(0.0, 1.0, pj.mesh.num_nodes)
    pj._mask = mask
    pt._mask = mask.copy()
    n = 0
    for t in BLOCK_TYPES:
        for s in (sel, labels):
            got, ref = call_both(lambda: pj.block_integral(t, s),
                                 lambda: pt.block_integral(t, s))
            if ref is not None:
                assert_close(got, ref, what=f"block {t} {s}")
                n += 1
    assert n >= 40


def test_mag_points_lines_circuits(mag):
    pj, pt = mag
    for x, y in sample_points(pj.mesh):
        assert_close(pt.get_point_values(x, y), pj.get_point_values(x, y),
                     what=f"point {x},{y}")
    pj.smoothing = pt.smoothing = False
    for x, y in sample_points(pj.mesh):
        assert_close(pt.get_point_values(x, y), pj.get_point_values(x, y),
                     what=f"unsmoothed point {x},{y}")
    pj.smoothing = pt.smoothing = True
    c = contour(pj.mesh)
    for t in range(6):
        got, ref = call_both(lambda: pj.line_integral(t, c),
                             lambda: pt.line_integral(t, c))
        if ref is not None:
            assert_close(got, ref, what=f"line {t}")
    for circ in pj.problem.circproplist:
        assert_close(pt.circuit_properties(circ.name),
                     pj.circuit_properties(circ.name), what=circ.name)


@pytest.fixture(scope="module")
def torque_pair():
    """The TorqueBenchmark at 40 degrees solved by the port on the CPU;
    the same A given to both postprocessors (no golden file carries an
    air-gap element)."""
    prob = tfemfile.load(str(FIXTURES / "TorqueBenchmark.fem"))
    for b in prob.lineproplist:
        if b.name == "AGE":
            b.InnerAngle, b.OuterAngle = 40.0, 0.0
    mesh = tmesher.mesh_problem(prob)
    sol = tmag.solve(prob, mesh, device="cpu", hbm_bytes=1e9)
    pt = tfp.MagPostProcessor(prob, mesh, sol.A, sol.label_case,
                              device="cpu")
    from xfemm_tpu.geometry import femfile as jfemfile
    from xfemm_tpu.mesh import mesher as jmesher
    jprob = jfemfile.load(str(FIXTURES / "TorqueBenchmark.fem"))
    for b in jprob.lineproplist:
        if b.name == "AGE":
            b.InnerAngle, b.OuterAngle = 40.0, 0.0
    jmesh = jmesher.mesh_problem(jprob)
    np.testing.assert_array_equal(jmesh.nodes, mesh.nodes)
    pj = jfp.MagPostProcessor(jprob, jmesh, sol.A, sol.label_case)
    return pj, pt


def test_gap_integrals(torque_pair):
    pj, pt = torque_pair
    for t in range(7):
        got, ref = call_both(lambda: pj.gap_integral("AGE", t),
                             lambda: pt.gap_integral("AGE", t))
        if ref is not None:
            assert_close(got, ref, what=f"gap {t}")
    tq = pt.gap_integral("AGE", 0)
    assert abs(tq - math.sin(math.radians(40.0))) <= 4.2e-5
    for hj, ht in zip(pj.age, pt.age):
        for k in ("nh", "brc", "brs", "btc", "bts", "br", "bt", "aco"):
            assert_close(getattr(ht, k), getattr(hj, k), what=k)


def test_mask_bcs_equal_the_jax_loops(monkeypatch):
    """The port's vectorised Dirichlet set of the mask is the JAX
    package's per-element loops' set, node for node (the JAX solve is
    replaced by a stand-in that records its arguments)."""
    from xfemm_tpu.ops import solver as jsolver
    pj, pt = mag_pair("Temp.ans.golden")
    seen = {}

    def record(blocks, b, fixed, vals, tol, **kw):
        seen["fixed"] = np.asarray(fixed)
        seen["vals"] = np.asarray(vals)
        return np.zeros(len(b)), 0.0, 0

    monkeypatch.setattr(jsolver, "solve", record)
    for sel in ({1}, {3, 4}, {0}):
        pj.make_mask(sel)
        fixed, vals = pt._mask_bcs(sel)
        np.testing.assert_array_equal(fixed, seen["fixed"])
        np.testing.assert_array_equal(vals, seen["vals"])


def exact_mask(post, sel):
    """The mask system solved directly (scipy, f64) from the port's
    Dirichlet set, which ``test_mask_bcs_equal_the_jax_loops`` holds
    equal to the JAX package's."""
    import scipy.sparse.linalg as spl

    from xfemm_tpu_torch.ops import assembly, solver
    mesh = post.mesh
    tris = mesh.elements
    fixed, vals = post._mask_bcs(sel)
    Mx, My, _ = assembly.curl_matrices(
        assembly.tri_geometry(mesh.nodes, tris))
    A = solver.blocks_to_csr([solver.ElementBlock(
        idx=tris, sign=np.ones(tris.shape), mat=-(Mx + My))],
        mesh.num_nodes)
    free = ~fixed
    x = vals.copy()
    x[free] = spl.spsolve(A[free][:, free].tocsc(),
                          -(A[free][:, fixed] @ vals[fixed]))
    return x


def test_make_mask_and_stress_tensor_force():
    """make_mask on Temp (steel, label 1). The port's mask lies within
    1e-7 of the mask's maximum from the exact solution of the same
    system, and within 1e-7 of the JAX package's beyond the JAX mask's
    own distance from the exact solution: both solves stop at a 1e-8
    residual metric, which bounds the residual, not the error, and the
    JAX f64 Jacobi CG stops ~1.2e-7 from the exact mask here while the
    port's f32 CG under host f64 refinement ends below 1e-9. The
    weighted-stress-tensor force and torque from each package's own
    mask agree within 1e-6 relative."""
    pj, pt = mag_pair("Temp.ans.golden")
    mj = pj.make_mask({1})
    mt = pt.make_mask({1})
    x = exact_mask(pt, {1})
    top = float(np.abs(mj).max())
    assert mt.shape == mj.shape and top == 1.0
    assert float(np.abs(mt - x).max()) <= 1e-7 * top
    own = float(np.abs(mj - x).max())
    assert float(np.abs(mt - mj).max()) <= 1e-7 * top + own
    pj._mask, pt._mask = mj, mt
    for t in (18, 19, 22):
        ref = pj.block_integral(t, {1})
        got = pt.block_integral(t, {1})
        assert abs(got - ref) <= 1e-6 * abs(ref), (t, got, ref)


def scalar_pair(name, cls_j, cls_t):
    path = str(FIXTURES / name)
    gj, gt = jans.read_ans(path), tans.read_ans(path)
    return (cls_j(gj.problem, gj.mesh, np.real(gj.values)),
            cls_t(gt.problem, gt.mesh, np.real(gt.values)))


@pytest.mark.parametrize("name,kind", [("HPTemp0.anh", "Heat"),
                                       ("EPtest.res", "Elec")])
@pytest.mark.parametrize("smoothing", [True, False])
def test_scalar_postprocessors(name, kind, smoothing):
    pj, pt = scalar_pair(name, getattr(jsp, kind + "PostProcessor"),
                         getattr(tsp, kind + "PostProcessor"))
    pj.smoothing = pt.smoothing = smoothing
    labels = set(range(len(pj.problem.labellist)))
    for t in range(6):
        for s in ({0}, labels):
            got, ref = call_both(lambda: pj.block_integral(t, s),
                                 lambda: pt.block_integral(t, s))
            if ref is not None:
                assert_close(got, ref, what=f"block {t} {s}")
    for x, y in sample_points(pj.mesh):
        assert_close(pt.get_point_values(x, y), pj.get_point_values(x, y),
                     what=f"point {x},{y}")
    c = contour(pj.mesh)
    for t in range(4):
        assert_close(pt.line_integral(t, c), pj.line_integral(t, c),
                     what=f"line {t}")
