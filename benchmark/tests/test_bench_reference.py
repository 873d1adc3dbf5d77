"""The plain reference against the reference fsolver's own answer, and
the comparison that decides ``correct`` against its control.

``Temp`` (tests/fixtures, premeshed) exercises the B-H Newton, periodic
pairs, a Dirichlet boundary and series circuits; its golden solution was
written by the unmodified fsolver and is held here to its fixture's
tolerance, 1e-5 of max|A|. The control is the reference itself in
float32 throughout; the judge (one float64 Newton correction) must read
it above each configuration's limit, and the program's own answer below.
"""

import pathlib

import numpy as np
import pytest
from scipy.spatial import cKDTree

from benchmark import spec
from benchmark.reference import bh, fem, heatflow, magnetostatic

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures"


def _temp_problem():
    """Temp.fem on its premeshed files, as the reference's arrays (read
    with the program's file readers; the reference takes plain arrays)."""
    from xfemm_tpu_torch.geometry import femfile
    from xfemm_tpu_torch.mesh.meshdata import read_mesh_files

    p = femfile.load(str(FIXTURES / "Temp.fem"))
    mesh = read_mesh_files(str(FIXTURES / "Temp"))
    labels = [lab for lab in p.labellist if not lab.is_hole()]
    lbl = mesh.element_labels
    mats = p.blockproplist
    blk = np.array([lab.BlockType for lab in labels])[lbl]
    curves, index = [], np.full(len(mats), -1)
    for i, m in enumerate(mats):
        assert m.LamType in (0, 1, 3) and m.LamFill == 1.0
        if m.Bdata:
            index[i] = len(curves)
            curves.append(bh.Curve(m.Bdata, [complex(h).real
                                             for h in m.Hdata]))
    # wound (LamType 3) regions are air to the field
    mu = np.array([1.0 if m.LamType == 3 else m.mu_x for m in mats])
    _b, _c, area = fem.gradients(mesh.nodes, mesh.elements)
    J = np.array([1e6 * complex(m.J).real for m in mats])[blk]
    for k, lab in enumerate(labels):
        if lab.InCircuit >= 0:
            circ = p.circproplist[lab.InCircuit]
            assert circ.CircType == 1      # series: amps x turns / area
            sel = lbl == k
            J[sel] += complex(circ.Amps).real * lab.Turns / area[sel].sum()
    fixed = np.zeros(mesh.num_nodes, bool)
    for (a, b), mk in zip(mesh.edges, mesh.edge_markers):
        if mk < 0 and p.lineproplist[-(int(mk) + 2)].BdryFormat == 0:
            bp = p.lineproplist[-(int(mk) + 2)]
            assert bp.A0 == bp.A1 == bp.A2 == 0
            fixed[[a, b]] = True
    prob = magnetostatic.Magnetostatic(
        xy=mesh.nodes, tris=mesh.elements, mu_r=mu[blk], curve=index[blk],
        J=J, Hc=np.array([m.H_c for m in mats])[blk],
        magdir=np.array([lab.MagDir for lab in labels])[lbl], fixed=fixed,
        fixed_vals=np.zeros(mesh.num_nodes), curves=curves,
        pairs=mesh.pbc_pairs)
    return prob, mesh


def test_reference_reproduces_temp_golden():
    from xfemm_tpu_torch.io import ansfile

    prob, mesh = _temp_problem()
    A, _steps = magnetostatic.solve(prob)
    g = ansfile.read_ans(str(FIXTURES / "Temp.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-12
    Ag = np.real(g.values)
    assert np.abs(A[idx] - Ag).max() / np.abs(Ag).max() < 1e-05
    # the judge reads the golden's distance from the reference's answer
    golden = np.zeros_like(A)
    golden[idx] = Ag
    err = np.abs(golden - A).max() / np.abs(A).max()
    assert magnetostatic.gap(prob, golden) == pytest.approx(err, rel=0.05)


def test_fold_signs():
    dof, sgn, m = fem.fold(4, [(0, 1, 0), (2, 3, 1), (1, 2, 1)])
    assert m == 1
    # v0 = v1, v2 = -v3, v1 = -v2
    v = sgn * 1.0
    assert v[0] == v[1] and v[1] == -v[2] and v[2] == -v[3]


#: sizes at which the float32 control already reads above the limit (the
#: control is host arithmetic, a float32 sparse LU; for heat230k it read
#: 2.5e-6 at 28,565 nodes, 6.0e-5 at 71,407 and 3.1e-5 to 7.4e-5 at the
#: full 326,956)
SIZES = {"mag250k": 20000, "heat230k": 50000}


def _small(name):
    bench = spec.load_benchmark()
    config = spec.config(bench, name)
    params = dict(config["params"], target_nodes=SIZES[name])
    mod = spec.problem(config["problem"])
    from xfemm_tpu_torch.mesh import mesher
    mesh = mesher.mesh_problem(mod.build(params))
    return config, mod, params, mesh


@pytest.mark.parametrize("name", ["mag250k", "heat230k"])
def test_control_fails_and_program_passes(name):
    """On the CPU at SIZES: the float32 reference reads above the
    configuration's limit, the program's answer below it."""
    from xfemm_tpu_torch import models

    config, mod, params, mesh = _small(name)
    ref = mod.reference(params, mesh.nodes, mesh.elements,
                        mesh.element_labels)
    solve = magnetostatic.solve if name == "mag250k" else heatflow.solve
    x32, _ = solve(ref, dtype=np.float32)
    limit = config["limits"]["gap"]
    assert mod.judge(ref, x32) > limit
    sol = models.solve(mod.build(params), mesh, device="cpu",
                       hbm_bytes=2e9)
    assert mod.judge(ref, mod.answer(sol)) < limit
