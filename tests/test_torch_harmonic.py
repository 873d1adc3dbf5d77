"""AC harmonic magnetics of the PyTorch port (planar and axisymmetric)
against the reference's golden solutions and the JAX package, on the
CPU.

The port runs ``models.solve`` with ``device="cpu"`` and an explicit
``hbm_bytes``; above 2,048 unknowns it takes its f32 (re, im) band
engine (GMRES on the Ar and Ai bands with the shifted-real factor), as
on the card. The JAX package's CPU default is its complex128 CG
(``_csym_loop``, taken where the device holds f64), a different engine:
both are held to the golden ``.ans`` and to each other at 1e-6 of
max|A|, and the per-label circuit results to the golden's as the JAX
tests check them. The port vectorises the JAX model's per-element
circuit loops; ``test_circuit_terms_equal_the_loops`` holds them to a
transcription of those loops.
"""

import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from xfemm_tpu import models as jmodels
from xfemm_tpu.geometry import femfile as jfemfile
from xfemm_tpu.io import ansfile as jans
from xfemm_tpu.mesh.meshdata import read_mesh_files as jread_mesh
from xfemm_tpu.models import benchprob as jbench
from xfemm_tpu_torch import models as tmodels
from xfemm_tpu_torch.geometry import femfile as tfemfile
from xfemm_tpu_torch.io import ansfile as tans
from xfemm_tpu_torch.mesh.meshdata import read_mesh_files as tread_mesh
from xfemm_tpu_torch.models import benchprob as tbench
from xfemm_tpu_torch.models import harmonic as tharm
from xfemm_tpu_torch.models import magnetostatics as tmag
from xfemm_tpu_torch.ops import assembly as tasm
from xfemm_tpu_torch.ops import solver as tsolver
from xfemm_tpu_torch.post.fpproc import MagPostProcessor

from test_torch_axisymmetric import cpu_only  # noqa: F401  (fixture)

HBM = 1e9
ON_CPU = dict(device="cpu", hbm_bytes=HBM)
AC = ["ACtest", "ACwound", "ACaxi", "ACaxi400"]

torch.set_num_threads(1)


def solve_both(fixtures, stem):
    p = tfemfile.load(str(fixtures / f"{stem}.fem"))
    mesh = tread_mesh(str(fixtures / stem))
    sol = tmodels.solve(p, mesh, **ON_CPU)
    jsol = jmodels.solve(jfemfile.load(str(fixtures / f"{stem}.fem")),
                         jread_mesh(str(fixtures / stem)))
    return p, mesh, sol, jsol


def check_golden(fixtures, stem, mesh, A, label_case):
    g = tans.read_ans(str(fixtures / f"{stem}.ans.golden"))
    d, idx = cKDTree(mesh.nodes).query(g.mesh.nodes)
    assert d.max() < 1e-12
    scale = np.abs(g.values).max()
    assert np.abs(A[idx] - g.values).max() / scale < 1e-6
    assert np.allclose(label_case, g.label_case, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("stem", AC)
def test_ac_fixture_matches_golden_and_jax(fixtures, stem, cpu_only):
    """Each AC fixture through ``models.solve``: the contract residual,
    the golden A and label cases, and the JAX package's solution and
    label cases at 1e-6."""
    tsolver._CBAND_CACHE.clear()
    p, mesh, sol, jsol = solve_both(fixtures, stem)
    assert sol.residual <= p.Precision and np.isfinite(sol.A).all()
    check_golden(fixtures, stem, mesh, sol.A, sol.label_case)
    scale = np.abs(jsol.A).max()
    assert np.abs(sol.A - jsol.A).max() <= 1e-6 * scale
    assert np.allclose(sol.label_case, jsol.label_case, rtol=1e-6,
                       atol=1e-12)
    # above 2,048 unknowns the band engine ran and was not latched off
    assert any(v is not None for v in tsolver._CBAND_CACHE.values())


def test_ac_wound_region_integrals(fixtures, cpu_only):
    """The port's postprocessor on the port's ACwound solution: the
    reference femmcli mo_blockintegral values the JAX test asserts."""
    p, mesh, sol, _ = solve_both(fixtures, "ACwound")
    post = MagPostProcessor(p, mesh, sol.A, sol.label_case, device="cpu")
    coil = {k for k, l in enumerate(post.labels)
            if abs(l.x) < 1e-9 and abs(l.y) < 1e-9}
    assert len(coil) == 1
    approx = pytest.approx
    assert post.block_integral(2, coil).real == \
        approx(1.273529694319e-04, rel=2e-4)       # stored energy
    assert post.block_integral(17, coil).real == \
        approx(1.273529694319e-04, rel=2e-4)       # coenergy
    assert post.block_integral(4, coil).real == \
        approx(1.097620254739e+00, rel=2e-4)       # resistive losses
    assert post.block_integral(0, coil) == approx(
        4.848451777805e-03 - 5.719153002085e-04j, rel=2e-4)
    assert post.block_integral(7, coil).real == approx(1e3, rel=1e-6)


#: femmcli on ACaxi400.ans.golden (tests/test_harmonicaxi.py)
REF_ACAXI400 = {
    "coil_loss": 0.04983725541655186,
    "coil_AJ": 0.0002097635444444539 - 1.413972146981966e-05j,
    "coil_energy": 7.636042497783758e-06,
    "rod_loss": 0.01608316784427291,
    "rod_J": -82.09176867385763 - 66.38030996460395j,
    "circ_volts": -0.000240362959638525 + 0.005195904737962252j,
    "circ_flux": 1.963352852159631e-06 + 4.47608640949693e-07j,
}


def test_ac_axi_series_circuit_properties(fixtures, cpu_only):
    """ACaxi400 (400 Hz, a series circuit: circuit Case 2) solved by the
    port: the series coil resolves to Case 2 with a nonzero dV, and the
    block integrals and circuit properties match the reference
    postprocessor's values for the golden solution at 1e-5."""
    p, mesh, sol, _ = solve_both(fixtures, "ACaxi400")
    assert sol.label_case[2][0] == pytest.approx(0.0)
    assert abs(sol.label_case[2][1]) > 1e-5
    post = MagPostProcessor(p, mesh, sol.A, sol.label_case, device="cpu")

    def close(got, exp, tol=1e-5):
        assert got == pytest.approx(exp, rel=tol,
                                    abs=1e-12 + tol * abs(exp))

    close(complex(post.block_integral(4, {2})).real,
          REF_ACAXI400["coil_loss"])
    close(complex(post.block_integral(0, {2})), REF_ACAXI400["coil_AJ"])
    close(complex(post.block_integral(2, {2})).real,
          REF_ACAXI400["coil_energy"])
    close(complex(post.block_integral(4, {1})).real,
          REF_ACAXI400["rod_loss"])
    close(complex(post.block_integral(7, {1})), REF_ACAXI400["rod_J"])
    amps, volts, flux = post.circuit_properties("I1")
    close(complex(amps), 100 + 30j)
    close(complex(volts), REF_ACAXI400["circ_volts"])
    close(complex(flux), REF_ACAXI400["circ_flux"])


def loop_terms(p, mesh, axi: bool):
    """The JAX package's per-element circuit loops (models/harmonic.py
    :146-258 and :455-470, models/harmonicaxi.py :70-175 and :295-304),
    transcribed: (case, circJ, Jv, case-2 b_extra, case-2 coupling
    entries (node DOFs, slot, K), label cases before the solve)."""
    pk = tmag.pack(p, mesh)
    geom = (tasm.axi_geometry if axi else tasm.tri_geometry)(pk.xy, pk.tris)
    area = np.asarray(geom.area)
    R = np.asarray(geom.R) if axi else np.ones_like(area)
    labels = [l for l in p.labellist if not l.is_hole()]
    mats = p.blockproplist
    T = pk.tris.shape[0]
    w = p.Frequency * 2.0 * np.pi
    is_wound = [abs(l.Turns) > 1 or mats[l.BlockType].LamType > 2
                for l in labels]
    sigma_raw = np.array([mats[labels[i].BlockType].Cduct for i in pk.lbl])
    sigma_circ = np.where(np.array(is_wound)[pk.lbl], 0.0, sigma_raw)
    Jc = pk.Jre + 1j * pk.Jim
    nc = len(pk.circuits)
    case = np.zeros(nc, np.int64)
    circJ = np.zeros(nc, complex)
    circdV = np.zeros(nc, complex)
    i1 = np.zeros(nc)
    i2 = np.zeros(nc)
    i3 = np.zeros(nc, complex)
    for e in range(T):
        ci = pk.circuit[e]
        if ci >= 0:
            i1[ci] += area[e]
            i2[ci] += area[e] * sigma_circ[e] / ((0.01 * R[e]) if axi
                                                 else 1.0)
            i3[ci] += Jc[e] * area[e] * 100.0
    for k, circ in enumerate(pk.circuits):
        if circ.CircType == 0:
            if i2[k] == 0:
                case[k] = 1
                circJ[k] = 0.0 if i1[k] == 0 else \
                    0.01 * (complex(circ.Amps) - i3[k]) / i1[k]
            else:
                case[k] = 2
        else:
            case[k] = 0
            circdV[k] = complex(circ.dVolts)
    slot = {k: pk.nreduced + j
            for j, k in enumerate([k for k in range(nc) if case[k] == 2])}
    Jv = np.zeros(T, complex)
    b2 = np.zeros(pk.nreduced + len(slot), complex)
    coupling = []
    for e in range(T):
        ci = pk.circuit[e]
        if ci < 0:
            continue
        if case[ci] == 1:
            Jv[e] = circJ[ci]
        elif case[ci] == 0:
            Jv[e] = -circdV[ci] * sigma_raw[e] * (100.0 / R[e] if axi
                                                   else 1.0)
        else:
            if axi:
                b2[slot[ci]] += 3.0 * (2.0 * Jc[e] * area[e] / 3.0)
                K = 2j * area[e] * w * sigma_raw[e] * tmag.C_APOT
                coupling.append((pk.ridx[pk.tris[e]], slot[ci], K, K / R[e]))
            else:
                b2[slot[ci]] += -3.0 * (-(Jc[e]) * area[e] / 3.0)
                K = 1j * area[e] * w * sigma_raw[e] * tmag.C_APOT
                coupling.append((pk.ridx[pk.tris[e]], slot[ci], K, K))
    label_case = np.zeros((len(labels), 2), complex)
    for k in range(len(labels)):
        ci = -1
        for e in (range(T - 1, -1, -1) if axi else range(T)):
            if pk.lbl[e] == k:
                ci = pk.circuit[e]
                break
        if ci < 0:
            label_case[k] = (1, 0.0)
        elif case[ci] == 1:
            label_case[k] = (1, circJ[ci])
        else:
            label_case[k] = (0, circdV[ci])
    return pk, area, R, case, circJ, Jv, b2, coupling, label_case


@pytest.mark.parametrize("stem", ["ACtest", "ACwound", "ACaxi400"])
def test_circuit_terms_equal_the_loops(fixtures, stem):
    """The vectorised circuit code of ``models/harmonic.py`` (shared by
    ``harmonicaxi``) equals the JAX model's per-element loops: the case
    selection, each element's source density, the case-2 right-hand
    side and coupling blocks (to 1e-14: scalar and array complex
    products round differently), and each label's (case, value)."""
    p = tfemfile.load(str(fixtures / f"{stem}.fem"))
    mesh = tread_mesh(str(fixtures / stem))
    axi = stem.startswith("ACaxi")
    pk, area, R, case, circJ, Jv, b2, coupling, lc = loop_terms(p, mesh, axi)
    w = p.Frequency * 2.0 * np.pi
    ac = tharm.ACSetup(p, pk, area, w, 1.0 / (0.01 * R) if axi else 1.0)
    assert np.array_equal(ac.case, case) and np.array_equal(ac.circJ, circJ)
    assert (ac.case == 2).any() == bool(coupling)
    assert np.array_equal(
        tharm._circuit_source(pk, ac, 100.0 / R if axi else 1.0), Jv)
    got = np.zeros(ac.ntot, complex)
    sel = ac.c2_el
    slots = ac.case2_slot[pk.circuit[sel]]
    if axi:
        np.add.at(got, slots, 3.0 * (2.0 * ac.Jc_block[sel] * area[sel] / 3.0))
        K = 2j * area * w * ac.sigma_raw * tmag.C_APOT
        blocks = tharm._c2_blocks(pk, ac, K, K / R)
    else:
        np.add.at(got, slots, -3.0 * (-(ac.Jc_block[sel]) * area[sel] / 3.0))
        K = 1j * area * w * ac.sigma_raw * tmag.C_APOT
        blocks = tharm._c2_blocks(pk, ac, K, K)
    assert np.allclose(got, b2, rtol=1e-14, atol=0.0)
    if coupling:
        (blk,) = blocks
        assert len(blk.idx) == len(coupling)
        for row, (nodes, slot, Kc, Kd) in enumerate(coupling):
            assert np.array_equal(blk.idx[row], list(nodes) + [slot])
            assert np.isclose(blk.mat[row, 0, 3], Kc / 3.0, rtol=1e-14)
            assert np.isclose(blk.mat[row, 3, 3], Kd, rtol=1e-14)
    else:
        assert blocks == []
    assert np.array_equal(tharm._label_case(pk, ac, first=not axi), lc)


def test_build_ac_matches_jax():
    """``benchprob.build_ac`` field by field against the JAX package's:
    the problem settings, every material, boundary, point property,
    node, segment, arc and block label."""
    for n in (10_000, 125_000):
        a, b = tbench.build_ac(n), jbench.build_ac(n)
        for name in ("filetype", "Frequency", "Precision", "MinAngle",
                     "Depth", "LengthUnits", "ProblemType", "DoSmartMesh"):
            assert getattr(a, name) == getattr(b, name), name
        for la, lb in (("blockproplist", "blockproplist"),
                       ("lineproplist", "lineproplist"),
                       ("nodeproplist", "nodeproplist"),
                       ("nodelist", "nodelist"), ("linelist", "linelist"),
                       ("arclist", "arclist"), ("labellist", "labellist")):
            xs, ys = getattr(a, la), getattr(b, lb)
            assert len(xs) == len(ys)
            for x, y in zip(xs, ys):
                assert vars(x) == vars(y), (la, vars(x), vars(y))
        steel = a.blockproplist[1]
        assert (steel.mu_x, steel.Cduct, steel.BHpoints) == (1000.0, 2.0, 0)
        assert a.Frequency == 50.0


def test_dispatch_raises_only_for_heat_and_electrostatics(fixtures,
                                                          monkeypatch):
    """``models.solve`` routes all six problem families to the port's
    models -- planar and axisymmetric magnetostatics, planar and
    axisymmetric AC, heat flow and electrostatics -- with the keyword
    arguments passed on, and raises for none of them (the heat-flow and
    electrostatics raise is gone; only an unknown file type raises)."""
    from xfemm_tpu_torch.models import (axisymmetric, electrostatics,
                                        harmonic, harmonicaxi, heatflow,
                                        magnetostatics)

    routed = []
    mods = (axisymmetric, electrostatics, harmonic, harmonicaxi, heatflow,
            magnetostatics)
    for mod in mods:
        monkeypatch.setattr(mod, "solve",
                            lambda p, m, _n=mod.__name__, **kw:
                            routed.append((_n.split(".")[-1], kw)))
    for name in ("Temp.fem", "AxiSolenoid.fem", "ACtest.fem", "ACaxi.fem",
                 "HeatTemp0.feh", "ElecTest.fee"):
        tmodels.solve(tfemfile.load(str(fixtures / name)), None,
                      device="cpu", hbm_bytes=1e9)
    assert [r[0] for r in routed] == [
        "magnetostatics", "axisymmetric", "harmonic", "harmonicaxi",
        "heatflow", "electrostatics"]
    assert all(r[1] == dict(device="cpu", hbm_bytes=1e9) for r in routed)
    p = tfemfile.load(str(fixtures / "Temp.fem"))
    p.filetype = None
    with pytest.raises(ValueError, match="unsupported problem type"):
        tmodels.solve(p, None)


def test_ac_through_the_verbs_matches_jax(fixtures, cpu_only):
    """ACtest through ``femm_compat`` (open, mesh, ``mi_analyze``, the
    steel's resistive losses and the copper's circuit properties) in
    the port on the CPU and in the JAX package: the same mesher, so the
    same mesh; the results within 1e-6 relative."""
    import xfemm_tpu.femm_compat as jfemm
    import xfemm_tpu_torch.femm_compat as tfemm

    out = {}
    for name, femm, kw in (("port", tfemm, ON_CPU), ("jax", jfemm, {})):
        femm.opendocument(str(fixtures / "ACtest.fem"), **kw)
        femm.mi_createmesh()
        femm.mi_analyze()
        femm.mi_loadsolution()
        femm.mo_selectblock(3.5, 0.0)
        loss = complex(femm.mo_blockintegral(4))
        femm.mo_clearblock()
        out[name] = (loss, *map(complex, femm.mo_getcircuitproperties("I1")))
    for a, b in zip(out["port"], out["jax"]):
        assert abs(a - b) <= 1e-6 * abs(b), (a, b)
    assert out["port"][0].real > 0.0


def test_ac_cli_solve_matches_golden(fixtures, tmp_path):
    """``python -m xfemm_tpu_torch solve ACtest.fem --premeshed --device
    cpu``: its .ans, read back by the port's ``io/ansfile``, lies on the
    fixture mesh and matches ACtest.ans.golden at 1e-6 of max|A|."""
    import pathlib
    repo = pathlib.Path(__file__).resolve().parent.parent
    for ext in (".fem", ".node", ".ele", ".edge", ".pbc"):
        shutil.copy(fixtures / f"ACtest{ext}", tmp_path / f"ACtest{ext}")
    proc = subprocess.run(
        [sys.executable, "-m", "xfemm_tpu_torch", "solve", "ACtest.fem",
         "--premeshed", "--device", "cpu", "--hbm-bytes", str(HBM)],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "PYTHONPATH": str(repo)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "solved in" in proc.stdout
    g = tans.read_ans(str(tmp_path / "ACtest.ans"))
    mesh = tread_mesh(str(fixtures / "ACtest"))
    assert np.abs(g.mesh.nodes - mesh.nodes).max() < 1e-9
    check_golden(fixtures, "ACtest", mesh, g.values, g.label_case)
    jg = jans.read_ans(str(fixtures / "ACtest.ans.golden"))
    assert np.iscomplexobj(g.values) and np.iscomplexobj(jg.values)


def test_build_ac_solve_matches_jax(cpu_only):
    """The ac125k problem at 10k target nodes (the card's main AC path,
    cut in depth only): meshed by the port, solved through
    ``models.solve`` on the port's band engine with the factor, against
    the JAX package's solve of the same mesh at 1e-6 of max|A|."""
    from xfemm_tpu_torch.mesh import mesher

    tsolver._CBAND_CACHE.clear()
    p = tbench.build_ac(10_000)
    mesh = mesher.mesh_problem(p)
    sol = tmodels.solve(p, mesh, **ON_CPU)
    (ent,) = tsolver._CBAND_CACHE.values()
    assert ent is not None and ent["bt"] is not None
    jsol = jmodels.solve(jbench.build_ac(10_000), mesh)
    assert sol.residual <= p.Precision
    scale = np.abs(jsol.A).max()
    assert np.abs(sol.A - jsol.A).max() <= 1e-6 * scale
