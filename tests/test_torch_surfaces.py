"""The port's user surfaces (pyFEMM verbs, Lua femmcli, CLI, session
API, sweeps, exporters, material libraries) against the JAX package's,
on the CPU.

The port's solves run with ``device="cpu"`` and an explicit
``hbm_bytes`` for the band planner; the ``cpu_only`` fixture makes any
use of CUDA, or a planner call without a memory size, fail the test.
The TorqueBenchmark is the canonical end-to-end check: its gap torque
against sin(angle) within the reference's tolerances (4.2e-5 absolute,
0.006% relative; femmcli_TorqueBenchmark.lua:36-64), and within 1e-9 of
the JAX package's torque.
"""

import inspect
import math
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import xfemm_tpu.femm_compat as jfemm
import xfemm_tpu_torch.femm_compat as tfemm
from xfemm_tpu import api as japi
from xfemm_tpu.scripting import lua as jlua
from xfemm_tpu_torch import api as tapi
from xfemm_tpu_torch.scripting import lua as tlua

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
REPO = pathlib.Path(__file__).resolve().parent.parent
HBM = 1e9
ON_CPU = dict(device="cpu", hbm_bytes=HBM)


@pytest.fixture
def cpu_only(monkeypatch):
    """Fail on any CUDA query, and on a band-planner memory read without
    an explicit size."""
    from xfemm_tpu_torch.ops import solver

    def no_cuda(*a, **k):
        raise AssertionError("a CPU run touched CUDA")

    for name in ("is_available", "mem_get_info", "synchronize",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    real = solver.device_hbm_bytes

    def sized(device, hbm=None):
        assert hbm is not None, "device_hbm_bytes reached without a size"
        assert torch.device(device).type == "cpu"
        return real(device, hbm)

    monkeypatch.setattr(solver, "device_hbm_bytes", sized)


def torque_check(tq, deg):
    ref = math.sin(math.radians(deg))
    assert abs(tq - ref) <= 4.2e-5
    if ref:
        assert abs(100 * (tq - ref) / ref) <= 0.006


def femm_torque(femm, deg, **open_kw):
    femm.opendocument(str(FIXTURES / "TorqueBenchmark.fem"), **open_kw)
    femm.mi_modifyboundprop("AGE", 10, deg)   # InnerAngle
    femm.mi_modifyboundprop("AGE", 11, 0)     # OuterAngle
    femm.mi_createmesh()
    femm.mi_analyze()
    femm.mi_loadsolution()
    return femm.mo_gapintegral("AGE", 0)


@pytest.mark.parametrize("deg", [0, 40, 90])
def test_torque_benchmark_verbs(deg, cpu_only):
    tq = femm_torque(tfemm, deg, **ON_CPU)
    torque_check(tq, deg)
    assert abs(tq - femm_torque(jfemm, deg)) <= 1e-9


def test_document_needs_a_device_choice():
    """No card and no device named: the solve fails loudly instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    doc = tapi.open_document(str(FIXTURES / "TorqueBenchmark.fem"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        doc.analyze()
    cpu = tapi.open_document(str(FIXTURES / "TorqueBenchmark.fem"),
                             device="cpu")
    with pytest.raises(ValueError, match="explicit memory size"):
        cpu.analyze()


DOCUMENT_VERBS = ("newdocument", "opendocument", "mi_newdocument",
                  "hi_newdocument", "ei_newdocument")


def public_verbs(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and callable(getattr(mod, n))
            and getattr(getattr(mod, n), "__module__", "") == mod.__name__}


def test_full_verb_parity():
    """Every pyFEMM / femmcli verb of the JAX package exists in the port
    with the same parameters; the verbs that open a document add
    ``device`` and ``hbm_bytes`` after them."""
    jv, tv = public_verbs(jfemm), public_verbs(tfemm)
    assert len(jv) > 250
    assert jv == tv, sorted(jv ^ tv)
    for name in sorted(jv):
        pj = list(inspect.signature(getattr(jfemm, name)).parameters)
        pt = list(inspect.signature(getattr(tfemm, name)).parameters)
        if name in DOCUMENT_VERBS:
            assert pt == pj + ["device", "hbm_bytes"], name
        else:
            assert pt == pj, name


# ------------------------------ Lua --------------------------------- #
@pytest.fixture(params=["jax", "torch"])
def lua(request):
    return {"jax": jlua, "torch": tlua}[request.param]


def run(lua, src, **kw):
    out = []
    lua.run_string(src, output=out.append, **kw)
    return out


def test_language_core(lua):
    out = run(lua, """
        function fib(n)
            if n < 2 then return n end
            return fib(n-1) + fib(n-2)
        end
        t = {}
        for i = 0, 8 do t[i] = fib(i) end
        s = ""
        i = 0
        while t[i] do s = s .. t[i] .. " "; i = i + 1 end
        print(s)
        local a, b = 1, 2
        a, b = b, a
        print(a .. "," .. b)
        print(format("%05.1f|%d|%s", 3.25, 7, "x"))
        n = 10
        repeat n = n - 3 until n < 0
        print(n)
        if nil then print("no") elseif 2 > 1 then print("cmp") end
        print(strsub("hello", 2, 4), strlen("hello"))
    """, bind_femm=False)
    assert out == ["0 1 1 2 3 5 8 13 21 ", "2,1", "003.2|7|x", "-2",
                   "cmp", "ell\t5"]


def test_lua4_semantics(lua):
    out = run(lua, """
        print(1 == 1, 1 == 2)
        x = 1/0
        print(x > 1e300)
        y = 0/0
        if y > 0 or y < 0 or y == 0 then print("bad") else print("nan") end
        print(2^10, mod(7, 3), floor(-1.5), ceil(-1.5))
        print(sin(90), cos(0), atan2(1, 0))  -- degrees like femm
    """, bind_femm=False)
    assert out == ["1\tnil", "1", "nan", "1024\t1\t-2\t-1", "1\t1\t90"]


def test_tables_and_stdlib(lua):
    out = run(lua, """
        t = { 10, 20, x = "y", [99] = 3 }
        print(t[1], t[2], t.x, t[99], getn(t))
        tinsert(t, 30)
        print(t[3], getn(t))
        print(tostring(nil), tostring(12), tonumber("3.5") + 0.5)
    """, bind_femm=False)
    assert out == ["10\t20\ty\t3\t2", "30\t3", "nil\t12\t4"]


def test_compatibility_mode_roundtrip(lua):
    out = []
    interp = lua.Interpreter(bind_femm=False, output=out.append)
    interp.run("""
assert(getcompatibilitymode() == 0)
setcompatibilitymode(1.0)
assert(getcompatibilitymode() == 1)
setcompatibilitymode(0.0)
assert(getcompatibilitymode() == 0)
write("SUCCESS\\n")
""")
    assert out == ["SUCCESS"]


def test_trace_builtin_and_hooks(lua):
    out = run(lua, "function FUN()\n  trace(1)\nend\ntrace()\nFUN()\n",
              bind_femm=False, script_path="t.lua")
    assert any("main [t.lua:0]" in line for line in out)
    assert any("global Lua FUN()" in line for line in out)
    out = run(lua, "x = sqrt(4)\nprint(x)", bind_femm=False,
              trace_calls=True)
    assert any("call global C sqrt()" in line for line in out)
    out = run(lua, "y = unknown_variable_xyz", bind_femm=False,
              pedantic=True)
    assert any("undefined variable" in line for line in out)


def test_init_environment(lua):
    out = run(lua, """
        print(format("%.6e", uo))
        print(format("%.6e", eo))
        assert(Pi == PI); assert(pi == PI)
        assert(inches == 0.0254); assert(cm == 0.01)
        assert(Gauss == 0.0001); assert(kOersted == 1000*Oersted)
        print(format("%.4f", AWG(20)))
        assert(uAx0[1][1] > 10); assert(u2D1[12][12] > 0)
        newdocument(0)
        mi_probdef(0, "centimeters", "planar", 1e-8, 1, 30)
        mi_drawrectangle(-1, -1, 1, 1)
        mi_makeABC()
        write("SUCCESS\\n")
    """)
    assert out[:2] == ["1.256637e-06", "8.854188e-12"]
    assert abs(float(out[2]) - 8.2514694 * math.exp(-0.115943 * 20)) < 1e-3
    assert out[-1] == "SUCCESS"
    femm = jfemm if lua is jlua else tfemm
    names = [m.name for m in femm._d().problem.blockproplist]
    assert [f"u{k}" for k in range(1, 8)] == [n for n in names
                                              if n.startswith("u")]


def test_lua_documents_take_the_interpreters_device():
    """Every verb that opens a document from Lua passes the device and
    memory size the interpreter was given."""
    for verb, kind in (("newdocument(0)", 0), ("mi_newdocument()", 0),
                       ("hi_newdocument()", 1), ("ei_newdocument()", 2),
                       ("newdocument(2)", 1)):
        run(tlua, verb, **ON_CPU)
        doc = tfemm._d()
        assert (doc.device, doc.hbm_bytes) == ("cpu", HBM), verb
        assert doc.problem.filetype == kind, verb
    run(tlua, f'open("{FIXTURES / "TorqueBenchmark.fem"}")', **ON_CPU)
    assert (tfemm._d().device, tfemm._d().hbm_bytes) == ("cpu", HBM)


def test_lua_binds_the_same_globals():
    """The port's interpreter binds the JAX interpreter's globals."""
    gj = jlua.Interpreter(output=lambda s: None).globals
    gt = tlua.Interpreter(output=lambda s: None, **ON_CPU).globals
    assert set(gj) == set(gt)


TORQUE_LUA = """
function check(value, expected, marginAbs)
    if abs(value - expected) > marginAbs then
        return 1
    end
    return 0
end
open("tq.fem")
failed = 0
for deg = 0, 30, 30 do
    mi_modifyboundprop("AGE", 10, deg)
    mi_modifyboundprop("AGE", 11, 0)
    mi_analyze()
    mi_loadsolution()
    tq = mo_gapintegral("AGE", 0)
    print(tq)
    failed = failed + check(tq, sin(deg), 0.000042)
end
assert(failed == 0)
write("SUCCESS\\n")
"""


def test_end_to_end_torque_script(tmp_path, monkeypatch, cpu_only):
    """A femmcli-style script meshes, solves and evaluates the gap
    torque from Lua source alone, on the device the interpreter was
    given; the torques match the JAX interpreter's."""
    monkeypatch.chdir(tmp_path)
    shutil.copy(FIXTURES / "TorqueBenchmark.fem", tmp_path / "tq.fem")
    out = run(tlua, TORQUE_LUA, **ON_CPU)
    assert out[-1] == "SUCCESS"
    assert tfemm._d().device == "cpu"
    ref = run(jlua, TORQUE_LUA)
    for a, b in zip(out[:2], ref[:2]):
        assert abs(float(a) - float(b)) <= 1e-9


# ------------------------------ CLI --------------------------------- #
def port_cli(*args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "xfemm_tpu_torch", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_solve_matches_the_jax_cli(tmp_path):
    from xfemm_tpu.__main__ import main as jmain
    from xfemm_tpu.io import ansfile as jans
    from xfemm_tpu_torch.io import ansfile as tans
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        for ext in (".fem", ".node", ".ele", ".edge", ".pbc"):
            shutil.copy(FIXTURES / f"Temp{ext}", tmp_path / d / f"Temp{ext}")
    proc = port_cli("solve", "Temp.fem", "--premeshed", "--device", "cpu",
                    "--hbm-bytes", str(HBM), cwd=tmp_path / "port")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "solved in" in proc.stdout
    assert jmain(["solve", str(tmp_path / "jax" / "Temp.fem"),
                  "--premeshed"]) == 0
    a = tans.read_ans(str(tmp_path / "port" / "Temp.ans")).values
    b = jans.read_ans(str(tmp_path / "jax" / "Temp.ans")).values
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= 1e-5 * float(np.abs(b).max())


def test_cli_mesh_matches_the_jax_cli(tmp_path):
    from xfemm_tpu.__main__ import main as jmain
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        shutil.copy(FIXTURES / "TorqueBenchmark.fem",
                    tmp_path / d / "tq.fem")
    proc = port_cli("mesh", "tq.fem", cwd=tmp_path / "port")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert jmain(["mesh", str(tmp_path / "jax" / "tq.fem")]) == 0
    for ext in (".node", ".ele", ".edge", ".pbc"):
        assert (tmp_path / "port" / f"tq{ext}").read_text() == \
            (tmp_path / "jax" / f"tq{ext}").read_text(), ext


def test_cli_script_runs_on_the_named_device(tmp_path):
    shutil.copy(FIXTURES / "TorqueBenchmark.fem", tmp_path / "tq.fem")
    (tmp_path / "tq.lua").write_text(TORQUE_LUA)
    proc = port_cli("script", "tq.lua", "--device", "cpu", "--hbm-bytes",
                    str(HBM), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-1] == "SUCCESS"


def test_cli_without_a_card_fails_loudly(tmp_path):
    """``solve`` with no ``--device`` runs on CUDA: without a card it
    fails, and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    shutil.copy(FIXTURES / "TorqueBenchmark.fem", tmp_path / "tq.fem")
    proc = port_cli("solve", "tq.fem", cwd=tmp_path)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "tq.ans").exists()


# --------------------- session API, exporters ----------------------- #
def coil_doc(api):
    doc = api.new_document("magnetics")
    doc.problem.LengthUnits = api.LengthUnit.CENTIMETERS
    doc.problem.Precision = 1e-8
    doc.problem.Depth = 10.0
    doc.add_boundary("A0", BdryFormat=0)
    doc.add_material("Air")
    doc.add_material(api.MagneticMaterial(name="Cu", Cduct=58.0))
    doc.add_circuit("I1", amps=100.0, circuit_type=1)
    n = [doc.add_node(-8, -8), doc.add_node(8, -8), doc.add_node(8, 8),
         doc.add_node(-8, 8)]
    for a, b in zip(n, n[1:] + n[:1]):
        doc.add_segment(a, b, boundary="A0")
    c = [doc.add_node(-1, -2), doc.add_node(1, -2), doc.add_node(1, 2),
         doc.add_node(-1, 2)]
    for a, b in zip(c, c[1:] + c[:1]):
        doc.add_segment(a, b)
    doc.add_block_label(5, 5, material="Air")
    doc.add_block_label(0, 0, material="Cu", circuit="I1", turns=20)
    return doc


def edit(api, doc):
    """Crossing segments, copy-rotate, mirror, scale and a library
    material on top of the coil document."""
    a, b = doc.add_node(2, 0), doc.add_node(4, 0)
    doc.add_segment(a, b)
    doc.add_segment(doc.add_node(3, -1), doc.add_node(3, 1))
    doc.copy_rotate(0, 0, 90, copies=3)
    doc.mirror(0, 0, 1, 0)
    doc.scale(0, 0, 1.5)
    doc.add_material("M-19 Steel")
    return doc


def dumped(doc, path):
    doc.save(str(path))
    return path.read_text()


def test_api_editing_dumps_equal(tmp_path):
    dj = edit(japi, coil_doc(japi))
    dt = edit(tapi, coil_doc(tapi))
    assert len(dt.problem.nodelist) > 8
    assert dumped(dt, tmp_path / "t.fem") == dumped(dj, tmp_path / "j.fem")


def test_api_analyze_and_circuit(cpu_only):
    dt = coil_doc(tapi)
    dt.device, dt.hbm_bytes = "cpu", HBM
    st = dt.analyze()
    sj = coil_doc(japi).analyze()
    amps, volts, flux = st.circuit_properties("I1")
    ja, jv, jf = sj.circuit_properties("I1")
    assert amps == ja == 100.0
    assert abs(volts - jv) <= 1e-9 * abs(jv)
    assert abs(flux - jf) <= 1e-5 * abs(jf)
    assert st.select_blocks_at((0.0, 0.0)) == {1}
    assert st.post.device == "cpu"


def test_solution_save_reads_back(tmp_path, cpu_only):
    from xfemm_tpu_torch.io import ansfile
    doc = tapi.open_document(str(FIXTURES / "TorqueBenchmark.fem"),
                             **ON_CPU)
    sol = doc.analyze()
    sol.save(str(tmp_path / "tq.ans"))
    back = ansfile.read_ans(str(tmp_path / "tq.ans"))
    assert np.array_equal(back.values, sol.raw.A)


def test_exporters_equal(tmp_path):
    from xfemm_tpu.geometry import femfile as jfemfile
    from xfemm_tpu.mesh import mesher as jmesher
    from xfemm_tpu.utils import export as jexport
    from xfemm_tpu_torch.geometry import femfile as tfemfile
    from xfemm_tpu_torch.mesh import mesher as tmesher
    from xfemm_tpu_torch.utils import export as texport
    path = str(FIXTURES / "TorqueBenchmark.fem")
    pj, pt = jfemfile.load(path), tfemfile.load(path)
    assert texport.to_tikz(pt, width_mm=100) == \
        jexport.to_tikz(pj, width_mm=100)
    assert texport.to_freecad(pt) == jexport.to_freecad(pj)
    jexport.to_elmer(jmesher.mesh_problem(pj), pj, str(tmp_path / "j"))
    texport.to_elmer(tmesher.mesh_problem(pt), pt, str(tmp_path / "t"))
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for n in names:
        assert (tmp_path / "t" / n).read_text() == \
            (tmp_path / "j" / n).read_text(), n


def test_plotting_renders(cpu_only):
    import matplotlib
    matplotlib.use("Agg")
    from xfemm_tpu_torch.geometry import femfile
    from xfemm_tpu_torch.io import ansfile
    from xfemm_tpu_torch.mesh.meshdata import read_mesh_files
    from xfemm_tpu_torch.utils import plotting
    p = femfile.load(str(FIXTURES / "AxiSolenoid.fem"))
    assert plotting.plot_problem(p).lines
    mesh = read_mesh_files(str(FIXTURES / "AxiSolenoid"))
    ax = plotting.plot_mesh(mesh)
    assert ax.lines or ax.collections
    g = ansfile.read_ans(str(FIXTURES / "Temp.ans.golden"))
    from xfemm_tpu_torch.post.fpproc import MagPostProcessor
    pp = MagPostProcessor(g.problem, g.mesh, g.values, g.label_case,
                          device="cpu")
    assert plotting.plot_B(pp, quiver_step=40).collections
    assert plotting.plot_flux_lines(g.mesh, g.values).collections
    assert plotting.plot_density(g.mesh, np.abs(g.values)).collections


# ------------------- material libraries, sweeps --------------------- #
def test_builtin_libraries_equal():
    from xfemm_tpu.constants import FileType as JFT
    from xfemm_tpu.materials import library as jlib
    from xfemm_tpu_torch.constants import FileType as TFT
    from xfemm_tpu_torch.materials import library as tlib
    data = REPO / "xfemm_tpu_torch" / "data"
    for stem in ("matlib", "heatlib", "statlib", "condlib", "abc_mu"):
        assert (data / f"{stem}.json").read_bytes() == \
            (REPO / "xfemm_tpu" / "data" / f"{stem}.json").read_bytes()
    for kind in ("MAGNETICS", "HEATFLOW", "ELECTROSTATICS"):
        lj, lt = jlib.builtin(JFT[kind]), tlib.builtin(TFT[kind])
        assert len(lt) > 5, kind
        assert list(lt) == list(lj)
        for name in lj:
            assert tlib.material_to_dict(lt[name]) == \
                jlib.material_to_dict(lj[name]), name


def test_sweep_checkpoint_resume(tmp_path, monkeypatch, cpu_only):
    from xfemm_tpu_torch.geometry import femfile
    from xfemm_tpu_torch.mesh import mesher
    from xfemm_tpu_torch.models import magnetostatics
    from xfemm_tpu_torch.post.fpproc import MagPostProcessor
    from xfemm_tpu_torch.utils import sweep

    solves = []
    real = magnetostatics.solve

    def counted(*a, **kw):
        solves.append(kw)
        return real(*a, **kw)

    def build(deg):
        p = femfile.load(str(FIXTURES / "TorqueBenchmark.fem"))
        for bp in p.lineproplist:
            if bp.is_airgap():
                bp.InnerAngle = deg
        return p, mesher.mesh_problem(p)

    def torque(sol):
        return MagPostProcessor(sol.problem, sol.mesh, sol.A,
                                sol.label_case,
                                device="cpu").gap_dc_torque("AGE")

    angles = [0.0, 10.0, 20.0]
    ck = str(tmp_path / "ck")
    monkeypatch.setattr(magnetostatics, "solve", counted)
    r1 = sweep.sweep(angles[:2], build, torque, checkpoint=ck,
                     solve_kwargs=ON_CPU)
    assert len(solves) == 2 and solves[1]["x0_A"] is not None
    assert all(s["device"] == "cpu" for s in solves)
    solves.clear()
    r2 = sweep.sweep(angles, build, torque, checkpoint=ck,
                     solve_kwargs=ON_CPU)
    assert len(solves) == 1
    solves.clear()
    r3 = sweep.sweep(angles, build, torque, checkpoint=ck,
                     solve_kwargs=ON_CPU)
    assert solves == [] and r3 == r2
    for a in angles[:2]:
        assert r2[a] == r1[a]
    for a in angles:
        torque_check(float(r2[a]), a)
