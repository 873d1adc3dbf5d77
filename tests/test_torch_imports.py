"""The PyTorch port stands alone: no module of ``xfemm_tpu_torch``, and
not ``chip_smoke.py``, imports jax or the JAX package ``xfemm_tpu``."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, runpy, sys
sys.path.insert(0, {root!r})
import xfemm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    xfemm_tpu_torch.__path__, "xfemm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path({smoke!r}, run_name="chip_smoke_probe")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "xfemm_tpu" or m.startswith("xfemm_tpu."))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    code = _PROBE.format(root=str(ROOT), smoke=str(ROOT / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.split()
    assert int(out[0]) >= 20          # every module was imported
    assert out[1] == "[]", out


def test_no_import_statement_names_jax():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|xfemm_tpu)\b",
                     re.M)
    files = list((ROOT / "xfemm_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert hits == []


def test_slice2_modules_stand_alone():
    """The host AMG helpers (``ops.amg``, the port's own copy) and the
    fused symmetric kernel's binding (``kernels.band_sym``, source
    ``ops/csrc/band_sym.cu``) import without jax or the JAX package."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from xfemm_tpu_torch.ops import amg, kernels
assert kernels.SOURCES["band_sym"] == "band_sym.cu"
assert "band_sym" in kernels.LAUNCHES
assert callable(kernels.band_sym) and callable(amg.scaled_inv)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "xfemm_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.strip()
    assert out == "[]", out
    assert (ROOT / "xfemm_tpu_torch" / "ops" / "csrc" / "band_sym.cu") \
        .is_file()


#: the postprocessors and user surfaces (slice 7), each the port's own
#: copy of the JAX package's module of the same name
SLICE7 = ["materials.library", "geometry.editor", "mesh.renumber",
          "models", "models.harmonic", "post.fpproc", "post.scalarproc",
          "utils.export", "utils.plotting", "utils.sweep", "api",
          "femm_compat", "scripting.lua", "scripting.initenv", "__main__"]


def test_slice7_modules_stand_alone():
    """Every module of the postprocessor and user-surface slice imports
    without jax or the JAX package, and ships its data files."""
    code = f"""
import importlib, sys
sys.path.insert(0, {str(ROOT)!r})
for name in {SLICE7!r}:
    importlib.import_module("xfemm_tpu_torch." + name)
from xfemm_tpu_torch.materials import library
assert len(library.builtin()) > 100
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "xfemm_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.strip()
    assert out == "[]", out
    for name in SLICE7:
        path = ROOT / "xfemm_tpu_torch" / (name.replace(".", "/") + ".py")
        if not path.exists():
            path = path.with_suffix("") / "__init__.py"
        assert path.is_file(), name


#: axisymmetric magnetostatics and AC harmonic solves (slice 8)
SLICE8 = ["models.axisymmetric", "models.harmonic", "models.harmonicaxi",
          "models.benchprob", "ops.assembly", "ops.solver", "ops.band",
          "convert"]


def test_slice8_modules_stand_alone():
    """The axisymmetric and AC modules import without jax or the JAX
    package and carry the solvers the slice ports."""
    code = f"""
import importlib, sys
sys.path.insert(0, {str(ROOT)!r})
mods = {{n: importlib.import_module("xfemm_tpu_torch." + n)
        for n in {SLICE8!r}}}
assert callable(mods["models.axisymmetric"].solve)
assert callable(mods["models.harmonicaxi"].solve)
assert callable(mods["models.benchprob"].build_ac)
assert callable(mods["ops.assembly"].axi_curl_matrices)
assert callable(mods["ops.solver"].solve_complex)
assert callable(mods["ops.band"].band_csym_fgmres_fused)
assert callable(mods["convert"].cband_entry)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "xfemm_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.strip()
    assert out == "[]", out


def test_parallel_modules_stand_alone():
    """The domain decomposition (``xfemm_tpu_torch.parallel``: partition,
    comm, halo, schwarz, band_dd, driver) imports without jax or the JAX
    package, and the models reach it."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from xfemm_tpu_torch.parallel import (band_dd, comm, driver, halo,
                                      partition, schwarz)
from xfemm_tpu_torch.models import magnetostatics
assert magnetostatics.dd_driver is driver
assert callable(driver.DistributedSession) and callable(comm.ring_shift)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "xfemm_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.strip()
    assert out == "[]", out


def test_dist_modules_stand_alone():
    """The multi-process communicator (``parallel.comm``'s
    ``GroupComm``), the process-group setup (``parallel.launch``) and
    the ranks' bodies (``parallel.rankjobs``, what a spawned rank
    imports) load without jax or the JAX package, and importing them
    starts no process group."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import torch.distributed as dist
from xfemm_tpu_torch.parallel import comm, launch, rankjobs
assert callable(launch.spawn) and callable(launch.init_from_env)
assert comm.STACKED.lockstep is False and comm.GroupComm.lockstep is True
assert callable(rankjobs.linear_solves) and not dist.is_initialized()
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "xfemm_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.strip()
    assert out == "[]", out
