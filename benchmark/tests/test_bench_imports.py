"""The harness imports neither JAX nor the JAX package, the reference
imports nothing of the program, and nothing the harness runs reads the
older JAX-side measurement files."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "xfemm_tpu"}


def top_level_imports(path: pathlib.Path) -> set:
    """Top-level module names (before the first dot) a file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_names_are_compared_whole():
    """The port's name starts with the JAX package's: it is not caught."""
    src = "import xfemm_tpu_torch.models\nfrom xfemm_tpu_torch import api\n"
    p = pathlib.Path(__file__).with_name("_probe_source.txt")
    try:
        p.write_text(src)
        assert top_level_imports(p) == {"xfemm_tpu_torch"}
        p.write_text("import xfemm_tpu.models\n")
        assert top_level_imports(p) & FORBIDDEN == {"xfemm_tpu"}
    finally:
        p.unlink()


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "xfemm_tpu_torch" not in top_level_imports(path)
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reads_no_jax_side_measurements(path):
    text = path.read_text()
    for name in ("bench.py", ".bench_cache", "chip_smoke", "perf/",
                 "BENCH_r0", "MULTICHIP_r0"):
        assert name not in text
