"""Finds everything a cell needs by the names in ``BENCHMARK.json``:

- a configuration: the JSON file its entry names (``configs/<name>.json``),
  whose ``problem`` names a module of ``problems/``;
- a traffic mix: ``traffic/<mix>.json``;
- a metric: ``metrics/<name>.py``, whose ``read(run)`` returns the number
  or None where it finds nothing to read;
- a kernel role: every ``kernel_roles/<role>/*.json`` entry.

Adding a cell, a configuration, a mix, a metric or a kernel name means
adding files and entries; none of these files names another.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, base: pathlib.Path = HERE) -> dict:
    with open(base / "traffic" / f"{name}.json") as f:
        return json.load(f)


def problem(name: str):
    """The module of ``problems/`` that builds and judges a problem."""
    return importlib.import_module(f"{__package__}.problems.{name}")


def metric(name: str):
    """The reader module of a metric, loaded from ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics._{re.sub(r'[^0-9A-Za-z_]', '_', name)}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_role(role: str) -> list:
    """The entries of a kernel role: {"pattern": regex over kernel names,
    "kernel": what it is}; each matching event is one launch of the
    role."""
    out = []
    for path in sorted((HERE / "kernel_roles" / role).glob("*.json")):
        with open(path) as f:
            entry = json.load(f)
        entry["regex"] = re.compile(entry["pattern"])
        out.append(entry)
    return out


def metrics_for(bench: dict, cell_name: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that the cell
    reports: those whose ``workloads`` list it, or that have none."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
