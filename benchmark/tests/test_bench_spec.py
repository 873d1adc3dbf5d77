"""BENCHMARK.json keeps to the benchmark's contract, and everything it
names resolves by name to a file of the harness."""

import json
import math
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = spec.load_benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entries_keep_their_keys_and_limits():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:
        assert spec.metrics_for(BENCH, w, "per_layer")
        assert len(spec.metrics_for(BENCH, w, "end_to_end")) >= 2


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    w = spec.cell(BENCH, cell)
    config = spec.config(BENCH, w["config"])
    assert config["name"] == w["config"]
    mod = spec.problem(config["problem"])
    for fn in ("build", "reference", "answer", "judge", "region_areas",
               "label_points", "max_area", "fixed_nodes"):
        assert callable(getattr(mod, fn))
    t = spec.traffic(w["traffic"])
    assert set(t["vary"]) | set(t.get("set", {})) <= set(config["params"])
    for kind in ("end_to_end", "per_layer"):
        for m in spec.metrics_for(BENCH, cell, kind):
            assert callable(spec.metric(m["name"]).read)


def test_kernel_roles_resolve():
    for role in ("operator_apply", "bt_sweep"):
        entries = spec.kernel_role(role)
        assert entries and all(set(e) == {"pattern", "kernel", "regex"}
                               for e in entries)
    names = {"operator_apply": "void band_mv_ring<float, 1>(float const*)",
             "bt_sweep": "void fwd_kernel<float>(float const*)"}
    for role, kernel in names.items():
        assert any(e["regex"].search(kernel)
                   for e in spec.kernel_role(role))
    assert not any(e["regex"].search("void qbwd_kernel<float, 2>()")
                   for e in spec.kernel_role("operator_apply"))


def test_a_new_traffic_file_is_found(tmp_path):
    """A mix added beside the others is found by its name alone."""
    shutil.copytree(spec.HERE / "traffic", tmp_path / "traffic")
    with open(tmp_path / "traffic" / "new_mix.json", "w") as f:
        json.dump({"mesh": "once", "vary": {"J": [0.5, 1.0]}}, f)
    t = spec.traffic("new_mix", base=tmp_path)
    assert t["vary"]["J"] == [0.5, 1.0]
    assert spec.traffic("current_sweep", base=tmp_path) == \
        spec.traffic("current_sweep")


def test_configs_keep_the_published_sizes():
    for c in BENCH["configs"]:
        config = spec.config(BENCH, c["name"])
        assert c["reduced"] == config["reduced"] == []
        assert not math.isnan(config["params"]["precision"])
