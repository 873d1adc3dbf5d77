"""Tests of the benchmark harness. They run on the CPU at small sizes;
those marked ``card`` need a CUDA card and skip without one."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def small_params():
    """(problem module, parameters) of each configuration at ~3000 nodes."""
    from benchmark import spec
    bench = spec.load_benchmark()
    out = []
    for c in bench["configs"]:
        config = spec.config(bench, c["name"])
        params = dict(config["params"], target_nodes=3000)
        out.append((spec.problem(config["problem"]), params))
    return out
