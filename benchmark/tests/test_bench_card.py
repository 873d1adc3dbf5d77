"""Each cell of BENCHMARK.json on the card, a short window: its answers
come out correct. Skips without a CUDA card."""

import time

import pytest

from benchmark import run, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell, card):
    out, window = run.run_cell(cell, 2 ** 31 + 3, 10.0, False,
                               t0=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["device"]["platform"] == "gpu"
    assert window.requests
