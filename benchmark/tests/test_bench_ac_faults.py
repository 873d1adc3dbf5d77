"""A whole run of ``ac125k.freq`` on the CPU at ~3700 nodes (the look for
a card skipped), once sound and once with the timed path broken
underneath, through the harness's own window and judged sample: the
sound run comes out correct, each broken one not.

The faults are ``test_bench_faults``'s, with ``unchanged`` taken to the
AC path: every complex solve after the first hands back its starting
state (the Dirichlet values, zero elsewhere) as converged. ``altered``,
``altered_some`` and ``stale`` are theirs as they stand.
"""

import time

import numpy as np
import pytest
from test_bench_faults import _altered, _altered_some, _stale

from benchmark import run

CELL = "ac125k.freq"
SMALL = {"target_nodes": 3000, "skin_freq": 10.0}


def _run(seconds=4.0):
    return run.run_cell(CELL, 2 ** 31 + 77, seconds, False, device="cpu",
                        hbm_bytes=2e9, override=SMALL,
                        t0=time.perf_counter())[0]


def _unchanged(monkeypatch):
    from xfemm_tpu_torch.ops import solver
    real = solver.solve_complex
    calls = []

    def solve_complex(blocks, b, fixed_mask, fixed_vals, tol, **kw):
        calls.append(1)
        if len(calls) == 1:
            return real(blocks, b, fixed_mask, fixed_vals, tol, **kw)
        x = np.where(fixed_mask, np.asarray(fixed_vals, complex), 0.0)
        return x, 0.0, 0

    monkeypatch.setattr(solver, "solve_complex", solve_complex)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert out["checks"]["gap"]["value"] > 0.0


@pytest.mark.parametrize("fault", [_unchanged, _altered, _altered_some,
                                   _stale],
                         ids=["unchanged", "altered", "altered_some",
                              "stale"])
def test_broken_run_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    # ``altered_some`` alters the third solve, the warm-up's included
    assert out["attempted"] >= (2 if fault is _altered_some else 1)
    assert not out["correct"], out["checks"]
