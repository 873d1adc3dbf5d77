"""The traffic generator's draws repeat exactly for a seed, and every
seed offers the same strata in another order."""

import numpy as np
import pytest

from benchmark import spec
from benchmark.traffic import Traffic

SEEDS = [0, 7, 2 ** 31 + 12345, 2 ** 33 + 1]


@pytest.mark.parametrize("mix", ["current_sweep", "source_sweep",
                                 "new_geometry"])
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_repeat_for_a_seed(mix, seed):
    a = Traffic(spec.traffic(mix), seed)
    b = Traffic(spec.traffic(mix), seed)
    assert [a.request(i) for i in range(40)] == \
        [b.request(i) for i in range(40)]
    assert a.check_sample(17, 5) == b.check_sample(17, 5)
    picked = a.check_sample(17, 5)
    assert len(set(picked)) == 5 and all(0 <= i < 17 for i in picked)
    assert a.check_sample(3, 5) == [0, 1, 2]


@pytest.mark.parametrize("mix", ["current_sweep", "source_sweep",
                                 "new_geometry"])
def test_every_cycle_takes_every_stratum(mix):
    t = Traffic(spec.traffic(mix), 99)
    k = t.strata
    for name, (lo, hi) in t.vary.items():
        for c in range(3):
            vals = np.array([t.request(c * k + j)[name] for j in range(k)])
            assert ((vals >= lo) & (vals < hi)).all()
            strata = np.floor((vals - lo) / (hi - lo) * k).astype(int)
            assert sorted(strata) == list(range(k))


def test_seeds_differ_in_order():
    a = Traffic(spec.traffic("current_sweep"), 1)
    b = Traffic(spec.traffic("current_sweep"), 2)
    assert [a.request(i)["J"] for i in range(16)] != \
        [b.request(i)["J"] for i in range(16)]


def test_set_parameters_pass_through():
    t = Traffic(spec.traffic("new_geometry"), 5)
    assert t.request(3)["J"] == 2.0
    assert t.per_request_mesh
    assert not Traffic(spec.traffic("current_sweep"), 5).per_request_mesh


def test_unknown_keys_are_refused():
    with pytest.raises(ValueError):
        Traffic({"mesh": "once", "rate": 3}, 1)
