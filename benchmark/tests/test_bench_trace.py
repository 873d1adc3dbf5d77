"""The trace reduction on made-up profiler events: busy time as a union
of device intervals, idle gaps split by the innermost open phase, kernel
events by role and request."""

import re

from torch.autograd import DeviceType

from benchmark import trace


class _Event:
    def __init__(self, name, start, end, device=DeviceType.CPU):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d


CUDA = DeviceType.CUDA


def test_segments_follow_the_innermost_phase():
    ph = [(10, 50, "A"), (20, 30, "B"), (60, 70, "C")]
    assert trace._segments(ph, 0, 100) == [
        (0, 10, "outside any phase"), (10, 20, "A"), (20, 30, "B"),
        (30, 50, "A"), (50, 60, "outside any phase"), (60, 70, "C"),
        (70, 100, "outside any phase")]


def test_union():
    assert trace._union([(5, 9), (0, 3), (2, 4), (9, 10)]) == [[0, 4],
                                                               [5, 10]]


def test_reduce():
    roles = {"operator_apply": [{"regex": re.compile(r"\bband_mv_ring\b")}],
             "bt_sweep": [{"regex": re.compile(r"\bfwd_kernel\b")}]}
    cap = trace.Capture(None, None, None, roles)
    events = [
        _Event("bench:request", 0, 100), _Event("bench:request", 100, 200),
        _Event("bench:request", 0, 100, CUDA),      # a GPU-side mark
        _Event("phase:pack", 0, 40), _Event("phase:device cg", 50, 90),
        _Event("void band_mv_ring<float, 1>()", 60, 70, CUDA),
        _Event("void fwd_kernel<float>()", 70, 80, CUDA),
        _Event("void qbwd_kernel<float, 4>()", 75, 85, CUDA),
        _Event("void band_mv_ring<float, 1>()", 150, 160, CUDA),
    ]
    s = cap._reduce(events)
    assert s.window_s == 200e-9 and s.busy_s == 35e-9
    idle = dict(s.idle_gaps)
    assert idle["pack"] == 40e-9 and idle["device cg"] == 15e-9
    assert idle["outside any phase"] == (10 + 10 + 90) * 1e-9
    assert [s.request_of(e[0]) for e in s.roles["operator_apply"]] == [0, 1]
    assert len(s.roles["bt_sweep"]) == 1
    assert s.device_ops[0][0].startswith("void band_mv_ring")
