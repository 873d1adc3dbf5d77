"""host_newton_passes: host Newton passes per request after the first
solve, the program's "newton host" spans (``models/axisymmetric`` opens
one per host pass after iteration 0: before the device loop takes over
and in the endgame after it), counted over the window's served
requests; None where the program records no spans."""

from benchmark.metrics import _spans


def read(run):
    return _spans.per_request(
        run, lambda s: sum(x.name == "newton host" for x in s))
