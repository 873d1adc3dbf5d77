"""ac_device_s: device seconds per request in the AC solves' device
passes, the program's spans "device gmres (ac)" (complex GMRES on the
bands) and "device cg (ac pairs)" (Jacobi CG on (re, im) pairs), from
the CUDA events each records as it opens and closes."""

from benchmark.metrics import _spans

NAMES = ("device gmres (ac)", "device cg (ac pairs)")


def read(run):
    return _spans.per_request(run,
                              lambda s: _spans.device_seconds(s, NAMES))
