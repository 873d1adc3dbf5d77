"""loop_setup_s: host seconds per request in the device loops' set-up,
the program's spans "newton loop setup" (``ops/newton.setup`` from the
magnetostatic models) and "heat loop setup" (``setup_heat`` from the
heat model)."""

from benchmark.metrics import _spans

NAMES = ("newton loop setup", "heat loop setup")


def read(run):
    return _spans.per_request(run,
                              lambda s: _spans.host_seconds(s, NAMES))
