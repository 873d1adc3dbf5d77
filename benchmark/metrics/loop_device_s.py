"""loop_device_s: device seconds per request in the Krylov and device
loops, the program's spans "device cg", "device newton" and "device
heat", from the CUDA events each records as it opens and closes."""

from benchmark.metrics import _spans

NAMES = ("device cg", "device newton", "device heat")


def read(run):
    return _spans.per_request(run,
                              lambda s: _spans.device_seconds(s, NAMES))
