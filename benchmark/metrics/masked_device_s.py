"""masked_device_s: device seconds per request in the loops' masked
tails, the iterations launched past a loop's stop: the loop driver's
"masked tail" records (``ops/loop.tally``), each the device interval
from the event before the first masked step to the event after the
last step of one driver run."""

from benchmark.metrics import _spans


def read(run):
    return _spans.per_request(
        run, lambda s: _spans.device_seconds(s, ("masked tail",)))
