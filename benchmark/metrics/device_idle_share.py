"""device_idle_share: the share of the traced window (first request's
start to last request's end) in which no operation ran on the device,
from the union of the profiler's device intervals, in %."""


def read(run):
    s = run.trace
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
