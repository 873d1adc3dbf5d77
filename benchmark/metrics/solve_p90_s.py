"""solve_p90_s: the 90th percentile of the window's request times
(``statistics.quantiles``, inclusive method), over every request."""

import statistics


def read(run):
    times = [r.seconds for r in run.requests]
    if len(times) < 10:
        return None
    return statistics.quantiles(times, n=10, method="inclusive")[8]
