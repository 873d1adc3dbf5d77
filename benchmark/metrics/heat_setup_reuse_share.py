"""heat_setup_reuse_share: the share of the heat solves whose static
set-up was taken from the one kept for their mesh, in %: the program's
one span per heat solve, "heat setup (built)", "heat setup (sources)"
(only the sources changed, and were refreshed) or "heat setup
(reused)", counted over the window's served requests."""

from benchmark.metrics import _spans

PREFIX = "heat setup ("
KEPT = ("heat setup (sources)", "heat setup (reused)")


def read(run):
    every = _spans.per_request(
        run, lambda s: sum(x.name.startswith(PREFIX) for x in s))
    if not every:
        return None
    kept = _spans.per_request(run, lambda s: sum(x.name in KEPT for x in s))
    return 100.0 * kept / every
