"""ac_fallback_share: the share of the AC solves' refinement passes not
run on the AC band engine's main path, GMRES preconditioned by the
block-tridiagonal factor, in %: the program's one span per pass, "ac
pass (<engine>)", counted by engine over the window's served requests.
A pass on "band gmres + vcycle" follows a dropped factor, one on
"jacobi pairs" a band engine latched off (or one that never fit)."""

from benchmark.metrics import _spans

PREFIX = "ac pass ("
MAIN = "ac pass (band gmres + bt)"


def read(run):
    every = _spans.per_request(
        run, lambda s: sum(x.name.startswith(PREFIX) for x in s))
    if not every:
        return None
    main = _spans.per_request(run, lambda s: sum(x.name == MAIN for x in s))
    return 100.0 * (every - main) / every
