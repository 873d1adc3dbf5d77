"""axi_setup_reuse_share: the share of the axisymmetric magnetostatic
solves whose set-up was taken from the one kept for their mesh, in %:
the program's one span per axisymmetric solve, "axi setup (built)", "axi
setup (sources)" (only the blocks' J changed, and what J feeds was
refreshed) or "axi setup (reused)", counted over the window's served
requests."""

from benchmark.metrics import _spans

PREFIX = "axi setup ("
KEPT = ("axi setup (sources)", "axi setup (reused)")


def read(run):
    every = _spans.per_request(
        run, lambda s: sum(x.name.startswith(PREFIX) for x in s))
    if not every:
        return None
    kept = _spans.per_request(run, lambda s: sum(x.name in KEPT for x in s))
    return 100.0 * kept / every
