"""session_setup_s: seconds per request in the solver session's set-up
phases (CSR assembly, ordering, band fill and update, factor build and
refactor: the configuration's ``phases.session_setup_s`` list). Phases
that enqueue device work count only up to their own synchronisation."""

from benchmark.metrics import _phases


def read(run):
    return _phases.per_request(run, "session_setup_s")
