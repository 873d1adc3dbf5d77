"""Seconds per request in a configuration's list of program phases
(``utils/profiling`` timers, on in the traced run), shared by the
phase-based readers."""


def per_request(run, metric: str):
    names = run.config.get("phases", {}).get(metric)
    done = [r for r in run.requests if r.error is None]
    if not names or not done:
        return None
    total = sum(r.phases.get(n, 0.0) for r in done for n in names)
    return total / len(done)
