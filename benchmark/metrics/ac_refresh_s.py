"""ac_refresh_s: host seconds per request in the AC band engine's
refresh of a reused pattern, the program's spans "ac band refresh" (the
shifted hierarchy's fine level), "bt refactor (ac)" (the factor rebuilt)
and "ac band fill" (the Ar and Ai bands filled on the device)."""

from benchmark.metrics import _spans

NAMES = ("ac band refresh", "bt refactor (ac)", "ac band fill")


def read(run):
    return _spans.per_request(run,
                              lambda s: _spans.host_seconds(s, NAMES))
