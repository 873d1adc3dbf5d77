"""The program's spans of the window's requests (``utils/profiling``,
on in the traced run), shared by the span-based readers: one root span
"solve" per request, every span under it carrying the root's id as its
request id."""


def _spans():
    """The program's spans, or None where it records none."""
    from xfemm_tpu_torch.utils import profiling
    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def per_request(run, value):
    """``value(spans of one request)`` summed over the window's served
    requests (the last ``len(run.requests)`` roots, less those an
    exception went through) and divided by their number; None where
    the program records no spans, or ``value`` finds nothing in any
    request (it returns None)."""
    spans = _spans()
    if not spans or not run.requests:
        return None
    roots = [s for s in spans if s.parent is None and s.name == "solve"]
    served = [r.id for r in roots[-len(run.requests):] if not r.error]
    if not served:
        return None
    trees = {rid: [] for rid in served}
    for s in spans:
        if s.request in trees and s.parent is not None:
            trees[s.request].append(s)
    found = [v for v in (value(trees[rid]) for rid in served)
             if v is not None]
    if not found:
        return None
    return sum(found) / len(served)


def host_seconds(spans, names):
    """Host seconds of the spans named ``names`` (None: none there)."""
    hits = [s for s in spans if s.name in names and s.end_ns is not None]
    if not hits:
        return None
    return sum(s.end_ns - s.start_ns for s in hits) * 1e-9


def device_seconds(spans, names):
    """Device seconds of the spans named ``names`` whose device times
    are known (None: none there)."""
    hits = [s for s in spans
            if s.name in names and s.device_end_ns is not None]
    if not hits:
        return None
    return sum(s.device_end_ns - s.device_start_ns for s in hits) * 1e-9
