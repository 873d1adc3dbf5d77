"""op_roofline: the fine-operator applications' share of their bytes
bound, in %. Each application needs the bytes of the Dirichlet-eliminated
CSR of its request's mesh (``roofline.csr_apply_bytes``: what the
operator needs, not what the program's format holds); the applications
are the profiler's kernel events of the ``operator_apply`` role, one
application each, counted in the request whose span holds it. Bound:
those bytes at the card's published HBM bandwidth, over the events'
device time."""

from benchmark import roofline


def read(run):
    s = run.trace
    if s is None:
        return None
    pk = roofline.peak(run.device_name)
    if pk is None:
        return None
    need = 0.0
    busy = 0
    for start, dur, _entry in s.roles.get("operator_apply", []):
        k = s.request_of(start)
        if k < 0:
            continue
        busy += dur
        need += run.op_bytes[k]
    if busy <= 0 or need <= 0:
        return None
    return 100.0 * (need / pk["hbm_bytes_per_s"]) / (busy / 1e9)
