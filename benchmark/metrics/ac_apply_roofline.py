"""ac_apply_roofline: the AC complex apply's share of its bytes bound,
in %. The apply is two two-column K1 launches, one on the real part's
band and one on the imaginary part's; each launch needs one component's
Dirichlet-eliminated CSR of its request's mesh (f32 values, int32
columns and row pointers: ``roofline.csr_apply_bytes``, which also
counts one column of x and y) and two f32 columns of x read and two of
y written, 8 n bytes more. The imaginary part is counted at the mesh's
whole pattern, though its nonzeros lie on the conductors alone. The
launches are the ``operator_apply`` role's kernel events, counted in
the request whose span holds them; bound: those bytes at the card's
published HBM bandwidth, over the events' device time. A V-cycle's K1
launches are not the apply, so a window with a pass on any engine but
the factor's reads None (``ac_fallback_share`` above 0 or unknown)."""

from benchmark import roofline
from benchmark.metrics import ac_fallback_share


def read(run):
    s = run.trace
    if s is None or ac_fallback_share.read(run) != 0.0:
        return None
    pk = roofline.peak(run.device_name)
    if pk is None:
        return None
    need = 0.0
    busy = 0
    for start, dur, _entry in s.roles.get("operator_apply", []):
        k = s.request_of(start)
        if k < 0 or run.requests[k].error is not None:
            continue
        busy += dur
        need += run.op_bytes[k] + 8 * len(run.requests[k].mesh.nodes)
    if busy <= 0 or need <= 0:
        return None
    return 100.0 * (need / pk["hbm_bytes_per_s"]) / (busy / 1e9)
