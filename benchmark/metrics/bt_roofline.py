"""bt_roofline: the block-tridiagonal sweeps' share of their bytes bound,
in %: the factor blocks and vectors each launch reads and writes once
(counted by the traced run's wrappers of ``kernels.bt_fwd`` and
``kernels.bt_qbwd``) at the card's published HBM bandwidth, over the
device time of the ``bt_sweep`` role's kernel events. Nothing is read
when the wrappers and the events disagree in number."""

from benchmark import roofline


def read(run):
    s = run.trace
    if s is None or not s.sweep_calls:
        return None
    pk = roofline.peak(run.device_name)
    events = [e for e in s.roles.get("bt_sweep", [])
              if s.request_of(e[0]) >= 0]
    if pk is None or len(events) != s.sweep_calls:
        return None
    busy = sum(dur for _s, dur, _e in events) / 1e9
    return 100.0 * (s.sweep_bytes / pk["hbm_bytes_per_s"]) / busy
