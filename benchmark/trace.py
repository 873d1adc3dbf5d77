"""The traced run: ``torch.profiler`` over the window, the program's
phase timers on and each phase also marked in the profiler's timeline,
and the block-tridiagonal sweep wrappers counting the bytes of their
operands. ``Capture.stop`` reduces the trace to a ``Summary``: the
device's busy time, the kernels of each role, the request spans, and
the breakdown (device operations by time; idle gaps by the host phase
open at the time)."""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

from . import roofline

#: timeline marks of the harness (requests, meshing) and of phases
MARKS = ("bench:", "phase:")


def _times(e):
    """(start, end) of a profiler event, in ns."""
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        end = e.end_ns() if hasattr(e, "end_ns") else s + e.duration_ns()
        return s, end
    s = int(e.start_us() * 1000)
    return s, s + int(e.duration_us() * 1000)


def _union(intervals):
    """Merged, sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _segments(phases, w0: int, w1: int):
    """The window cut into (start, end, name) pieces, each named by the
    innermost phase open over it ("outside any phase" where none is).
    Phases nest: they are context managers on one host thread."""
    out, stack, t = [], [], w0

    def advance(upto):
        nonlocal t
        while t < upto:
            while stack and stack[-1][1] <= t:
                stack.pop()
            end = min(upto, stack[-1][1]) if stack else upto
            out.append((t, end, stack[-1][2] if stack
                        else "outside any phase"))
            t = end

    for s, e, name in sorted(phases):
        advance(min(max(s, t), w1))
        stack.append((s, e, name))
    advance(w1)
    return out


@dataclass
class Summary:
    window_s: float
    busy_s: float
    requests: list                       # (start, end) ns per request
    roles: dict                          # role -> [(start, dur, entry)]
    sweep_bytes: int                     # bytes the sweep launches moved
    sweep_calls: int
    device_ops: list = field(default_factory=list)   # (name, s)
    idle_gaps: list = field(default_factory=list)    # (name, s)
    events: int = 0

    def request_of(self, t: int) -> int:
        """Index of the request whose span holds time ``t``, else -1."""
        k = bisect.bisect_right([s for s, _e in self.requests], t) - 1
        if k >= 0 and t <= self.requests[k][1]:
            return k
        return -1

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps]}


class Capture:
    def __init__(self, torch, profiling, kernels, roles: dict):
        self.torch = torch
        self.profiling = profiling
        self.kernels = kernels
        self.roles = roles
        self.sweep_bytes = 0
        self.sweep_calls = 0
        self._saved = []

    def _wrap(self):
        torch, prof_mod, kern = self.torch, self.profiling, self.kernels
        phase = prof_mod.phase

        @contextlib.contextmanager
        def marked(name):
            with phase(name), torch.profiler.record_function("phase:"
                                                              + name):
                yield

        fwd, qbwd = kern.bt_fwd, kern.bt_qbwd

        def bt_fwd(G, r, *a, **kw):
            y = fwd(G, r, *a, **kw)
            if r.is_cuda:
                self.sweep_calls += 1
                self.sweep_bytes += roofline.sweep_bytes([G], [r, y])
            return y

        def bt_qbwd(Sinv, G, y, *a, **kw):
            z = qbwd(Sinv, G, y, *a, **kw)
            if y.is_cuda:
                self.sweep_calls += 1
                self.sweep_bytes += roofline.sweep_bytes([Sinv, G], [y, z])
            return z

        self._saved = [(prof_mod, "phase", phase),
                       (prof_mod, "ENABLED", prof_mod.ENABLED),
                       (kern, "bt_fwd", fwd), (kern, "bt_qbwd", qbwd)]
        prof_mod.phase = marked
        prof_mod.ENABLED = True
        kern.bt_fwd = bt_fwd
        kern.bt_qbwd = bt_qbwd

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._wrap()
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self) -> Summary:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        for mod, name, val in self._saved:
            setattr(mod, name, val)
        return self._reduce(self.prof.profiler.kineto_results.events())

    def _reduce(self, events) -> Summary:
        from torch.autograd import DeviceType
        device, requests, phases = [], [], []
        n = 0
        for e in events:
            n += 1
            name = e.name()
            s, t = _times(e)
            if e.device_type() == DeviceType.CUDA:
                if not name.startswith(MARKS):
                    device.append((s, t, name))
            elif name == "bench:request":
                requests.append((s, t))
            elif name == "bench:mesh":
                phases.append((s, t, "mesher"))
            elif name.startswith("phase:"):
                phases.append((s, t, name[len("phase:"):]))
        requests.sort()
        if requests:
            w0, w1 = requests[0][0], requests[-1][1]
        else:
            w0 = w1 = 0
        inside = [(max(s, w0), min(t, w1), nm) for s, t, nm in device
                  if t > w0 and s < w1]
        busy = _union([(s, t) for s, t, _nm in inside])
        busy_ns = sum(t - s for s, t in busy)

        totals: dict[str, int] = {}
        for s, t, nm in inside:
            totals[nm] = totals.get(nm, 0) + (t - s)
        device_ops = sorted(((nm, ns / 1e9) for nm, ns in totals.items()),
                            key=lambda kv: -kv[1])[:10]

        # idle gaps, split by the innermost phase open over each part
        gaps = []
        prev = w0
        for s, t in busy + [[w1, w1]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        idle: dict[str, int] = {}
        segs = _segments(phases, w0, w1)
        j = 0
        for s, t in gaps:
            while j < len(segs) and segs[j][1] <= s:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < t:
                a, b, name = segs[k]
                ov = min(b, t) - max(a, s)
                if ov > 0:
                    idle[name] = idle.get(name, 0) + ov
                k += 1
        idle_gaps = sorted(((nm, ns / 1e9) for nm, ns in idle.items()),
                           key=lambda kv: -kv[1])[:10]

        roles = {}
        for role, entries in self.roles.items():
            hits = []
            for s, t, nm in device:
                for entry in entries:
                    if entry["regex"].search(nm):
                        hits.append((s, t - s, entry))
                        break
            roles[role] = hits
        return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                       requests=requests, roles=roles,
                       sweep_bytes=self.sweep_bytes,
                       sweep_calls=self.sweep_calls, device_ops=device_ops,
                       idle_gaps=idle_gaps, events=n)
