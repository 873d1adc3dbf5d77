"""Profiling and observability hooks.

The reference has only printf progress lines (spars.cpp:254 percent
counters, static2d.cpp:994 Newton lines). The equivalents here:

* ``phase(name)`` -- accumulating wall-clock phase timers (assembly /
  AMG setup / device CG / refinement), enabled by XFEMM_TPU_PROFILE=1;
  ``report()`` prints the table (also installed atexit when enabled).
* ``trace(logdir)`` -- context manager around ``torch.profiler`` so
  host and CUDA timelines can be captured as a Chrome trace.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import time
from collections import defaultdict

ENABLED = bool(os.environ.get("XFEMM_TPU_PROFILE"))

_acc: dict[str, float] = defaultdict(float)
_cnt: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def phase(name: str):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _acc[name] += time.perf_counter() - t0
        _cnt[name] += 1


def phase_seconds(name: str) -> float:
    """Accumulated seconds recorded under ``name`` (0.0 if never hit)."""
    return _acc.get(name, 0.0)


def snapshot() -> dict:
    """{phase: seconds} accumulated so far (a copy)."""
    return dict(_acc)


def reset() -> None:
    _acc.clear()
    _cnt.clear()


def report() -> str:
    lines = ["xfemm_tpu phase timers:"]
    for name, tot in sorted(_acc.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:<28s} {tot:9.3f}s  x{_cnt[name]}")
    out = "\n".join(lines)
    return out


def _atexit_report():
    if ENABLED and _acc:
        print(report(), flush=True)


atexit.register(_atexit_report)


@contextlib.contextmanager
def trace(logdir: str = "xfemm_trace"):
    """Capture a host + CUDA timeline with ``torch.profiler`` and write
    it as a Chrome trace under ``logdir`` (open in Perfetto or
    chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
