"""The one host driver of the port's masked device loops.

The JAX package runs every Krylov loop as a ``jax.lax.while_loop`` that
stops on the device. Here each loop is a host loop over device tensors
(``band._chunked_pcg``, ``solver._while_pcg`` / ``_while_csym``,
``parallel/band_dd._pcg_dd``, ``parallel/halo``'s two PCGs): its
stopping state stays on the device, and an iteration enqueued past the
stop is masked (its step scale is zero, so the state does not move),
which keeps the result identical to the early exit.

``masked_loop`` enqueues those iterations with a bounded in-flight
window: before it enqueues iteration ``j >= IN_FLIGHT`` it waits for
iteration ``j - IN_FLIGHT``'s "still active" flag (a CUDA event and a
pinned host copy on the card, the tensor itself on the CPU) and stops
once that flag is false. A loop thus launches at most ``IN_FLIGHT``
masked iterations past its stop, on every device, and where it stops
depends on the flags alone, never on timing: the ranks of a process
group, whose flags come from values that went through the communicator,
stop at the same iteration and keep their collectives matched.

The module-level counts, per engine and summed over solves until
``reset``, let a caller check that bound and account for every kernel
launch of a loop: ``LOOPS`` (driver runs), ``STARTS`` (preconditioner
applications outside the driver: a pass's first and each restart),
``CARRIED`` (iterations that moved the state) and ``MASKED``
(iterations launched past the stop).

While the tracer is on (``utils/profiling``) the driver's events on the
card keep their times, and ``tally`` records each run's masked tail, the
device interval of its masked iterations, as a "masked tail" record
under the open span. On the CPU nothing is recorded.
"""

from __future__ import annotations

import collections

import torch

from ..utils import profiling

#: iterations the host keeps enqueued ahead of the one whose flag it
#: reads: iteration j - 1 stays queued on the device while the host
#: enqueues j, and a loop launches at most this many masked iterations
IN_FLIGHT = 2

ENGINES = ("bt", "band", "ell-amg", "jacobi", "csym-pairs", "band-csym",
           "dd-halo", "dd-halo-csym", "dd-band")
LOOPS = dict.fromkeys(ENGINES, 0)
STARTS = dict.fromkeys(ENGINES, 0)
CARRIED = dict.fromkeys(ENGINES, 0)
MASKED = dict.fromkeys(ENGINES, 0)

#: the traced runs whose masked tails ``tally`` has yet to record:
#: (engine, [(event before step j, step j's flag)] for the steps whose
#: flags the host did not read as True, event after the last step)
_TAILS: list = []


def reset() -> None:
    """Set every engine's counts to 0."""
    for counts in (LOOPS, STARTS, CARRIED, MASKED):
        for k in counts:
            counts[k] = 0
    _TAILS.clear()


def tally(engine: str, launched: int, carried: int, starts: int = 1):
    """Count a finished loop's iterations: ``launched`` through
    ``masked_loop``, ``carried`` of them moved the state. Called after
    the caller has read the loop's state from the device; records the
    masked tail of each of the loop's traced runs."""
    STARTS[engine] += starts
    CARRIED[engine] += carried
    MASKED[engine] += launched - carried
    mine = [t for t in _TAILS if t[0] == engine]
    if not mine:
        return
    _TAILS[:] = [t for t in _TAILS if t[0] != engine]
    for _engine, steps, end in mine:
        end.synchronize()
        # the first masked step: the rest of the run is masked too
        start = next((ev for ev, flag in steps if not bool(flag)), None)
        if start is not None:
            profiling.device_record("masked tail", start, end, engine)


def masked_loop(running, step, engine: str, limit: int | None = None) -> int:
    """Drive a device-side loop from the host: ``running()`` returns the
    device's "still active" flag (a 0-d bool tensor), ``step(active)``
    enqueues one iteration that leaves the state unchanged where
    ``active`` is False. Runs until a flag read ``IN_FLIGHT`` iterations
    late is False, or ``limit`` iterations. Returns the iterations
    launched."""
    LOOPS[engine] += 1
    slots = IN_FLIGHT + 1
    pending = collections.deque()
    flags = events = None
    timing = profiling.ENABLED
    launched = 0
    while limit is None or launched < limit:
        active = running()
        if active.is_cuda:
            if flags is None:
                flags = torch.empty(slots, dtype=torch.bool,
                                    pin_memory=True)
                events = [torch.cuda.Event(enable_timing=timing)
                          for _ in range(slots)]
            # slot j % slots was last read (after its event) at j - 1
            slot = launched % slots
            flags[slot].copy_(active, non_blocking=True)
            events[slot].record()
            pending.append(slot)
        else:
            pending.append(active)
        if len(pending) > IN_FLIGHT:
            old = pending.popleft()
            if flags is not None:
                events[old].synchronize()
                old = flags[old]
            if not bool(old):
                break
        step(active)
        launched += 1
    if timing and events is not None:
        # the launched steps whose flags the host has not read as True
        # (at a stop, the first of them read False): those whose flag
        # is False were masked, which ``tally`` reads once the device
        # has passed them
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        _TAILS.append((engine, [(events[j % slots], flags[j % slots])
                                for j in range(launched - len(pending),
                                               launched)], end))
    return launched
