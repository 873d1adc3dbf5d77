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
"""

from __future__ import annotations

import collections

import torch

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


def reset() -> None:
    """Set every engine's counts to 0."""
    for counts in (LOOPS, STARTS, CARRIED, MASKED):
        for k in counts:
            counts[k] = 0


def tally(engine: str, launched: int, carried: int, starts: int = 1):
    """Count a finished loop's iterations: ``launched`` through
    ``masked_loop``, ``carried`` of them moved the state."""
    STARTS[engine] += starts
    CARRIED[engine] += carried
    MASKED[engine] += launched - carried


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
    launched = 0
    while limit is None or launched < limit:
        active = running()
        if active.is_cuda:
            if flags is None:
                flags = torch.empty(slots, dtype=torch.bool,
                                    pin_memory=True)
                events = [torch.cuda.Event() for _ in range(slots)]
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
    return launched
