"""masked_share: the share of the device loops' launched iterations that
were masked (launched past the loop's stop): the program's counters
``loop.MASKED / (loop.CARRIED + loop.MASKED)``, summed over engines and
taken as deltas over the window, in %."""


def read(run):
    total = run.carried + run.masked
    return 100.0 * run.masked / total if total else None
