"""cg_per_solve: Krylov iterations per request (the solution's
``iterations``: every linear solve's CG iterations, the device loops'
included)."""


def read(run):
    done = [r.iterations for r in run.requests if r.error is None]
    return sum(done) / len(done) if done else None
