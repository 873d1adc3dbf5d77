"""gmres_per_solve: AC GMRES iterations per request. An AC solution's
``iterations`` adds its GMRES iterations and, after a fallback, its
Jacobi-pairs CG iterations, which the loop driver also counts as
carried (``loop.CARRIED``, the window's difference the harness takes;
no other loop of an AC solve runs through the driver). The difference
is the GMRES iterations the "ac pass" spans' passes made, over the
served requests; None where a request failed."""


def read(run):
    done = [r.iterations for r in run.requests if r.error is None]
    if not done or len(done) != len(run.requests):
        return None
    return (sum(done) - run.carried) / len(done)
