"""solve_s: the window's wall time per completed request (host clock,
each request ending in a synchronize): the sum of the requests' times
over their count."""


def read(run):
    done = [r.seconds for r in run.requests if r.error is None]
    return sum(done) / len(done) if done else None
