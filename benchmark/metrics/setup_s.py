"""setup_s: from the start of the process to the window's start:
imports, the kernels' build cache (a build on the first run in a
checkout), meshing and the warm-up request."""


def read(run):
    return run.setup_s
