"""Seconds from the process's start to the window's start: imports, the kernels' library, the runner's set-up, the
weights, and the warm-up iterations (the first of which the reference follows)."""


def read(ctx):
    return ctx["setup_s"]
