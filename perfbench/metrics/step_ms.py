"""step_ms: the window's wall time over the IFS time steps it completed."""


def read(r):
    return r.window_s / r.steps * 1e3
