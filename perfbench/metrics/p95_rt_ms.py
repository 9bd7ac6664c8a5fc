"""p95_rt_ms: the 95th percentile of every round trip of the window, each
timed from the host clock to the device's end of the step (inclusive
linear interpolation between order statistics)."""

import statistics


def read(r):
    if len(r.times) < 20:
        return None
    return statistics.quantiles(r.times, n=20, method="inclusive")[18] * 1e3
