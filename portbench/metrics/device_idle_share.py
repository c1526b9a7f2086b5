"""The share of the profiled stretch in which no operation ran on the device, in %."""


def read(r):
    if r.trace is None or r.trace.window_ns <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_ns / r.trace.window_ns)
