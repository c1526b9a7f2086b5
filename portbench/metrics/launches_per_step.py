"""Device operations (kernels, copies, fills) launched a step in the profiled stretch."""


def read(r):
    if r.trace is None or not r.trace.steps:
        return None
    return len(r.trace.ops) / r.trace.steps
