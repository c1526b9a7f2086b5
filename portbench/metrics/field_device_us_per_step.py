"""Device time a step of every kernel that is not one of the program's
hand-written ones (the lowered field, the source quantization, the
elementwise work, record assembly), in the profiled stretch."""


def read(r):
    if r.trace is None or not r.trace.steps:
        return None
    ns = sum(d for op, kind, d in r.trace.ops
             if kind == "kernel" and not any(k in op for k in r.handwritten))
    return ns * 1e-3 / r.trace.steps
