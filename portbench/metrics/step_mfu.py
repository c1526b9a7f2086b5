"""The whole step's share of the card's peak: the step's least time
(``portbench/counts/<the configuration's step_count>.py``) over the
window's time a step, in the traced run's window before its profiled
stretch, in %."""
from portbench.peaks import least_seconds


def read(r):
    if not r.window_steps:
        return None
    c = r.count(r.cfg["step_count"])
    return 100.0 * least_seconds(c["bytes"], c["ops"], c["peak_ops"]) / (r.window_s / r.window_steps)
