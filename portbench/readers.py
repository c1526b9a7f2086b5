"""What the per-layer metrics' readers (``portbench/metrics/<metric>.py``) read.

A reader is a file with ``read(r: Reading)``, which returns the metric's
value, or ``None`` where it finds nothing to read: the harness then leaves
the metric out of the line.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from portbench.peaks import least_seconds


@dataclass
class Reading:
    cfg: dict
    mix: dict
    count: Callable  # count(name) -> {"bytes", "ops", "peak_ops"} of portbench/counts/<name>.py
    kernels_of: Callable  # kernels_of(name) -> the device kernel names portbench/counts/<name>.py counts
    window_s: float  # the traced run's window before its profiled stretch
    window_steps: int  # the network steps completed in it
    trace: Optional[object]  # portbench.devtrace.Trace of the profiled stretch
    handwritten: frozenset  # the names of the program's hand-written kernels
    network_build_s: float


def kernel_roofline(r: Reading, name: str) -> Optional[float]:
    """The least time of one launch of counted kernel ``name`` at this
    cell's shapes over its mean device time a launch in the profiled
    stretch, in %."""
    if r.trace is None:
        return None
    kernels = r.kernels_of(name)
    durs = [d for op, _, d in r.trace.ops if any(k in op for k in kernels)]
    if not durs:
        return None
    c = r.count(name)
    mean_s = sum(durs) / len(durs) * 1e-9
    return 100.0 * least_seconds(c["bytes"], c["ops"], c["peak_ops"]) / mean_s
