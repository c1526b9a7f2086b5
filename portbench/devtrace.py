"""The profiled stretches of a traced run, reduced to what the readers and the breakdown need.

Two stretches of whole calls follow the window of a traced run:

1. the device alone (``torch.profiler`` with CUDA activity only, which
   leaves the host's pace as it is): each device operation, the union of
   the intervals in which one runs, and the stretch's length on the host's
   clock between two synchronisations.  The per-layer readers and the
   breakdown's ``device_ops`` read this one;
2. the host's ops as well, for the breakdown's ``idle_gaps`` alone: each
   gap between the device's busy intervals named by what the host was doing
   in its middle (the innermost ``portbench.*`` span and the innermost op
   inside it).  Tracing the host's ops slows the host, so this stretch's
   gaps are longer than the first's.

A span of the benchmark or of the program also shows on the device's
timeline as an annotation; such events are no operation and are left out.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from portbench.calls import CALL_SPAN

TOP = 10


@dataclass
class Trace:
    ops: list  # (name, kind, duration ns) of each device operation of stretch 1
    busy_ns: int
    window_ns: int
    steps: int
    device_ops: list = field(default_factory=list)  # [name, seconds], the costliest first
    idle_gaps: list = field(default_factory=list)  # [what the host did, seconds], stretch 2


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def _profile(run_calls, host: bool) -> tuple:
    """``(events, steps, host ns)`` of ``run_calls()`` (which returns the
    network steps it completed) under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        steps = run_calls()
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    return list(prof.profiler.kineto_results.events()), steps, t1 - t0


def split_events(events) -> tuple:
    """``(host, device)`` events as sorted ``(start, end, name)``; the
    annotations left out of the device's."""
    cuda = torch.autograd.DeviceType.CUDA
    host, dev = [], []
    for ev in events:
        start = ev.start_ns()
        (dev if ev.device_type() == cuda else host).append(
            (start, start + ev.duration_ns(), ev.name()))
    spans = {n for _, _, n in host}
    dev = [d for d in dev if d[2] not in spans and not d[2].startswith("portbench.")]
    return sorted(host), sorted(dev)


def busy_and_gaps(dev: list, t0: int, t1: int) -> tuple:
    """The union length of the device intervals ``dev`` (sorted) clipped to
    ``[t0, t1]``, and the gaps of ``[t0, t1]`` outside it."""
    busy, gaps, cur = 0, [], None
    for s, e, _ in dev:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], s))
            elif s > t0:
                gaps.append((t0, s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is None:
        gaps.append((t0, t1))
    else:
        busy += cur[1] - cur[0]
        if cur[1] < t1:
            gaps.append((cur[1], t1))
    return busy, gaps


def reduce_device(dev: list, steps: int, window_ns: int) -> Trace:
    """Stretch 1's device operations, reduced."""
    busy = busy_and_gaps(dev, dev[0][0], dev[-1][1])[0] if dev else 0
    ops = [(n, _kind(n), e - s) for s, e, n in dev]
    by_op = defaultdict(int)
    for n, _, d in ops:
        by_op[n[:80]] += d
    device_ops = [[n, d * 1e-9] for n, d in sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]]
    return Trace(ops, busy, window_ns, steps, device_ops)


def trace_stretches(run_calls, run_labelled) -> Trace:
    """Stretch 1 through ``run_calls``, stretch 2 through ``run_labelled``."""
    events, steps, window_ns = _profile(run_calls, host=False)
    trace = reduce_device(split_events(events)[1], steps, window_ns)
    events, _, _ = _profile(run_labelled, host=True)
    trace.idle_gaps = idle_gaps(*split_events(events))
    return trace


def idle_gaps(host: list, dev: list) -> list:
    """The gaps between the device's busy intervals within the calls'
    spans, their seconds summed by what the host was doing at each gap's
    middle, the longest first."""
    calls = [(s, e) for s, e, n in host if n == CALL_SPAN]
    if not calls:
        return []
    _, gaps = busy_and_gaps(dev, min(s for s, _ in calls), max(e for _, e in calls))
    active = []  # (-start, end, name) of the host events open at the last gap
    by_name = defaultdict(int)
    i = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(host) and host[i][0] <= mid:
            active.append((-host[i][0], host[i][1], host[i][2]))
            i += 1
        active = sorted(ev for ev in active if ev[1] >= mid)  # innermost first
        span = next((n for _, _, n in active if n.startswith("portbench.") and n != CALL_SPAN),
                    None)
        inner = active[0][2] if active else None
        if inner is None:
            label = "host outside any op"
        elif span is None or span == inner:
            label = inner
        else:
            label = f"{span} / {inner}"
        by_name[label[:120]] += e - s
    return [[n, d * 1e-9] for n, d in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
