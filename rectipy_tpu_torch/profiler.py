"""Tracing / profiling utilities.

Counterpart of ``rectipy_tpu/profiler.py``:

- :class:`PhaseTimer` -- named wall-clock phases that synchronize with the
  device of the result handle (``torch.cuda.synchronize``; nothing for CPU
  tensors), so timings mean what they say under asynchronous launches.
- :func:`trace` -- context manager around ``torch.profiler.profile`` (CPU
  and, where present, CUDA activities) writing a TensorBoard-loadable trace.
- :func:`annotate` -- named region annotation visible in profiler traces
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

__all__ = ["PhaseTimer", "trace", "annotate"]


def _cuda_devices(tree, found: set) -> set:
    """The CUDA devices of the tensors in a result (tensors, or dicts,
    tuples and lists of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for sub in tree.values():
            _cuda_devices(sub, found)
    elif isinstance(tree, (tuple, list)):
        for sub in tree:
            _cuda_devices(sub, found)
    return found


def _sync(result) -> None:
    for device in _cuda_devices(result, set()):
        torch.cuda.synchronize(device)


class _Phase:
    """Handle yielded by :meth:`PhaseTimer.phase` -- assign the device
    result to ``.result`` inside the block so the timer can synchronize on
    it at exit (the result does not exist when the context is entered)."""

    __slots__ = ("result",)

    def __init__(self):
        self.result = None


class PhaseTimer:
    """Accumulating named phase timer.

    >>> timer = PhaseTimer()
    >>> with timer.phase("integrate") as ph:
    ...     ph.result = run(...)    # device work; timer syncs on ph.result
    >>> timer.report()

    Without assigning ``ph.result`` the recorded time is the host's alone
    (the launches, not the device work); ``Network.run`` and the trainers
    return host arrays, so timing those needs no handle.
    """

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def phase(self, name: str):
        ph = _Phase()
        t0 = time.perf_counter()
        try:
            yield ph
        finally:
            if self.sync and ph.result is not None:
                _sync(ph.result)
            self._add(name, time.perf_counter() - t0)

    def time(self, name: str, fn, *args, **kwargs):
        """Time one call, synchronizing on its output."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.sync:
            _sync(out)
        self._add(name, time.perf_counter() - t0)
        return out

    def report(self, printer=print) -> Dict[str, float]:
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            printer(f"[profile] {name}: {total:.4f}s over {self.counts[name]} call(s)")
        return dict(self.totals)


@contextlib.contextmanager
def trace(log_dir: str, host_profiling: bool = False):
    """Capture a trace of the block, viewable in TensorBoard (the PyTorch
    profiler plugin) or Perfetto: ``torch.profiler.profile`` with CPU and,
    when CUDA is available, CUDA activities, written to ``log_dir`` by
    ``tensorboard_trace_handler`` when the block ends.  ``host_profiling``
    adds input shapes and Python stacks.  Yields the profiler (its
    ``key_averages()`` and ``events()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities, record_shapes=host_profiling, with_stack=host_profiling,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def annotate(name: str):
    """Named region annotation (shows up in profiler traces)."""
    return torch.profiler.record_function(name)
