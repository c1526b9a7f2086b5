"""Surrogate-gradient spike nonlinearity.

Counterpart of ``rectipy_tpu/ops/surrogate.py`` as a
``torch.autograd.Function``:

- forward: ``heaviside(x, center)`` -- 0 for x<0, ``center`` at x==0, 1 for x>0
- backward: fast-sigmoid / SuperSpike-style ``g / (1 + slope*|x|)**2``

``slope``/``center`` are static per-node hyperparameters, closed over by a
factory so each node gets its own spike function and gradients flow only
through ``x``.
"""

from __future__ import annotations

import functools

import torch


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope: float, center: float):
        ctx.save_for_backward(x)
        ctx.slope = slope
        # the value at 0 is filled on the device (no host-to-device copy)
        return torch.heaviside(x, torch.full((), center, dtype=x.dtype, device=x.device))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        denom = 1.0 + ctx.slope * torch.abs(x)
        return g / (denom * denom), None, None


@functools.lru_cache(maxsize=None)
def make_spike_fn(slope: float = 10.0, center: float = 1.0):
    """Build ``spike(x) = heaviside(x, center)`` with surrogate gradient
    ``g / (1 + slope*|x|)**2``."""
    slope = float(slope)
    center = float(center)

    def spike_fn(x):
        return _Spike.apply(x, slope, center)

    return spike_fn


def spike(x, slope: float = 10.0, center: float = 1.0):
    """Functional form: surrogate-gradient heaviside spike."""
    return make_spike_fn(slope, center)(x)


def default_spike_slope(spike_threshold: float, spike_reset: float) -> float:
    """RectiPy's default: ``100 / |threshold - reset|``."""
    return 100.0 / abs(float(spike_threshold) - float(spike_reset))
