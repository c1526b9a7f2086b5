"""Numerical-failure detection helpers.

Counterpart of ``rectipy_tpu/debugging.py``.  Long explicit-Euler
integrations of stiff spiking models can silently blow up; these helpers
make that loud.  Where the JAX package sets ``jax_debug_nans``,
:func:`enable_nan_checks` checks the network's state after every step of
the port's loops and turns on autograd's anomaly detection for backward
passes.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import numpy as np
import torch

from . import trees

__all__ = ["enable_nan_checks", "check_finite_state", "find_nonfinite"]

_depth = 0  # nesting depth of enable_nan_checks


def nan_checks_enabled() -> bool:
    return _depth > 0


@contextlib.contextmanager
def enable_nan_checks():
    """Context manager: raise ``FloatingPointError`` at the step where a NaN
    or an infinity first appears in the network's state inside the port's
    loops (every step function ``Network.make_step`` returns in the block
    checks the state it made, which synchronizes with the device once a
    step), and turn on ``torch.autograd.set_detect_anomaly`` for backward
    passes.  Both are restored on exit; outside the block nothing is
    checked and nothing synchronizes."""
    global _depth
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        torch.autograd.set_detect_anomaly(prev)


def checked_step(step: Callable) -> Callable:
    """``step`` (``(state, params, x) -> (state', out, taps)``) checking,
    after each call, that every floating leaf of the new state is finite;
    the first call that makes a non-finite one raises ``FloatingPointError``
    naming the step (counted from 0 over this function's calls) and the
    leaves."""
    count = [0]

    def step_checked(state, params, x):
        new_state, out, taps = step(state, params, x)
        leaves = [(path, leaf) for path, leaf in trees.items(new_state)
                  if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
        if leaves and not bool(torch.stack([torch.isfinite(leaf).all()
                                            for _, leaf in leaves]).all()):
            bad = {"/".join(map(str, path)): int((~torch.isfinite(leaf)).sum())
                   for path, leaf in leaves if not bool(torch.isfinite(leaf).all())}
            raise FloatingPointError(
                f"Non-finite values first appeared in the network state at step "
                f"{count[0]}: {bad}. Consider a smaller dt or reduced coupling strength.")
        count[0] += 1
        return new_state, out, taps

    return step_checked


def find_nonfinite(tree) -> Dict[str, int]:
    """Count non-finite entries per tree leaf (empty dict == all finite)."""
    bad = {}
    for path, leaf in trees.items(tree):
        if isinstance(leaf, torch.Tensor):
            if not (leaf.is_floating_point() or leaf.is_complex()):
                continue
            n_bad = int((~torch.isfinite(leaf)).sum())
        else:
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.inexact):
                continue
            n_bad = int(np.sum(~np.isfinite(arr)))
        if n_bad:
            bad["/".join(map(str, path))] = n_bad
    return bad


def check_finite_state(net, raise_on_failure: bool = True) -> Dict[str, int]:
    """Check every node/edge state and parameter of a Network for NaN/inf.

    Returns {leaf path: count} of offending leaves; raises FloatingPointError
    by default when any are found.
    """
    net.compile()
    bad = find_nonfinite({"state": net.init_state(), "params": net.parameters_pytree()})
    if bad and raise_on_failure:
        raise FloatingPointError(
            f"Non-finite values detected in network state/parameters: {bad}. "
            f"Consider a smaller dt or reduced coupling strength."
        )
    return bad
