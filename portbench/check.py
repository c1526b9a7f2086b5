"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, each call
that the seed sampled from the window is made again from the seed and run
through the plain reference (``portbench/reference/<family>.py``) at the
configuration's precision; the program's records of that call are judged
against it.

The number compared, ``v_gap_q99``: for every trial and every record of a
sampled call, the 99th percentile over the neurons of

    |v_program - v_reference| / (1 + |v_reference|)

and the largest of these over trials, records and calls.  A neuron whose
spike lands one step apart on the two sides reads a gap near 1 and stays
out of the percentile unless it is one of many; a record, a trial or a call
that went wrong in more than 1% of its neurons does not.  Its limit is in
``portbench/limits/<cell>.json``, with the readings it was set from.
"""

from __future__ import annotations

import math

import torch

NUMBER = "v_gap_q99"
Q = 0.99


def v_gap_q99(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The largest per-row 99th percentile of the gap between two ``(..., N)``
    record stacks (rows: every leading index)."""
    p = program.reshape(-1, program.shape[-1]).to(torch.float32)
    r = reference.reshape(-1, reference.shape[-1]).to(torch.float32)
    if p.shape != r.shape:
        return math.inf
    gap = ((p - r).abs() / (1.0 + r.abs())).nan_to_num(nan=math.inf)
    k = max(1, math.ceil(Q * gap.shape[-1]))
    return float(gap.kthvalue(k, dim=-1).values.max())


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: every number within its
    limit; a number without a limit, or one that is not finite, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and math.isfinite(value) and value <= limit
    return ok and bool(numbers), out
