"""Inputs and checks that hold the fused adam + requantize kernel to its plain
version; ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` both use them.

W', m', v' and scale must agree within rtol ``ADAM_RTOL`` with an atol of
``ADAM_RTOL`` times each tensor's largest entry (the plain version's kernels
may round a division by a host scalar through its reciprocal: an ulp of the
update, which is large against a W' that nearly cancels); wq must be equal
except where the plain W'/scale lies within 1e-4 of a .5 rounding boundary.
"""

from __future__ import annotations

import torch

from .ops.fused_opt import bias_corrections

__all__ = ["ADAM_KW", "ADAM_RTOL", "adam_inputs", "check_adam_requant"]

ADAM_RTOL = 1e-6
ADAM_KW = dict(b1=0.9, b2=0.999, eps=1e-8)


def adam_inputs(n_rows, n_cols, count, seed, device):
    """Adam inputs whose update is of order lr everywhere (m and v of the
    gradient's sign and square), so that it is over 1e3x the W' tolerance.
    Returns ``(w, m, v, g, bc1, bc2, lr)``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(lo, hi):
        return lo + (hi - lo) * torch.rand((n_rows, n_cols), generator=gen, device=device)

    w = torch.randn((n_rows, n_cols), generator=gen, device=device) * 0.01
    g = torch.randn((n_rows, n_cols), generator=gen, device=device)
    g = torch.where(g.abs() < 0.05, torch.full_like(g, 0.05), g)
    if count == 1:
        m, v = torch.zeros_like(w), torch.zeros_like(w)
    else:
        m, v = g * rand(0.5, 1.5), g * g * rand(0.5, 1.5)
    bc1, bc2 = bias_corrections(count, ADAM_KW["b1"], ADAM_KW["b2"])
    return w, m, v, g, bc1, bc2, 1e-2


def check_adam_requant(got, ref, w):
    """Hold the kernel's outputs ``got`` to the plain version's ``ref`` (both
    ``(w', m', v', wq, scale)``); returns (max relative error, entries at a
    rounding boundary, min update over the W' tolerance)."""
    rel = 0.0
    for a, b in zip(got[:3] + (got[4],), ref[:3] + (ref[4],)):
        atol = ADAM_RTOL * float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=ADAM_RTOL, atol=atol)
        rel = max(rel, float(((a - b).abs() / (atol + b.abs())).max()))
    ratio = ref[0] / ref[4][:, None]
    boundary = ((ratio - ratio.floor()) - 0.5).abs() < 1e-4
    differ = got[3] != ref[3]
    if bool((differ & ~boundary).any()):
        raise AssertionError("wq differs away from a rounding boundary")
    # the check's power: the update is far above the tolerance on W'
    tol = ADAM_RTOL * (float(ref[0].abs().max()) + ref[0].abs())
    margin = float(((ref[0] - w).abs() / tol).min())
    if margin < 1e3:
        raise AssertionError(f"the adam update is only {margin}x the W' tolerance")
    return rel, int(boundary.sum()), margin
