"""Plain PyTorch reference of a qif_sfa call: float32, TF32 off.

It imports nothing of rectipy_tpu_torch and takes nothing it made: from the
benchmark's raw inputs (float32 weights or blocks, etas, input weights) and
a call's drive, start potentials and sweep offsets, it works out the
coupling's lower-precision form itself and integrates the network:

    spike = [v >= threshold]
    s_in  = W @ s                       (in the stated precision)
    v'    = (v^2 + (eta - x) + I) / tau + k * s_in
    s'    = -s / tau_s + spike / dt
    x'    = -x / tau_x + alpha * spike / dt
    v <- v + dt v', reset to spike_reset where spike;  s, x <- Euler

``I`` is ``w_in * tanh(drive)`` through a tanh input node, or the drive
itself.  The records follow the program's windows: the state after step 0,
then after every ``sampling_steps``-th step; steps after the last full
window are not recorded, and are not integrated here.

Precisions of the coupling (``precision``):

- ``"bfloat16"``: W and s rounded to bfloat16, products summed in float32;
- ``"int8"`` / ``"int4"``: W quantized per output row, symmetric, to 127 /
  7 levels, s per trial by ``max|s|``; exact integer sums, then the row
  scale, then the source scale, in float32.
"""

from __future__ import annotations

import torch

LEVELS = {"int8": 127.0, "int4": 7.0}


def _div(t: torch.Tensor, value: float) -> torch.Tensor:
    """``t / value`` correctly rounded on every device (a CUDA division by a
    Python number multiplies by its reciprocal)."""
    return t / torch.tensor(value, dtype=t.dtype, device=t.device)


def _quantize(t: torch.Tensor, levels: float, dims) -> tuple:
    """Symmetric quantization over ``dims``: the integers (held in float32)
    and the float32 scale, ``max|t| / levels``."""
    scale = _div(t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30), levels)
    return torch.clamp(torch.round(t / scale), -levels, levels), scale


class Coupling:
    """``s_in = W @ s`` for ``(B, N)`` sources in one precision."""

    def __init__(self, cfg: dict, inputs: dict, precision: str):
        self.precision = precision
        self.dense = cfg["coupling"] == "dense"
        if self.dense:
            w = inputs["weights"]
            if precision in LEVELS:
                self.w, scale = _quantize(w, LEVELS[precision], -1)
                self.row_scale = scale.reshape(1, -1)
            elif precision == "bfloat16":
                self.w = w.to(torch.bfloat16).to(torch.float32)
            else:
                raise ValueError(f"dense couplings are compared in bfloat16, int8 or int4, "
                                 f"not {precision}")
            return
        if precision not in LEVELS:
            raise ValueError(f"block couplings are compared in int8 or int4, not {precision}")
        self.cols = inputs["cols"].long()
        n_br, cb = self.cols.shape
        bs = cfg["block_size"]
        self.bs = bs
        self.w = torch.empty((n_br, cb, bs, bs), dtype=torch.float32,
                             device=self.cols.device)
        self.row_scale = torch.empty((n_br, bs), dtype=torch.float32, device=self.cols.device)
        for lo, hi, chunk in inputs["blocks"]():
            q, scale = _quantize(chunk, LEVELS[precision], (1, 3))
            self.w[lo:hi] = q
            self.row_scale[lo:hi] = scale.reshape(hi - lo, bs)

    def __call__(self, s: torch.Tensor) -> torch.Tensor:
        p = self.precision
        if p == "bfloat16":
            return s.to(torch.bfloat16).to(torch.float32) @ self.w.T
        sq, s_scale = _quantize(s, LEVELS[p], -1)  # (B, N), (B, 1)
        if self.dense:
            return (sq @ self.w.T) * self.row_scale * s_scale
        B = s.shape[0]
        n_br, cb, bs = self.w.shape[0], self.w.shape[1], self.bs
        x = sq.reshape(B, -1, bs)[:, self.cols]  # (B, n_br, cb, bs)
        x = x.permute(1, 2, 3, 0).reshape(n_br * cb, bs, B)
        acc = torch.bmm(self.w.reshape(n_br * cb, bs, bs), x)  # exact: below 2^24
        acc = acc.reshape(n_br, cb, bs, B).sum(1)  # exact: fan-in * levels^2 < 2^24
        out = acc * self.row_scale[..., None]
        return out.permute(2, 0, 1).reshape(B, n_br * bs) * s_scale


def simulate(cfg: dict, inputs: dict, coupling: Coupling, mix: dict, call) -> dict:
    """The records of one call, ``{(node, var): (B, R, ...)}`` on the device,
    for the ``record_vars`` of ``mix`` (``v`` and ``s`` of node ``qif``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T, every = mix["steps"], mix["sampling_steps"]
    last = (T - 1) // every * every  # the last recorded step
    etas = inputs["etas"][None, :]
    if call.offsets is not None:
        etas = etas + call.offsets[:, None]
    B = 1 if call.offsets is None else call.offsets.shape[0]
    n = cfg["n"]
    v = call.v0[None, :].expand(B, n).clone()
    s = torch.zeros_like(v)
    x = torch.zeros_like(v)
    dt, tau, tau_s, tau_x = cfg["dt"], cfg["tau"], cfg["tau_s"], cfg["tau_x"]
    k, alpha, thr, reset = cfg["k"], cfg["alpha"], cfg["spike_threshold"], cfg["spike_reset"]
    drive = call.drive[:, 0]
    if cfg["input"] == "tanh_node":
        drive_in = torch.tanh(drive)[:, None] * inputs["w_in"][:, 0][None, :]  # (T, N)
    recs = {"v": [], "s": []}
    with torch.no_grad():
        for t in range(last + 1):
            spike = (v >= thr).to(torch.float32)
            s_in = coupling(s)
            inp = drive_in[t] if cfg["input"] == "tanh_node" else drive[t]
            dv = (v * v + (etas - x) + inp) / tau + k * s_in
            ds = -s / tau_s + spike / dt
            dx = -x / tau_x + alpha * spike / dt
            v = (v + dt * dv) * (1.0 - spike) + spike * reset
            s = s + dt * ds
            x = x + dt * dx
            if t % every == 0:
                recs["v"].append(v)
                recs["s"].append(s)
    out = {}
    for node, var, reduce in mix["record_vars"]:
        r = torch.stack(recs[var], dim=1)  # (B, R, N)
        out[(node, var)] = r.mean(dim=-1) if reduce else r
    return out
