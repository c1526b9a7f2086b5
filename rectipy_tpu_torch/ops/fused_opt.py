"""Fused adam + int8 requantization of an ``int8_master`` coupling.

Counterpart of ``rectipy_tpu/ops/fused_opt.py``.  One pass over the
``(N, N)`` arrays performs the optax adam step on the float32 master and the
next epoch's per-row quantization of the result:

    mu'  = b1*mu + (1-b1)*g
    nu'  = b2*nu + (1-b2)*g^2
    W'   = W - lr * (mu'/bc1) / (sqrt(nu'/bc2) + eps)
    amax = max(|W'|, axis=1)
    scale = max(amax, 1e-30) / 127
    wq   = clip(round(W'/scale), -127, 127).astype(int8)

- :func:`adam_leaf` is the adam step of one leaf.
- :func:`adam_requant_plain` is the plain PyTorch version (the JAX
  package's ``adam_requant_xla``); it calls ``ops.quant.quantize_rows``
  itself, so the fused path cannot drift from the quantization every other
  path uses.
- :func:`adam_requant` launches the CUDA kernel ``csrc/adam_requant.cu`` for
  CUDA tensors and takes the plain version for CPU tensors.  There is no
  shape probe and no fallback: a CUDA tensor the kernel does not take raises.

``bias_corrections`` computes ``bc1, bc2`` in float32 from the step count, as
the JAX package's fused path does (``network.py``: ``count.astype(float32)``);
the kernel and the plain version both take its values.

Where it is used: ``Network.fit_bptt`` with ``RECTIPY_FUSED_ADAM=on`` calls
:func:`adam_requant` for plain-adam fits of one trained dense
``int8_master`` coupling on a chain network.  The
``(wq, scale)`` pair rides the optimizer state into the next epoch's
trajectory, so that epoch quantizes nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import build
from .quant import quantize_rows

__all__ = ["adam_leaf", "adam_requant_plain", "adam_requant", "bias_corrections"]


def bias_corrections(count: int, b1: float, b2: float):
    """``(1 - b1**count, 1 - b2**count)`` computed in float32 (the count cast
    to float32 first), returned as Python floats holding those values."""
    cf = torch.tensor(float(count), dtype=torch.float32)
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** cf
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** cf
    return float(bc1), float(bc2)


def adam_leaf(w, m, v, g, bc1, bc2, lr, b1, b2, eps):
    """One adam step on a single leaf (the formulas of optax's
    ``scale_by_adam`` + ``scale_by_learning_rate``): returns ``(w', m', v')``."""
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * (g * g)
    mh = m / bc1
    vh = v / bc2
    return w - lr * mh / (torch.sqrt(vh) + eps), m, v


def adam_requant_plain(w, m, v, g, bc1, bc2, lr, *, b1, b2, eps):
    """Plain version: the adam step on the master, then ``quantize_rows`` of
    the result.  Returns ``(w', m', v', wq, scale)``."""
    w, m, v = adam_leaf(w, m, v, g, bc1, bc2, lr, b1, b2, eps)
    wq, scale = quantize_rows(w)
    return w, m, v, wq, scale


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build("adam_requant").lib.adam_requant_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 9 + [i, i, i] + [f] * 8 + [p]
    fn.restype = ctypes.c_int
    return fn


def adam_requant(w, m, v, g, bc1: float, bc2: float, lr: float, *, b1: float, b2: float,
                 eps: float):
    """The fused step: ``(w', m', v', wq, scale)`` with ``scale`` of shape
    ``(n_rows,)``.

    CPU tensors take :func:`adam_requant_plain`.  CUDA tensors launch the
    kernel on the current stream: ``w, m, v, g`` contiguous float32
    matrices of one shape on the current device, ``bc1, bc2, lr`` Python
    numbers; anything else raises.  The inputs are never written.  Each
    launch adds one to ``adam_requant.launches``."""
    if w.device.type == "cpu":
        return adam_requant_plain(w, m, v, g, bc1, bc2, lr, b1=b1, b2=b2, eps=eps)
    device = w.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"adam_requant: w must be on the current CUDA device, got {device}")
    if w.dim() != 2:
        raise ValueError(f"adam_requant: w must be a matrix, got shape {tuple(w.shape)}")
    for name, t in (("w", w), ("m", m), ("v", v), ("g", g)):
        if t.device != device or t.dtype != torch.float32 or t.shape != w.shape \
                or not t.is_contiguous():
            raise ValueError(f"adam_requant: {name} must be a contiguous float32 "
                             f"{tuple(w.shape)} tensor on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, val in (("bc1", bc1), ("bc2", bc2), ("lr", lr)):
        if isinstance(val, torch.Tensor):
            raise TypeError(f"adam_requant: {name} must be a Python number")
    n_rows, n_cols = w.shape
    w2, m2, v2 = torch.empty_like(w), torch.empty_like(m), torch.empty_like(v)
    wq = torch.empty((n_rows, n_cols), dtype=torch.int8, device=device)
    scale = torch.empty(n_rows, dtype=torch.float32, device=device)
    tensors = (w, m, v, g, w2, m2, v2, wq)
    vec = int(n_cols % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))
    err = _launch_fn()(
        *(t.data_ptr() for t in tensors), scale.data_ptr(), n_rows, n_cols, vec,
        float(b1), 1.0 - float(b1), float(b2), 1.0 - float(b2), float(bc1), float(bc2),
        float(lr), float(eps), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam_requant: kernel launch failed with CUDA error {err}")
    adam_requant.launches += 1
    return w2, m2, v2, wq, scale


adam_requant.launches = 0
