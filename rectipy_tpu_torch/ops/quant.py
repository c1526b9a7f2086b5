"""int8 quantized-training coupling (``coupling_dtype='int8_master'``).

Counterpart of the dense int8 part of ``rectipy_tpu/ops/quant.py``.  The
float master coupling is quantized symmetrically per output row once per
trajectory (``quantize_rows``); each step's matvec runs int8 x int8 with an
exact int32 sum and a dynamic activation scale, and gradients flow
straight-through (STE):

    forward   out = (scale . (W_q @ q(src))) * s_src        ~  W @ src
    backward  dsrc = W_q^T (scale . delta) * s_delta        ~  W^T @ delta
              dW   = Delta^T @ Src (float32; one matmul after the backward
                     loop in ops/bptt.py, a per-step outer product on the
                     plain autograd path)

The two int8 products are hand-written CUDA kernels (``csrc/int8_matvec.cu``):
:func:`int8_dot` and :func:`int8_dot_t` launch them for CUDA tensors and take
their plain versions (:func:`int8_dot_plain`, :func:`int8_dot_t_plain`) for
CPU tensors.  The plain versions sum in float64, which is exact for every
fan-in below :data:`INT8_DOT_MAX_FAN_IN` (each sum is an integer under 2^31),
so kernel and plain version agree bit for bit.

Casts follow the JAX package exactly: the int32 sum becomes float32 and is
multiplied ``* row_scale * act_scale`` in that order, in float32, whatever
the network's dtype; ``quant_vec`` rounds its scale to float32 and divides by
that value cast back to the activation's dtype; ``torch.round`` rounds half
to even, as ``jnp.round`` does.

int4 and block-sparse couplings are not ported yet (ROADMAP Queue 1 items 5
and 10).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import build

__all__ = ["quantize_rows", "quant_vec", "INT8_DOT_MAX_FAN_IN", "int8_dot", "int8_dot_t",
           "int8_dot_plain", "int8_dot_t_plain", "int8_master_matvec", "int8_master_ops"]

# int8 x int8 products accumulate in int32: the worst-case per-output sum is
# 127*127*n_in, so the fan-in must stay below this to be overflow-safe
INT8_DOT_MAX_FAN_IN = (2**31 - 1) // (127 * 127)  # 133144


def quantize_rows(w: torch.Tensor):
    """Symmetric per-output-row int8 quantization of a float master matrix:
    ``(wq int8 (n_out, n_in), scale float32 (n_out,))``."""
    amax = w.abs().amax(dim=1)
    scale = (torch.clamp_min(amax, 1e-30) / 127.0).to(torch.float32)
    wq = torch.clamp(torch.round(w / scale[:, None].to(w.dtype)), -127, 127).to(torch.int8)
    return wq, scale


def quant_vec(x: torch.Tensor):
    """Dynamic symmetric quantization of an activation vector:
    ``(xq int8 (n,), scale float32 0-dim)``.  The scale carries no gradient,
    so the quantized matvec stays exactly linear in ``x`` under STE."""
    x = x.detach()
    s = (torch.clamp_min(x.abs().amax(), 1e-30) / 127.0).to(torch.float32)
    xq = torch.clamp(torch.round(x / s.to(x.dtype)), -127, 127).to(torch.int8)
    return xq, s


# ------------------------------------------------------------------ kernels
def int8_dot_plain(wq: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_dot`: ``float32(wq @ xq)``, summed exactly."""
    return torch.mv(wq.to(torch.float64), xq.to(torch.float64)).to(torch.float32)


def int8_dot_t_plain(wq: torch.Tensor, vq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_dot_t`: ``float32(wq.T @ vq)``, summed exactly."""
    return torch.mv(wq.to(torch.float64).T, vq.to(torch.float64)).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernels' C entry points, built and declared once per process."""
    lib = build("int8_matvec").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_mv_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.int8_mv_t_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.int8_mv_launch.restype = ctypes.c_int
    lib.int8_mv_t_launch.restype = ctypes.c_int
    return lib


def _check(name: str, wq, vec, row_scale, act_scale, n_vec: int):
    """Device, dtype, shape and contiguity checks shared by both wrappers."""
    device = wq.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: wq must be on the current CUDA device, got {device}")
    if wq.dtype != torch.int8 or wq.dim() != 2 or not wq.is_contiguous():
        raise ValueError(f"{name}: wq must be a contiguous 2-D int8 matrix, got "
                         f"{wq.dtype} {tuple(wq.shape)}")
    if vec.device != device or vec.dtype != torch.int8 or tuple(vec.shape) != (n_vec,) \
            or not vec.is_contiguous():
        raise ValueError(f"{name}: the vector must be a contiguous ({n_vec},) int8 tensor on "
                         f"{device}, got {vec.dtype} {tuple(vec.shape)} on {vec.device}")
    if row_scale is not None and (row_scale.device != device
                                  or row_scale.dtype != torch.float32
                                  or tuple(row_scale.shape) != (wq.shape[0],)
                                  or not row_scale.is_contiguous()):
        raise ValueError(f"{name}: the row scale must be a contiguous ({wq.shape[0]},) "
                         f"float32 tensor on {device}")
    if act_scale.device != device or act_scale.dtype != torch.float32 \
            or act_scale.numel() != 1:
        raise ValueError(f"{name}: the activation scale must be one float32 value on {device}")
    if wq.shape[1] >= INT8_DOT_MAX_FAN_IN or wq.shape[0] >= INT8_DOT_MAX_FAN_IN:
        raise ValueError(f"{name}: a dimension of {tuple(wq.shape)} reaches "
                         f"INT8_DOT_MAX_FAN_IN={INT8_DOT_MAX_FAN_IN} (int32 overflow)")


def int8_mv(wq, xq, row_scale, act_scale) -> torch.Tensor:
    """``out[i] = (float32(sum_j wq[i, j] * xq[j]) * row_scale[i]) * act_scale``,
    float32 ``(n_out,)``: the forward int8 matvec with its epilogue.

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/int8_matvec.cu`` on the current stream (``act_scale`` is read on
    the device, so nothing synchronises); anything it does not take raises.
    Each launch adds one to ``int8_mv.launches``."""
    if wq.device.type == "cpu":
        return (int8_dot_plain(wq, xq) * row_scale) * act_scale
    n_out, n_in = wq.shape
    _check("int8_mv", wq, xq, row_scale, act_scale, n_in)
    out = torch.empty(n_out, dtype=torch.float32, device=wq.device)
    vec = int(n_in % 16 == 0 and wq.data_ptr() % 16 == 0 and xq.data_ptr() % 16 == 0)
    err = _lib().int8_mv_launch(wq.data_ptr(), xq.data_ptr(), row_scale.data_ptr(),
                                act_scale.data_ptr(), out.data_ptr(), n_out, n_in, vec,
                                torch.cuda.current_stream(wq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_mv: kernel launch failed with CUDA error {err}")
    int8_mv.launches += 1
    return out


int8_mv.launches = 0


def int8_mv_t(wq, vq, act_scale) -> torch.Tensor:
    """``out[j] = float32(sum_i wq[i, j] * vq[i]) * act_scale``, float32
    ``(n_in,)``: the transposed int8 matvec, read from the row-major ``wq``
    without a transposed copy.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``csrc/int8_matvec.cu``, which sums into an int32 scratch the wrapper
    zeroes (integer sums are exact in any order, so the result does not
    depend on the order of the atomic adds).  Each launch adds one to
    ``int8_mv_t.launches``."""
    if wq.device.type == "cpu":
        return int8_dot_t_plain(wq, vq) * act_scale
    n_out, n_in = wq.shape
    _check("int8_mv_t", wq, vq, None, act_scale, n_out)
    acc = torch.zeros(n_in, dtype=torch.int32, device=wq.device)
    out = torch.empty(n_in, dtype=torch.float32, device=wq.device)
    vec = int(n_in % 16 == 0 and wq.data_ptr() % 16 == 0)
    err = _lib().int8_mv_t_launch(wq.data_ptr(), vq.data_ptr(), act_scale.data_ptr(),
                                  acc.data_ptr(), out.data_ptr(), n_out, n_in, vec,
                                  torch.cuda.current_stream(wq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_mv_t: kernel launch failed with CUDA error {err}")
    int8_mv_t.launches += 1
    return out


int8_mv_t.launches = 0


def int8_dot(wq, xq) -> torch.Tensor:
    """``(n_out, n_in) int8 @ (n_in,) int8 -> float32`` with an exact integer
    sum.  Through the kernel on CUDA tensors (with unit scales); use
    :func:`int8_mv` to fuse the scales."""
    if wq.device.type == "cpu":
        return int8_dot_plain(wq, xq)
    one = torch.ones((), dtype=torch.float32, device=wq.device)
    return int8_mv(wq, xq, torch.ones(wq.shape[0], dtype=torch.float32, device=wq.device), one)


def int8_dot_t(wq, vq) -> torch.Tensor:
    """``W_q^T @ v_q -> float32`` without materializing the transpose."""
    if wq.device.type == "cpu":
        return int8_dot_t_plain(wq, vq)
    return int8_mv_t(wq, vq, torch.ones((), dtype=torch.float32, device=wq.device))


# ------------------------------------------------------------ STE matvecs
def _mv_prepped(wp, src):
    wq, ws = wp
    xq, xs = quant_vec(src)
    return int8_mv(wq, xq, ws, xs).to(src.dtype)


def _mv_t_prepped(wp, delta):
    """W^T @ delta = W_q^T (scale . delta): delta is row-scaled before the
    dynamic quantization, so one scalar activation scale suffices."""
    wq, ws = wp
    v = ws.to(delta.dtype) * delta
    vq, vs = quant_vec(v)
    return int8_mv_t(wq, vq, vs).to(delta.dtype)


def _mv(w, src):
    return _mv_prepped(quantize_rows(w.detach()), src)


def _mv_t(w, delta):
    return _mv_t_prepped(quantize_rows(w.detach()), delta)


def _grad_w(deltas, srcs):
    """dW = Delta^T @ Src in float32 (the master-weight gradient is not
    quantized: STE passes it through at full precision)."""
    return deltas.to(torch.float32).T @ srcs.to(torch.float32)


def int8_master_ops():
    """``(prep, mv, mv_t, grad_w)`` for the deferred-gradient trajectories:
    ``prep`` quantizes the master once per trajectory; ``mv``/``mv_t`` take
    the prepped ``(wq, scale)`` pair."""
    return quantize_rows, _mv_prepped, _mv_t_prepped, _grad_w


class _Int8MasterMatvec(torch.autograd.Function):
    """STE quantized matvec of the plain autograd path: forward int8, the
    backward's ``dsrc`` through the quantized ``W^T`` and ``dW`` as the
    full-precision outer product (the deferred path's numerics)."""

    @staticmethod
    def forward(ctx, w, src):
        ctx.save_for_backward(w, src)
        return _mv(w, src)

    @staticmethod
    def backward(ctx, g):
        w, src = ctx.saved_tensors
        dw = torch.outer(g, src).to(w.dtype) if ctx.needs_input_grad[0] else None
        dsrc = _mv_t(w, g) if ctx.needs_input_grad[1] else None
        return dw, dsrc


def int8_master_matvec(w, src):
    """STE int8 matvec of a float master ``w`` (quantized on every call)."""
    return _Int8MasterMatvec.apply(w, src)
