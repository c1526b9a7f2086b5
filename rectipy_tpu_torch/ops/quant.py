"""int8 and int4 quantized couplings (``'int8_master'``, ``'int4_master'``).

Counterpart of the dense part of ``rectipy_tpu/ops/quant.py``.  The
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

Sources with leading (trial) axes, ``(..., n_in)``, take one activation scale
per row (``quant_vec`` reduces over the last axis), as the JAX package's
``vmap`` gives one per trial; their products are the batched kernels
:func:`int8_mm` and :func:`int8_mm_t`, which read W once for all rows (on
the tensor cores where :func:`int8_mm_route` and :func:`int8_mm_t_route`
say ``"mma"``).  A 1-D source takes the matvecs as before.

Casts follow the JAX package exactly: the int32 sum becomes float32 and is
multiplied ``* row_scale * act_scale`` in that order, in float32, whatever
the network's dtype; ``quant_vec`` rounds its scale to float32 and divides by
that value cast back to the activation's dtype; ``torch.round`` rounds half
to even, as ``jnp.round`` does.

The int4 section (below) is the same scheme one notch down: weights in
[-7, 7] per row, kept at rest in an int8 carrier as the JAX package keeps
them, and packed two per byte (:func:`pack_int4`) for the products, which
are the hand-written kernels of ``csrc/int4_matvec.cu`` (the counterpart of
the packed-int4 Pallas matvec of ``benchmarks/i4pack_microbench.py``):
:func:`int4_mv` and :func:`int4_mv_t` for a vector, :func:`int4_mm` and
:func:`int4_mm_t` for ``(..., n)`` rows, one activation scale each
(:func:`int4_mm` on the tensor cores where :func:`int4_mm_route` says
``"mma"``).

The block-sparse section (at the end) quantizes block couplings per output
row (:func:`quantize_blocks`) and contracts them through the hand-written
kernel of ``csrc/block_int8.cu``, :func:`block_int8_mv` (the gathered int8
block contraction for one or ``B`` rows, which replaces the JAX package's
XLA einsum); the node couplings take it with ``idx = cols``
(:func:`block_int8_matvec`, :func:`make_block_int8_ops`), the delayed edge
with its gathered stack (:func:`make_block_int8_stack_ops`).  Their
transposed contraction (training only) is a PyTorch product.

On a population shard (``parallel/``) a coupling holds the rank's rows and
contracts the gathered whole source.  The STE products then take a
``group`` (``parallel/comm.Group``: the model group's collectives): every
dynamic scale that the unsharded product takes over a whole vector is a
maximum over the group (``quant_vec(..., reduce=group.all_reduce_max)``),
so each rank quantizes with the unsharded scale.  A transposed product of
the coupling rows gives the whole cotangent of the gathered source: the
ranks' integer partial sums are added (:func:`_psum_exact`) before the
scale multiplies them, so the result is the unsharded product's (and the
source's gather sums nothing more).  The delayed block edge's stack is
the rank's own (its rows' gathered blocks): there only the scales are the
group's.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ._build import build

__all__ = ["exact_div", "quantize_rows", "quant_vec", "INT8_DOT_MAX_FAN_IN", "int8_dot",
           "int8_dot_t", "int8_dot_plain", "int8_dot_t_plain", "int8_mm", "int8_mm_t",
           "int8_mm_plain", "int8_mm_t_plain", "int8_mm_route", "int8_mm_t_route",
           "int8_master_matvec", "int8_master_ops", "INT4_DOT_MAX_FAN_IN", "INT4_MV_MAX_FAN_IN",
           "quantize_rows_i4",
           "pack_int4", "unpack_int4", "int4_dot_plain", "int4_dot_t_plain", "int4_mv", "int4_mv_t",
           "int4_mm", "int4_mm_t", "int4_mm_plain", "int4_mm_route", "int4_mm_t_plain",
           "int4_master_matvec", "int4_master_ops", "quantize_blocks", "block_int8_mv",
           "block_int8_mv_plain", "block_int8_mv_route", "block_int8_mv_routes",
           "block_int8_matvec",
           "make_block_int8_ops", "make_block_int8_master_matvec", "make_block_int8_stack_ops",
           "make_block_int8_stack_apply", "block_int8_stack_prepped"]

# int8 x int8 products accumulate in int32: the worst-case per-output sum is
# 127*127*n_in, so the fan-in must stay below this to be overflow-safe
INT8_DOT_MAX_FAN_IN = (2**31 - 1) // (127 * 127)  # 133144


@functools.lru_cache(maxsize=None)
def _divisor(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``dtype`` on ``device``, made once."""
    return torch.tensor(value, dtype=dtype, device=device)


def exact_div(t: torch.Tensor, value: float) -> torch.Tensor:
    """``t / value``, correctly rounded on every device, as the JAX package
    and PyTorch on the CPU divide.  PyTorch's CUDA division by a Python
    scalar multiplies by the scalar's reciprocal, one ulp off for about half
    of all values at ``/ 7`` and 4% at ``/ 127``; a 0-dim divisor on the
    operand's own device and dtype takes the true division.  The divisor is
    made once per value, dtype and device, so a step copies nothing to the
    card.  Every quantization scale of the port goes through here.  While
    ``torch.export`` traces, the divisor is made in the trace (a constant of
    the program), so that no traced tensor enters the cache."""
    if torch.compiler.is_exporting():
        return t / torch.tensor(float(value), dtype=t.dtype, device=t.device)
    return t / _divisor(float(value), t.dtype, t.device)


def quantize_rows(w: torch.Tensor):
    """Symmetric per-output-row int8 quantization of a float master matrix:
    ``(wq int8 (n_out, n_in), scale float32 (n_out,))``; a ``(B, n_out,
    n_in)`` stack of per-trial matrices quantizes each of its rows."""
    amax = w.abs().amax(dim=-1)
    scale = exact_div(torch.clamp_min(amax, 1e-30), 127.0).to(torch.float32)
    wq = torch.clamp(torch.round(w / scale[..., None].to(w.dtype)), -127, 127).to(torch.int8)
    return wq, scale


def quant_vec(x: torch.Tensor, reduce=None):
    """Dynamic symmetric quantization of an activation vector:
    ``(xq int8 (n,), scale float32 0-dim)``.  Rows ``(..., n)`` take one
    scale each, ``(..., 1)``.  The scale carries no gradient, so the
    quantized matvec stays exactly linear in ``x`` under STE.  ``reduce``
    (a population shard's maximum over its model group) makes the scale
    that of the whole vector of which ``x`` holds some rows."""
    x = x.detach()
    amax = x.abs().amax() if x.dim() <= 1 else x.abs().amax(dim=-1, keepdim=True)
    if reduce is not None:
        amax = reduce(amax)
    s = exact_div(torch.clamp_min(amax, 1e-30), 127.0).to(torch.float32)
    xq = torch.clamp(torch.round(x / s.to(x.dtype)), -127, 127).to(torch.int8)
    return xq, s


# ------------------------------------------------------------------ kernels
def int8_dot_plain(wq: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_dot`: ``float32(wq @ xq)``, summed exactly."""
    return torch.mv(wq.to(torch.float64), xq.to(torch.float64)).to(torch.float32)


def int8_dot_t_plain(wq: torch.Tensor, vq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_dot_t`: ``float32(wq.T @ vq)``, summed exactly."""
    return torch.mv(wq.to(torch.float64).T, vq.to(torch.float64)).to(torch.float32)


def int8_mm_plain(wq: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_mm`'s sums: ``float32(xq @ wq.T)`` for
    ``(B, n_in)`` rows, summed exactly."""
    return (xq.to(torch.float64) @ wq.to(torch.float64).T).to(torch.float32)


def int8_mm_t_plain(wq: torch.Tensor, vq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_mm_t`'s sums: ``float32(vq @ wq)`` for
    ``(B, n_out)`` rows, summed exactly."""
    return (vq.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernels' C entry points, built and declared once per process."""
    lib = build("int8_matvec").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_mv_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.int8_mv_t_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.int8_mm_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.int8_mm_t_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.int8_mm_t_scratch.argtypes = [i, i, i, i]
    lib.int8_mm_t_scratch.restype = ctypes.c_longlong
    for fn in (lib.int8_mv_launch, lib.int8_mv_t_launch, lib.int8_mm_launch,
               lib.int8_mm_t_launch):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, wq, vec, row_scale, act_scale, n_vec: int, dtype=torch.int8,
           max_fan_in: int = INT8_DOT_MAX_FAN_IN, n_in: int = None, rows: int = None):
    """Device, dtype, shape and contiguity checks shared by the int8 and int4
    wrappers.  ``wq`` is an int8 matrix, or (``dtype=torch.uint8``) packed
    int4 rows of ``n_in`` weights each; neither dimension of the weights may
    reach ``max_fan_in``.  ``rows``: the batched products take ``(rows,
    n_vec)`` activations and ``(rows,)`` activation scales."""
    device = wq.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: the weights must be on the current CUDA device, got {device}")
    kind = "int8" if dtype == torch.int8 else "packed int4 (uint8)"
    if wq.dtype != dtype or wq.dim() != 2 or not wq.is_contiguous():
        raise ValueError(f"{name}: the weights must be a contiguous 2-D {kind} matrix, got "
                         f"{wq.dtype} {tuple(wq.shape)}")
    if n_in is None:
        n_in = wq.shape[1]
    elif wq.shape[1] < (n_in + 1) // 2:
        raise ValueError(f"{name}: packed rows of {wq.shape[1]} bytes cannot hold {n_in} "
                         f"int4 weights")
    shape, what = ((n_vec,), "vector") if rows is None else ((rows, n_vec), "activations")
    if vec.device != device or vec.dtype != torch.int8 or tuple(vec.shape) != shape \
            or not vec.is_contiguous():
        raise ValueError(f"{name}: the {what} must be a contiguous {shape} int8 tensor on "
                         f"{device}, got {vec.dtype} {tuple(vec.shape)} on {vec.device}")
    if row_scale is not None and (row_scale.device != device
                                  or row_scale.dtype != torch.float32
                                  or tuple(row_scale.shape) != (wq.shape[0],)
                                  or not row_scale.is_contiguous()):
        raise ValueError(f"{name}: the row scale must be a contiguous ({wq.shape[0]},) "
                         f"float32 tensor on {device}")
    if act_scale.device != device or act_scale.dtype != torch.float32 \
            or act_scale.numel() != (rows or 1) or not act_scale.is_contiguous():
        what = "one float32 value" if rows is None else f"{rows} contiguous float32 values"
        raise ValueError(f"{name}: the activation scale must be {what} on {device}")
    if n_in >= max_fan_in or wq.shape[0] >= max_fan_in:
        raise ValueError(f"{name}: a dimension of the ({wq.shape[0]}, {n_in}) weights reaches "
                         f"the fan-in limit {max_fan_in} (int32 overflow)")


def int8_mv(wq, xq, row_scale, act_scale) -> torch.Tensor:
    """``out[i] = (float32(sum_j wq[i, j] * xq[j]) * row_scale[i]) * act_scale``,
    float32 ``(n_out,)``: the forward int8 matvec with its epilogue.

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/int8_matvec.cu`` on the current stream (``act_scale`` is read on
    the device, so nothing synchronises); anything it does not take raises.
    Each launch adds one to ``int8_mv.launches``.  While ``torch.export``
    traces, the call goes to the registered operator ``rectipy::int8_mv``
    instead (``ops/library.py``)."""
    if torch.compiler.is_exporting():
        from . import library

        return library.int8_mv(wq, xq, row_scale, act_scale)
    if wq.device.type == "cpu":
        return (int8_dot_plain(wq, xq) * row_scale) * act_scale
    return int8_mv_launch(wq, xq, row_scale, act_scale)


def int8_mv_launch(wq, xq, row_scale, act_scale) -> torch.Tensor:
    """The kernel launch of :func:`int8_mv` on CUDA tensors (the CUDA
    implementation of ``rectipy::int8_mv``): its checks, the launch and the
    launch counter."""
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


def int8_mm_route(n_in: int, wq_ptr: int) -> str:
    """The instance of :func:`int8_mm` for weights of ``n_in`` columns at
    address ``wq_ptr``: ``"mma"`` (the tensor cores) when ``n_in`` is a
    multiple of 8 and the address of 8 bytes, else ``"scalar"`` (``__dp4a``
    on byte loads).  The activations do not choose: the tensor-core kernel
    stages them with 16-byte copies where their length and address allow,
    and byte by byte otherwise.  The ``"vec"`` instance (``__dp4a`` on
    16-byte loads of W and the activations) wants a subset of the tensor
    cores' conditions, so no route picks it; it stays as their yardstick."""
    return "mma" if n_in % 8 == 0 and wq_ptr % 8 == 0 else "scalar"


# the route codes of int8_mm(_t)_launch and int4_mm(_t)_launch
_ROUTES = {"scalar": 0, "vec": 1, "mma": 2}


def int8_mm(wq, xq, row_scale, act_scale) -> torch.Tensor:
    """``out[b, i] = (float32(sum_j wq[i, j] * xq[b, j]) * row_scale[i]) *
    act_scale[b]``, float32 ``(B, n_out)``: :func:`int8_mv` for ``B`` rows of
    activations ``(B, n_in)``, each with its own scale ``act_scale (B,)``.

    CPU tensors take the plain version.  CUDA tensors launch the kernels of
    ``csrc/int8_matvec.cu`` on the route :func:`int8_mm_route` gives:
    ``"mma"`` sums chunks of columns for up to 32 rows on the tensor cores
    and adds the chunks' sums in shared memory; ``"scalar"`` reads W once
    for up to 32 rows on the CUDA cores.  Integer sums are exact in any
    order; anything the kernels do not take raises.  Each launch adds one to
    ``int8_mm.launches``, and one on the tensor cores also to
    ``int8_mm.mma_launches``.  While ``torch.export`` traces, the call goes
    to the registered operator ``rectipy::int8_mm`` instead
    (``ops/library.py``)."""
    if torch.compiler.is_exporting():
        from . import library

        return library.int8_mm(wq, xq, row_scale, act_scale)
    if wq.device.type == "cpu":
        return (int8_mm_plain(wq, xq) * row_scale) * act_scale[:, None]
    return int8_mm_launch(wq, xq, row_scale, act_scale)


def int8_mm_launch(wq, xq, row_scale, act_scale) -> torch.Tensor:
    """The kernel launch of :func:`int8_mm` on CUDA tensors (the CUDA
    implementation of ``rectipy::int8_mm``): its checks, route, launch and
    launch counters."""
    n_out, n_in = wq.shape
    rows = xq.shape[0] if xq.dim() == 2 else -1
    _check("int8_mm", wq, xq, row_scale, act_scale, n_in, rows=rows)
    out = torch.empty((rows, n_out), dtype=torch.float32, device=wq.device)
    route = int8_mm_route(n_in, wq.data_ptr())
    err = _lib().int8_mm_launch(wq.data_ptr(), xq.data_ptr(), row_scale.data_ptr(),
                                act_scale.data_ptr(), out.data_ptr(), n_out, n_in, rows,
                                _ROUTES[route], torch.cuda.current_stream(wq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_mm: kernel launch failed with CUDA error {err}")
    int8_mm.launches += 1
    if route == "mma":
        int8_mm.mma_launches += 1
    return out


int8_mm.launches = 0
int8_mm.mma_launches = 0  # launches on the tensor cores (int8_mm_route "mma")


def int8_mm_t_route(n_in: int, wq_ptr: int) -> str:
    """The instance of :func:`int8_mm_t` for weights of ``n_in`` columns at
    address ``wq_ptr``: ``"mma"`` (the tensor cores) when ``n_in`` is a
    multiple of 8 and the address of 8 bytes, ``"vec"`` (``__dp4a`` on
    4-byte loads) when they are of 4, else ``"scalar"``.  The activations
    do not choose: the tensor-core kernel stages them with 16-byte copies
    where their length and address allow, and byte by byte otherwise."""
    if n_in % 8 == 0 and wq_ptr % 8 == 0:
        return "mma"
    return "vec" if n_in % 4 == 0 and wq_ptr % 4 == 0 else "scalar"


def int8_mm_t(wq, vq, act_scale) -> torch.Tensor:
    """``out[b, j] = float32(sum_i wq[i, j] * vq[b, i]) * act_scale[b]``,
    float32 ``(B, n_in)``: :func:`int8_mv_t` for ``B`` rows ``(B, n_out)``,
    read from the row-major ``wq`` without a transposed copy.

    CPU tensors take the plain version; CUDA tensors launch the kernels of
    ``csrc/int8_matvec.cu`` on the route :func:`int8_mm_t_route` gives:
    ``"mma"`` sums chunks of rows on the tensor cores and adds the chunks'
    sums in shared memory (one launch, no scratch); the other routes sum
    chunks of rows on the CUDA cores into an int32 scratch and then the
    chunks.  Integer sums are exact in any order.  Each launch adds one to
    ``int8_mm_t.launches``, and one on the tensor cores also to
    ``int8_mm_t.mma_launches``."""
    if wq.device.type == "cpu":
        return int8_mm_t_plain(wq, vq) * act_scale[:, None]
    n_out, n_in = wq.shape
    rows = vq.shape[0] if vq.dim() == 2 else -1
    _check("int8_mm_t", wq, vq, None, act_scale, n_out, rows=rows)
    lib = _lib()
    route = int8_mm_t_route(n_in, wq.data_ptr())
    code = _ROUTES[route]
    size = lib.int8_mm_t_scratch(n_out, n_in, rows, code)
    scratch = torch.empty(size, dtype=torch.int32, device=wq.device)
    out = torch.empty((rows, n_in), dtype=torch.float32, device=wq.device)
    err = lib.int8_mm_t_launch(wq.data_ptr(), vq.data_ptr(), act_scale.data_ptr(),
                               scratch.data_ptr(), out.data_ptr(), n_out, n_in, rows, code,
                               torch.cuda.current_stream(wq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_mm_t: kernel launch failed with CUDA error {err}")
    int8_mm_t.launches += 1
    if route == "mma":
        int8_mm_t.mma_launches += 1
    return out


int8_mm_t.launches = 0
int8_mm_t.mma_launches = 0  # launches on the tensor cores (int8_mm_t_route "mma")


def int8_product(wq, xq, row_scale, act_scale) -> torch.Tensor:
    """The forward int8 product for any source: :func:`int8_mv` for a
    vector, :func:`int8_mm` for rows ``(..., n_in)`` (leading axes flattened,
    ``act_scale`` of shape ``(..., 1)``), and, for per-trial weights ``(B,
    n_out, n_in)`` (a swept coupling: nothing to share), one :func:`int8_mv`
    per trial."""
    if xq.dim() == 1:
        return int8_mv(wq, xq, row_scale, act_scale)
    if wq.dim() == 3:  # a frozen coupling's row scale is shared, a master's per trial
        return torch.stack([int8_mv(wq[b], xq[b], row_scale[b] if row_scale.dim() == 2
                                    else row_scale, act_scale[b])
                            for b in range(wq.shape[0])])
    lead = xq.shape[:-1]
    out = int8_mm(wq, xq.reshape(-1, xq.shape[-1]), row_scale, act_scale.reshape(-1))
    return out.reshape(*lead, wq.shape[0])


def int8_product_t(wq, vq, act_scale) -> torch.Tensor:
    """The transposed int8 product for any source, as :func:`int8_product`
    dispatches the forward one."""
    if vq.dim() == 1:
        return int8_mv_t(wq, vq, act_scale)
    if wq.dim() == 3:
        return torch.stack([int8_mv_t(wq[b], vq[b], act_scale[b]) for b in range(wq.shape[0])])
    lead = vq.shape[:-1]
    out = int8_mm_t(wq, vq.reshape(-1, vq.shape[-1]), act_scale.reshape(-1))
    return out.reshape(*lead, wq.shape[1])


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
    return int8_product(wq, xq, ws, xs).to(src.dtype)


def _amax(group):
    """The scale reduction of a population shard's products: the maximum
    over the model group (None: an unsharded product)."""
    return None if group is None else group.all_reduce_max


def _psum_exact(part: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group of each rank's integer partial sums
    ``part`` (exact integers in a float type, as the kernels give them): the
    sums travel as int32, the unsharded kernels' accumulator, so the total
    is the unsharded product's integer sum, rounded to float32 once."""
    return group.all_reduce(part.to(torch.int32)).to(torch.float32)


def _mv_t_prepped(wp, delta, group=None):
    """W^T @ delta = W_q^T (scale . delta): delta is row-scaled before the
    dynamic quantization, so one activation scale per row suffices.
    ``group``: ``wp`` holds a population shard's rows and ``delta`` their
    cotangent; the scale is the group's maximum, and the result the whole
    ``W^T @ delta`` (the ranks' integer sums added before the scale)."""
    wq, ws = wp
    v = ws.to(delta.dtype) * delta
    vq, vs = quant_vec(v, reduce=_amax(group))
    if group is None:
        return int8_product_t(wq, vq, vs).to(delta.dtype)
    part = int8_product_t(wq, vq, torch.ones_like(vs))
    total = _psum_exact(part, group)
    return (total * vs).to(delta.dtype)


def _mv(w, src):
    return _mv_prepped(quantize_rows(w.detach()), src)


def _mv_t(w, delta, group=None):
    return _mv_t_prepped(quantize_rows(w.detach()), delta, group)


def _grad_w(deltas, srcs):
    """dW = Delta^T @ Src in float32 (the master-weight gradient is not
    quantized: STE passes it through at full precision).  Every leading axis
    (time, and trials) is contracted: ``(T, B, n)`` factors make ONE
    ``(n_out, T*B) @ (T*B, n_in)`` product, the sum over trials of each
    trial's ``Delta_b^T @ Src_b``."""
    d = deltas.to(torch.float32)
    sr = srcs.to(torch.float32)
    return d.reshape(-1, d.shape[-1]).T @ sr.reshape(-1, sr.shape[-1])


def _outer_sum(g, src):
    """``sum over the leading axes of outer(g, src)``: the per-step weight
    gradient of the plain autograd path (one outer product for a vector)."""
    if g.dim() == 1:
        return torch.outer(g, src)
    return g.reshape(-1, g.shape[-1]).T @ src.reshape(-1, src.shape[-1])


def int8_master_ops(group=None):
    """``(prep, mv, mv_t, grad_w)`` for the deferred-gradient trajectories:
    ``prep`` quantizes the master once per trajectory; ``mv``/``mv_t`` take
    the prepped ``(wq, scale)`` pair.  ``group``: a population shard's
    coupling rows, whose ``mv_t`` gives the whole cotangent."""
    return quantize_rows, _mv_prepped, functools.partial(_mv_t_prepped, group=group), _grad_w


class _Int8MasterMatvec(torch.autograd.Function):
    """STE quantized matvec of the plain autograd path: forward int8, the
    backward's ``dsrc`` through the quantized ``W^T`` and ``dW`` as the
    full-precision outer product (the deferred path's numerics)."""

    @staticmethod
    def forward(ctx, w, src, group):
        ctx.save_for_backward(w, src)
        ctx.group = group
        return _mv(w, src)

    @staticmethod
    def backward(ctx, g):
        w, src = ctx.saved_tensors
        dw = _outer_sum(g, src).to(w.dtype) if ctx.needs_input_grad[0] else None
        dsrc = _mv_t(w, g, ctx.group) if ctx.needs_input_grad[1] else None
        return dw, dsrc, None


def int8_master_matvec(w, src, group=None):
    """STE int8 matvec of a float master ``w`` (quantized on every call).
    ``group``: ``w`` holds a population shard's rows; the source's gradient
    is the whole one, at the group's cotangent scale (:func:`_mv_t_prepped`),
    so its gather must not sum it again."""
    return _Int8MasterMatvec.apply(w, src, group)


# -------------------------------------------------------------------- int4
# The couplings quantize to [-7, 7]: worst case 7*127*n_in per output sum.
INT4_DOT_MAX_FAN_IN = (2**31 - 1) // (7 * 127)  # 2415617
# The kernels take the full nibble range [-8, 7]: worst case 8*127*n_in.
INT4_MV_MAX_FAN_IN = (2**31 - 1) // (8 * 127)  # 2113664


def quantize_rows_i4(w: torch.Tensor):
    """Symmetric per-output-row quantization to [-7, 7]: ``(wq int8 carrier
    (n_out, n_in), scale float32 (n_out,))``, the JAX package's casts; a
    ``(B, n_out, n_in)`` stack of per-trial matrices quantizes each of its
    rows."""
    amax = w.abs().amax(dim=-1)
    scale = exact_div(torch.clamp_min(amax, 1e-30), 7.0).to(torch.float32)
    wq = torch.clamp(torch.round(w / scale[..., None].to(w.dtype)), -7, 7).to(torch.int8)
    return wq, scale


def int4_stride(n_in: int) -> int:
    """Bytes per packed row: ``ceil(n_in / 2)`` rounded up to 16, so that
    every row starts 16-byte aligned."""
    return -(-((n_in + 1) // 2) // 16) * 16


def pack_int4(wq: torch.Tensor) -> torch.Tensor:
    """``(..., n_out, n_in)`` integers in [-8, 7] -> ``(..., n_out,
    int4_stride(n_in))`` uint8.  Byte ``k`` of row ``i`` holds ``wq[i, 2k] +
    8`` in its low nibble and ``wq[i, 2k+1] + 8`` in its high nibble (offset
    binary); the nibbles past ``n_in`` hold 8, a zero weight.  Per output
    row, this is the transpose of the Pallas kernel's packing
    (``i4pack_microbench.py``).  A ``(B, n_out, n_in)`` stack (a swept
    coupling) packs each trial's matrix."""
    n_in = wq.shape[-1]
    nib = torch.full(wq.shape[:-1] + (2 * int4_stride(n_in),), 8, dtype=torch.uint8,
                     device=wq.device)
    nib[..., :n_in] = (wq.to(torch.int16) + 8).to(torch.uint8)
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).contiguous()


def unpack_int4(wp: torch.Tensor, n_in: int) -> torch.Tensor:
    """The inverse of :func:`pack_int4`: ``(n_out, n_in)`` int8 in [-8, 7]."""
    lo = (wp & 15).to(torch.int8) - 8
    hi = (wp >> 4).to(torch.int8) - 8
    return torch.stack((lo, hi), dim=-1).reshape(wp.shape[0], -1)[:, :n_in]


def _nibble_planes(wp: torch.Tensor, n_sum: int):
    """The low and high nibbles of ``wp`` (the even and odd weights, each
    offset by 8) as floats, and that float type: float32 where every
    partial sum of up to ``n_sum`` products (at most 15 * 127 each) is an
    integer below 2^24, hence exact (the Pallas kernel's own argument), else
    float64."""
    dt = torch.float32 if 15 * 127 * n_sum < 2 ** 24 else torch.float64
    return (wp & 15).to(dt), (wp >> 4).to(dt), dt


def int4_dot_plain(wp: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int4_mv`'s sum: ``float32(W @ xq)`` for the
    packed ``wp``, summed exactly as the Pallas kernel sums it,
    ``x_even @ (lo - 8) + x_odd @ (hi - 8)``, with the offset taken off
    once."""
    n_in = xq.shape[0]
    lo, hi, dt = _nibble_planes(wp, wp.shape[1])
    x = torch.zeros(2 * wp.shape[1], dtype=dt, device=xq.device)
    x[:n_in] = xq.to(dt)
    acc = torch.mv(lo, x[0::2]).to(torch.float64) + torch.mv(hi, x[1::2]).to(torch.float64)
    return (acc - 8.0 * xq.to(torch.float64).sum()).to(torch.float32)


def int4_dot_t_plain(wp: torch.Tensor, vq: torch.Tensor, n_in: int) -> torch.Tensor:
    """Plain version of :func:`int4_mv_t`'s sum: ``float32(W.T @ vq)``,
    summed exactly."""
    lo, hi, dt = _nibble_planes(wp, wp.shape[0])
    v = vq.to(dt)
    acc = torch.stack((torch.mv(lo.T, v), torch.mv(hi.T, v)), dim=1).reshape(-1)[:n_in]
    return (acc.to(torch.float64) - 8.0 * vq.to(torch.float64).sum()).to(torch.float32)


def int4_mm_plain(wp: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int4_mm`'s sums: ``float32(xq @ W.T)`` for
    ``(B, n_in)`` rows and the packed ``wp``, summed exactly (the even and
    the odd weights apart, the offset taken off once, as
    :func:`int4_dot_plain`)."""
    B, n_in = xq.shape
    lo, hi, dt = _nibble_planes(wp, wp.shape[1])
    x = torch.zeros((B, 2 * wp.shape[1]), dtype=dt, device=xq.device)
    x[:, :n_in] = xq.to(dt)
    acc = (x[:, 0::2] @ lo.T).to(torch.float64) + (x[:, 1::2] @ hi.T).to(torch.float64)
    return (acc - 8.0 * xq.to(torch.float64).sum(dim=1, keepdim=True)).to(torch.float32)


def int4_mm_t_plain(wp: torch.Tensor, vq: torch.Tensor, n_in: int) -> torch.Tensor:
    """Plain version of :func:`int4_mm_t`'s sums: ``float32(vq @ W)`` for
    ``(B, n_out)`` rows, summed exactly."""
    B = vq.shape[0]
    lo, hi, dt = _nibble_planes(wp, wp.shape[0])
    v = vq.to(dt)
    acc = torch.stack((v @ lo, v @ hi), dim=2).reshape(B, -1)[:, :n_in]
    return (acc.to(torch.float64)
            - 8.0 * vq.to(torch.float64).sum(dim=1, keepdim=True)).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _lib4():
    lib = build("int4_matvec").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int4_mv_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.int4_mv_t_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.int4_mm_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.int4_mm_t_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    for fn in (lib.int4_mv_launch, lib.int4_mv_t_launch, lib.int4_mm_launch,
               lib.int4_mm_t_launch):
        fn.restype = ctypes.c_int
    lib.int4_mv_t_scratch.argtypes = [i, i, i]
    lib.int4_mv_t_scratch.restype = ctypes.c_longlong
    lib.int4_mm_t_scratch.argtypes = [i, i, i, i]
    lib.int4_mm_t_scratch.restype = ctypes.c_longlong
    return lib


def int4_vector_path(wp: torch.Tensor, vec: torch.Tensor = None) -> bool:
    """Whether the kernels take their 16-byte path: the packed rows start
    16-byte aligned (a stride of a multiple of 16 on an aligned base) and,
    for :func:`int4_mv`, so does ``xq``.  Anything else takes the scalar
    instantiation."""
    ok = wp.shape[1] % 16 == 0 and wp.data_ptr() % 16 == 0
    return bool(ok and (vec is None or vec.data_ptr() % 16 == 0))


def int4_mv(wp, xq, row_scale, act_scale) -> torch.Tensor:
    """``out[i] = (float32(sum_j W[i, j] * xq[j]) * row_scale[i]) * act_scale``,
    float32 ``(n_out,)``, for the packed int4 ``wp`` (:func:`pack_int4`,
    any stride that holds ``len(xq)`` weights) and int8 ``xq``.

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    ``csrc/int4_matvec.cu`` on the current stream; anything it does not take
    raises.  Each launch adds one to ``int4_mv.launches``.  While
    ``torch.export`` traces, the call goes to the registered operator
    ``rectipy::int4_mv`` instead (``ops/library.py``)."""
    if torch.compiler.is_exporting():
        from . import library

        return library.int4_mv(wp, xq, row_scale, act_scale)
    if wp.device.type == "cpu":
        return (int4_dot_plain(wp, xq) * row_scale) * act_scale
    return int4_mv_launch(wp, xq, row_scale, act_scale)


def int4_mv_launch(wp, xq, row_scale, act_scale) -> torch.Tensor:
    """The kernel launch of :func:`int4_mv` on CUDA tensors (the CUDA
    implementation of ``rectipy::int4_mv``): its checks, the launch and the
    launch counter."""
    n_out, n_in = wp.shape[0], xq.shape[0]
    _check("int4_mv", wp, xq, row_scale, act_scale, n_in, dtype=torch.uint8,
           max_fan_in=INT4_MV_MAX_FAN_IN, n_in=n_in)
    out = torch.empty(n_out, dtype=torch.float32, device=wp.device)
    err = _lib4().int4_mv_launch(wp.data_ptr(), xq.data_ptr(), row_scale.data_ptr(),
                                 act_scale.data_ptr(), out.data_ptr(), n_out, n_in, wp.shape[1],
                                 int(int4_vector_path(wp, xq)),
                                 torch.cuda.current_stream(wp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4_mv: kernel launch failed with CUDA error {err}")
    int4_mv.launches += 1
    return out


int4_mv.launches = 0


def int4_mv_t(wp, vq, act_scale, n_in: int) -> torch.Tensor:
    """``out[j] = float32(sum_i W[i, j] * vq[i]) * act_scale``, float32
    ``(n_in,)``: the transposed product, read from the row-major packed
    ``wp`` without a transposed copy (``n_in``: the weights per row).

    CPU tensors take the plain version; CUDA tensors launch the kernels of
    ``csrc/int4_matvec.cu``, which sum chunks of rows into an int32 scratch
    and then the chunks (exact in any order).  Each launch adds one to
    ``int4_mv_t.launches``."""
    if wp.device.type == "cpu":
        return int4_dot_t_plain(wp, vq, n_in) * act_scale
    n_out = wp.shape[0]
    _check("int4_mv_t", wp, vq, None, act_scale, n_out, dtype=torch.uint8,
           max_fan_in=INT4_MV_MAX_FAN_IN, n_in=n_in)
    lib, vec = _lib4(), int(int4_vector_path(wp))
    partial = torch.empty(lib.int4_mv_t_scratch(n_out, n_in, vec), dtype=torch.int32,
                          device=wp.device)
    out = torch.empty(n_in, dtype=torch.float32, device=wp.device)
    err = lib.int4_mv_t_launch(wp.data_ptr(), vq.data_ptr(), act_scale.data_ptr(),
                               partial.data_ptr(), out.data_ptr(), n_out, n_in, wp.shape[1], vec,
                               torch.cuda.current_stream(wp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4_mv_t: kernel launch failed with CUDA error {err}")
    int4_mv_t.launches += 1
    return out


int4_mv_t.launches = 0


def int4_mm_route(stride: int, wp_ptr: int) -> str:
    """The instance of :func:`int4_mm` for packed rows of ``stride`` bytes at
    address ``wp_ptr``: ``"mma"`` (the tensor cores) when the stride is a
    multiple of 16 and the address of 16 bytes, which every
    :func:`pack_int4` output is, else ``"scalar"`` (``__dp4a`` one nibble at
    a time).  The activations do not choose: the tensor-core kernel stages
    them with 16-byte copies where their length and address allow, and byte
    by byte otherwise.  The ``"vec"`` instance (``__dp4a`` on 16-byte loads)
    wants a subset of the tensor cores' conditions, so no route picks it; it
    stays as their yardstick."""
    return "mma" if stride % 16 == 0 and wp_ptr % 16 == 0 else "scalar"


def int4_mm(wp, xq, row_scale, act_scale) -> torch.Tensor:
    """``out[b, i] = (float32(sum_j W[i, j] * xq[b, j]) * row_scale[i]) *
    act_scale[b]``, float32 ``(B, n_out)``: :func:`int4_mv` for ``B`` rows of
    activations ``(B, n_in)``, each with its own scale ``act_scale (B,)``.

    CPU tensors take the plain version.  CUDA tensors launch the kernels of
    ``csrc/int4_matvec.cu`` on the current stream, on the route
    :func:`int4_mm_route` gives: ``"mma"`` sums chunks of columns for up to
    32 rows on the tensor cores and adds the chunks' sums in shared memory;
    ``"scalar"`` reads the packed W once for up to 32 rows on the CUDA
    cores.  Integer sums are exact in any order; anything the kernels do not
    take raises.  Each launch adds one to ``int4_mm.launches``, and one on
    the tensor cores also to ``int4_mm.mma_launches``.  While
    ``torch.export`` traces, the call goes to the registered operator
    ``rectipy::int4_mm`` instead (``ops/library.py``)."""
    if torch.compiler.is_exporting():
        from . import library

        return library.int4_mm(wp, xq, row_scale, act_scale)
    if wp.device.type == "cpu":
        return (int4_mm_plain(wp, xq) * row_scale) * act_scale[:, None]
    return int4_mm_launch(wp, xq, row_scale, act_scale)


def int4_mm_launch(wp, xq, row_scale, act_scale) -> torch.Tensor:
    """The kernel launch of :func:`int4_mm` on CUDA tensors (the CUDA
    implementation of ``rectipy::int4_mm``): its checks, route, launch and
    launch counters."""
    n_out = wp.shape[0]
    rows, n_in = xq.shape if xq.dim() == 2 else (-1, -1)
    _check("int4_mm", wp, xq, row_scale, act_scale, n_in, dtype=torch.uint8,
           max_fan_in=INT4_MV_MAX_FAN_IN, n_in=n_in, rows=rows)
    out = torch.empty((rows, n_out), dtype=torch.float32, device=wp.device)
    route = int4_mm_route(wp.shape[1], wp.data_ptr())
    err = _lib4().int4_mm_launch(wp.data_ptr(), xq.data_ptr(), row_scale.data_ptr(),
                                 act_scale.data_ptr(), out.data_ptr(), n_out, n_in, wp.shape[1],
                                 rows, _ROUTES[route],
                                 torch.cuda.current_stream(wp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4_mm: kernel launch failed with CUDA error {err}")
    int4_mm.launches += 1
    if route == "mma":
        int4_mm.mma_launches += 1
    return out


int4_mm.launches = 0
int4_mm.mma_launches = 0  # launches on the tensor cores (int4_mm_route "mma")


def int4_mm_t_route(stride: int, wp_ptr: int) -> str:
    """The instance of :func:`int4_mm_t` for packed rows of ``stride`` bytes
    at address ``wp_ptr``: ``"mma"`` (the tensor cores) when the stride is a
    multiple of 16 and the address of 16 bytes, which every
    :func:`pack_int4` output is, else ``"scalar"`` (``__dp4a`` one nibble at
    a time), as :func:`int4_mm_route`.  The ``"vec"`` instance (``__dp4a`` on
    2-byte loads of the packed rows), which :func:`int4_vector_path` chose
    under the same conditions, stays reachable through the C launch as the
    tensor cores' yardstick."""
    return int4_mm_route(stride, wp_ptr)


def int4_mm_t(wp, vq, act_scale, n_in: int) -> torch.Tensor:
    """``out[b, j] = float32(sum_i W[i, j] * vq[b, i]) * act_scale[b]``,
    float32 ``(B, n_in)``: :func:`int4_mv_t` for ``B`` rows ``(B, n_out)``,
    read from the row-major packed ``wp`` without a transposed copy.

    CPU tensors take the plain version.  CUDA tensors launch the kernels of
    ``csrc/int4_matvec.cu`` on the route :func:`int4_mm_t_route` gives:
    ``"mma"`` sums chunks of rows for up to 32 rows of activations on the
    tensor cores and adds the chunks' sums in shared memory (one launch, no
    scratch); ``"scalar"`` sums chunks of rows on the CUDA cores into an
    int32 scratch and then the chunks.  Integer sums are exact in any order.
    Each launch adds one to ``int4_mm_t.launches``, and one on the tensor
    cores also to ``int4_mm_t.mma_launches``."""
    if wp.device.type == "cpu":
        return int4_mm_t_plain(wp, vq, n_in) * act_scale[:, None]
    n_out = wp.shape[0]
    rows = vq.shape[0] if vq.dim() == 2 else -1
    _check("int4_mm_t", wp, vq, None, act_scale, n_out, dtype=torch.uint8,
           max_fan_in=INT4_MV_MAX_FAN_IN, n_in=n_in, rows=rows)
    lib = _lib4()
    route = int4_mm_t_route(wp.shape[1], wp.data_ptr())
    code = _ROUTES[route]
    partial = torch.empty(lib.int4_mm_t_scratch(n_out, n_in, rows, code), dtype=torch.int32,
                          device=wp.device)
    out = torch.empty((rows, n_in), dtype=torch.float32, device=wp.device)
    err = lib.int4_mm_t_launch(wp.data_ptr(), vq.data_ptr(), act_scale.data_ptr(),
                               partial.data_ptr(), out.data_ptr(), n_out, n_in, wp.shape[1], rows,
                               code, torch.cuda.current_stream(wp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4_mm_t: kernel launch failed with CUDA error {err}")
    int4_mm_t.launches += 1
    if route == "mma":
        int4_mm_t.mma_launches += 1
    return out


int4_mm_t.launches = 0
int4_mm_t.mma_launches = 0  # launches on the tensor cores (int4_mm_t_route "mma")


def _i4_prep(w):
    """int4_master prep: float master -> ``(packed weights, row scale,
    n_in)``; the packed form replaces the JAX package's int4 cast.  A ``(B,
    n_out, n_in)`` stack (a swept coupling) preps each trial's matrix."""
    wq, scale = quantize_rows_i4(w)
    return pack_int4(wq), scale, w.shape[-1]


def int4_product(wp, xq, row_scale, act_scale) -> torch.Tensor:
    """The forward int4 product for any source, as :func:`int8_product`
    dispatches the int8 one: :func:`int4_mv` for a vector, :func:`int4_mm`
    for rows ``(..., n_in)`` (leading axes flattened, ``act_scale`` of shape
    ``(..., 1)``), and, for per-trial packed weights ``(B, n_out, stride)``
    (a swept coupling: nothing to share), one :func:`int4_mv` per trial."""
    if xq.dim() == 1:
        return int4_mv(wp, xq, row_scale, act_scale)
    if wp.dim() == 3:  # a frozen coupling's row scale is shared, a master's per trial
        return torch.stack([int4_mv(wp[b], xq[b], row_scale[b] if row_scale.dim() == 2
                                    else row_scale, act_scale[b])
                            for b in range(wp.shape[0])])
    lead = xq.shape[:-1]
    out = int4_mm(wp, xq.reshape(-1, xq.shape[-1]), row_scale, act_scale.reshape(-1))
    return out.reshape(*lead, wp.shape[0])


def int4_product_t(wp, vq, act_scale, n_in: int) -> torch.Tensor:
    """The transposed int4 product for any source, as :func:`int4_product`
    dispatches the forward one."""
    if vq.dim() == 1:
        return int4_mv_t(wp, vq, act_scale, n_in)
    if wp.dim() == 3:
        return torch.stack([int4_mv_t(wp[b], vq[b], act_scale[b], n_in)
                            for b in range(wp.shape[0])])
    lead = vq.shape[:-1]
    out = int4_mm_t(wp, vq.reshape(-1, vq.shape[-1]), act_scale.reshape(-1), n_in)
    return out.reshape(*lead, n_in)


def _mv4_prepped(wp, src):
    xq, xs = quant_vec(src)
    return int4_product(wp[0], xq, wp[1], xs).to(src.dtype)


def _mv4_t_prepped(wp, delta, group=None):
    """W^T @ delta with the row scales folded into delta before the dynamic
    quantization, as in :func:`_mv_t_prepped` (``group`` too: a population
    shard's rows, the products ``int4_mv_t``/``int4_mm_t`` on them at a unit
    scale, the group's sum of their integer sums, then the scale)."""
    v = wp[1].to(delta.dtype) * delta
    vq, vs = quant_vec(v, reduce=_amax(group))
    if group is None:
        return int4_product_t(wp[0], vq, vs, wp[2]).to(delta.dtype)
    part = int4_product_t(wp[0], vq, torch.ones_like(vs), wp[2])
    total = _psum_exact(part, group)
    return (total * vs).to(delta.dtype)


def int4_master_ops(group=None):
    """``(prep, mv, mv_t, grad_w)`` of an ``int4_master`` coupling for the
    deferred-gradient trajectories: the int4 counterpart of
    :func:`int8_master_ops` (same STE, same full-precision master
    gradient, the same ``group``)."""
    return _i4_prep, _mv4_prepped, functools.partial(_mv4_t_prepped, group=group), _grad_w


class _Int4MasterMatvec(torch.autograd.Function):
    """STE int4 matvec of the plain autograd path (the int4 counterpart of
    :class:`_Int8MasterMatvec`)."""

    @staticmethod
    def forward(ctx, w, src, group):
        ctx.save_for_backward(w, src)
        ctx.group = group
        return _mv4_prepped(_i4_prep(w.detach()), src)

    @staticmethod
    def backward(ctx, g):
        w, src = ctx.saved_tensors
        dw = _outer_sum(g, src).to(w.dtype) if ctx.needs_input_grad[0] else None
        dsrc = _mv4_t_prepped(_i4_prep(w), g, ctx.group) if ctx.needs_input_grad[1] else None
        return dw, dsrc, None


def int4_master_matvec(w, src, group=None):
    """STE int4 matvec of a float master ``w`` (quantized on every call;
    ``group`` as :func:`int8_master_matvec`'s)."""
    return _Int4MasterMatvec.apply(w, src, group)


# -------------------------------------------------------------- block-sparse
# The int8 block couplings (the JAX package's rectipy_tpu/ops/quant.py:236-462):
# per-output-row scales over each row's cb*bs stored inputs, the dynamic
# activation scale of quant_vec, exact integer sums.  The forward contraction
# is the hand-written kernel of csrc/block_int8.cu (block_int8_mv); the
# transposed one (training only) is a float32 product over bs-long sums,
# exact below 2^24, then the reduction over source blocks.


def _quantize_block_rows(b: torch.Tensor):
    amax = b.abs().amax(dim=(1, 3))  # (R, bs)
    scale = exact_div(torch.clamp_min(amax, 1e-30), 127.0).to(torch.float32)
    bq = torch.clamp(torch.round(b / scale[:, None, :, None].to(b.dtype)), -127, 127)
    return bq.to(torch.int8), scale


def quantize_blocks(blocks: torch.Tensor):
    """Symmetric per-output-row int8 quantization of a block-sparse master
    ``(n_br, cb, bs, bs)``: each output row ``(r, i)`` gets one scale over
    its ``cb * bs`` stored inputs.  Returns ``(bq int8, scale float32 (n_br,
    bs))``; a per-trial stack ``(B, n_br, cb, bs, bs)`` quantizes each
    trial's rows.  Every scale belongs to one row, so the rows quantize a
    chunk at a time (``ops.sparse.CHUNK_ELEMS`` elements) with the same
    result as one pass: a million-neuron master is 8 GB of float32, and one
    pass would hold several temporaries of its size."""
    from .sparse import CHUNK_ELEMS

    lead, (n_br, cb, bs) = blocks.shape[:-4], blocks.shape[-4:-1]
    flat = blocks.reshape(-1, cb, bs, bs)
    step = max(1, CHUNK_ELEMS // (cb * bs * bs))
    if flat.shape[0] <= step:
        bq, scale = _quantize_block_rows(flat)
    else:
        bq = torch.empty(flat.shape, dtype=torch.int8, device=flat.device)
        scale = torch.empty((flat.shape[0], bs), dtype=torch.float32, device=flat.device)
        for lo in range(0, flat.shape[0], step):
            bq[lo:lo + step], scale[lo:lo + step] = _quantize_block_rows(flat[lo:lo + step])
    return bq.reshape(blocks.shape), scale.reshape(*lead, n_br, bs)


def quantize_blocks_host(blocks, device):
    """:func:`quantize_blocks` of the float32 values of a host array
    ``(n_br, cb, bs, bs)`` (the frozen ``int8`` coupling's build), moved to
    ``device`` and quantized a chunk of block rows at a time: the float32
    blocks never lie on the device whole."""
    from .sparse import CHUNK_ELEMS

    src = torch.from_numpy(np.ascontiguousarray(blocks))
    n_br, cb, bs, _ = src.shape
    bq = torch.empty(src.shape, dtype=torch.int8, device=device)
    scale = torch.empty((n_br, bs), dtype=torch.float32, device=device)
    step = max(1, CHUNK_ELEMS // (cb * bs * bs))
    for lo in range(0, n_br, step):
        chunk = src[lo:lo + step].to(device).to(torch.float32)
        bq[lo:lo + step], scale[lo:lo + step] = _quantize_block_rows(chunk)
    return bq, scale


def block_int8_mv_plain(bq, row_scale, xq, idx) -> torch.Tensor:
    """Plain version of :func:`block_int8_mv`: ``float32(sum_c sum_j bq[r,
    c, i, j] * xq[b, idx[r, c], j]) * row_scale[r, i]`` as ``(B, n_br *
    bs)``, summed exactly a chunk of block rows at a time: each block's
    ``bs``-long sums in float32 (below 127^2 * bs < 2^24 for bs < 1040;
    float64 beyond), their sum over the ``cb`` blocks in float64."""
    from .sparse import CHUNK_ELEMS

    n_br, cb, bs, _ = bq.shape
    B = xq.shape[0]
    dt = torch.float32 if 127 * 127 * bs < 2 ** 24 else torch.float64
    out = torch.empty((B, n_br * bs), dtype=torch.float32, device=bq.device)
    idx = idx.long()
    step = max(1, CHUNK_ELEMS // (cb * bs * bs))
    for lo in range(0, n_br, step):
        hi = min(n_br, lo + step)
        a = bq[lo:hi].to(dt).reshape(-1, bs, bs)
        x = xq[:, idx[lo:hi]].to(dt).permute(1, 2, 3, 0).reshape(-1, bs, B)
        acc = torch.bmm(a, x).to(torch.float64).reshape(hi - lo, cb, bs, B).sum(1)  # exact
        out[:, lo * bs:hi * bs] = (acc.permute(2, 0, 1).reshape(B, -1).to(torch.float32)
                                   * row_scale[lo:hi].reshape(-1))
    return out


@functools.lru_cache(maxsize=None)
def _lib_block():
    """The block kernel's C entry points, built and declared once per process."""
    lib = build("block_int8").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.block_int8_mv_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.block_int8_mv_launch.restype = ctypes.c_int
    return lib


# the route codes of block_int8_mv_launch
_BLOCK_ROUTES = {"scalar": 0, "vec4": 1, "vec16": 2, "mma": 3}


def block_int8_mv_routes(bs: int, bq_ptr: int, xq_ptr: int) -> tuple:
    """Every route of :func:`block_int8_mv`'s kernels that blocks of ``bs``
    at ``bq_ptr`` and activations at ``xq_ptr`` allow: ``"mma"`` (the
    tensor cores: ``bs % 32 == 0``, both addresses 16-byte aligned),
    ``"vec16"`` (``__dp4a`` on 16-byte pieces: ``bs % 16 == 0``, the same
    alignment), ``"vec4"`` (4-byte pieces, 4-byte alignment) and
    ``"scalar"`` (bytes), as ``block_int8_mv_launch`` checks them."""
    addr = bq_ptr | xq_ptr
    return tuple(name for name, ok in (
        ("mma", bs % 32 == 0 and addr % 16 == 0), ("vec16", bs % 16 == 0 and addr % 16 == 0),
        ("vec4", bs % 4 == 0 and addr % 4 == 0), ("scalar", True)) if ok)


def block_int8_mv_route(bs: int, bq_ptr: int, xq_ptr: int) -> str:
    """The route :func:`block_int8_mv` takes for blocks of ``bs`` at
    ``bq_ptr`` and activations at ``xq_ptr``: the first of
    :func:`block_int8_mv_routes`, the tensor cores wherever the shapes allow
    them (they were faster at every trial count measured; see
    ``csrc/block_int8.cu``), else the widest ``__dp4a`` pieces."""
    return block_int8_mv_routes(bs, bq_ptr, xq_ptr)[0]


def _check_block(bq, row_scale, xq, idx) -> None:
    device = bq.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"block_int8_mv: the blocks must be on the current CUDA device, "
                         f"got {device}")
    if bq.dtype != torch.int8 or bq.dim() != 4 or bq.shape[2] != bq.shape[3] \
            or not bq.is_contiguous():
        raise ValueError(f"block_int8_mv: the blocks must be a contiguous (n_br, cb, bs, bs) "
                         f"int8 tensor, got {bq.dtype} {tuple(bq.shape)}")
    n_br, cb, bs, _ = bq.shape
    if xq.device != device or xq.dtype != torch.int8 or xq.dim() != 3 or xq.shape[2] != bs \
            or not xq.is_contiguous():
        raise ValueError(f"block_int8_mv: the activations must be a contiguous (B, n_src, {bs}) "
                         f"int8 tensor on {device}, got {xq.dtype} {tuple(xq.shape)} on "
                         f"{xq.device}")
    if row_scale.device != device or row_scale.dtype != torch.float32 \
            or row_scale.numel() != n_br * bs or not row_scale.is_contiguous():
        raise ValueError(f"block_int8_mv: the row scale must be a contiguous ({n_br}, {bs}) "
                         f"float32 tensor on {device}")
    if idx.device != device or idx.dtype != torch.int32 or tuple(idx.shape) != (n_br, cb) \
            or not idx.is_contiguous():
        raise ValueError(f"block_int8_mv: the index table must be a contiguous ({n_br}, {cb}) "
                         f"int32 tensor on {device}")
    if cb * bs >= INT8_DOT_MAX_FAN_IN:
        raise ValueError(f"block_int8_mv: a row of {cb} x {bs} inputs reaches the fan-in limit "
                         f"{INT8_DOT_MAX_FAN_IN} (int32 overflow)")


def block_int8_mv(bq, row_scale, xq, idx, route=None) -> torch.Tensor:
    """``out[b, r*bs + i] = float32(sum_c sum_j bq[r, c, i, j] * xq[b, idx[r,
    c], j]) * row_scale[r, i]``, float32 ``(B, n_br * bs)``: the gathered
    int8 block contraction with its row scales, for ``B`` rows of int8
    activations cut into ``bs``-long blocks, ``xq (B, n_src, bs)``.  Every
    entry of ``idx`` must lie in ``[0, n_src)``.  The caller applies the
    activation scale.

    CPU tensors take the plain version.  CUDA tensors launch a kernel of
    ``csrc/block_int8.cu`` on the current stream, on ``route`` (default
    :func:`block_int8_mv_route`'s; one that the shapes do not allow raises):
    ``"mma"`` on the tensor cores, ``"vec16"``, ``"vec4"`` or ``"scalar"``
    on the CUDA cores' ``__dp4a``.  Anything the kernels do not take
    raises.  The integer sums are exact, so every route and the plain
    version agree bit for bit.  Each launch adds one to
    ``block_int8_mv.launches``, a launch on the tensor cores also to
    ``block_int8_mv.mma_launches``.  While ``torch.export`` traces, the call
    goes to the registered operator ``rectipy::block_int8_mv`` instead
    (``ops/library.py``), whose CUDA implementation takes the default
    route; a forced route cannot be exported."""
    if torch.compiler.is_exporting():
        if route is not None:
            raise ValueError("block_int8_mv: a forced route cannot be exported; the "
                             "operator takes block_int8_mv_route's")
        from . import library

        return library.block_int8_mv(bq, row_scale, xq, idx)
    if bq.device.type == "cpu":
        return block_int8_mv_plain(bq, row_scale, xq, idx)
    return block_int8_mv_launch(bq, row_scale, xq, idx, route)


def block_int8_mv_launch(bq, row_scale, xq, idx, route=None) -> torch.Tensor:
    """The kernel launch of :func:`block_int8_mv` on CUDA tensors (the CUDA
    implementation of ``rectipy::block_int8_mv``, with the default route):
    its checks, route, launch and launch counters."""
    _check_block(bq, row_scale, xq, idx)
    n_br, cb, bs, _ = bq.shape
    B, n_src = xq.shape[0], xq.shape[1]
    if route is None:
        route = block_int8_mv_route(bs, bq.data_ptr(), xq.data_ptr())
    elif route not in block_int8_mv_routes(bs, bq.data_ptr(), xq.data_ptr()):
        raise ValueError(f"block_int8_mv: route {route!r} does not take bs={bs} at these "
                         f"addresses")
    out = torch.empty((B, n_br * bs), dtype=torch.float32, device=bq.device)
    err = _lib_block().block_int8_mv_launch(
        bq.data_ptr(), row_scale.data_ptr(), xq.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n_br, cb, bs, n_src, B, _BLOCK_ROUTES[route],
        torch.cuda.current_stream(bq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_int8_mv: kernel launch failed with CUDA error {err}")
    block_int8_mv.launches += 1
    if route == "mma":
        block_int8_mv.mma_launches += 1
    return out


block_int8_mv.launches = 0
block_int8_mv.mma_launches = 0  # launches on the tensor cores (route "mma")


def block_int8_product(bq, row_scale, xq, idx) -> torch.Tensor:
    """:func:`block_int8_mv` for shared blocks, or, for per-trial blocks
    ``(B, n_br, cb, bs, bs)`` (a swept coupling), one launch per trial with
    its row scale (a frozen coupling's is shared, a master's per trial)."""
    if bq.dim() == 4:
        return block_int8_mv(bq, row_scale, xq, idx)
    return torch.cat([block_int8_mv(bq[b], row_scale[b] if row_scale.dim() == 3 else row_scale,
                                    xq[b:b + 1], idx) for b in range(bq.shape[0])])


def _rows_scale(s: torch.Tensor) -> torch.Tensor:
    """A quant_vec scale (0-dim, or ``(..., 1)``) as ``(L, 1)``."""
    return s.reshape(-1, 1)


def block_int8_matvec(wp, cols, src) -> torch.Tensor:
    """The forward block contraction from the prepped ``(bq, scale)`` pair
    (the JAX package's ``block_int8_mv(wp, cols, src)``): the source
    quantized by ``quant_vec`` (one scale per row of ``(..., n)``), the
    kernel's ``float32(acc) * scale``, then ``* xs`` in float32, returned in
    ``src``'s dtype."""
    bq, scale = wp
    n_br, bs = bq.shape[-4], bq.shape[-2]
    xq, xs = quant_vec(src)
    acc = block_int8_product(bq, scale, xq.reshape(-1, src.shape[-1] // bs, bs),
                             cols.to(device=bq.device, dtype=torch.int32))
    return (acc * _rows_scale(xs)).reshape(*src.shape[:-1], n_br * bs).to(src.dtype)


def _block_t_contrib(bq, vq) -> torch.Tensor:
    """``contrib[l, r, c, j] = sum_i bq[r, c, i, j] * vq[l, r, i]`` for
    ``vq (L, n_br, bs)`` int8, exact: a float32 product over ``bs``-long
    sums (each below 127^2 * bs < 2^24 for bs < 1040; float64 beyond)."""
    n_br, cb, bs, _ = bq.shape
    L = vq.shape[0]
    dt = torch.float32 if 127 * 127 * bs < 2 ** 24 else torch.float64
    a = bq.reshape(n_br * cb, bs, bs).to(dt).transpose(1, 2)
    v = vq.to(dt).permute(1, 2, 0)[:, None].expand(n_br, cb, bs, L).reshape(n_br * cb, bs, L)
    c = torch.bmm(a, v).to(torch.float32)
    return c.reshape(n_br, cb, bs, L).permute(3, 0, 1, 2)


def _onehot_col_matrix(cols_np, n_bc: int = None) -> torch.Tensor:
    """One-hot block-column membership ``M (n_br*cb, n_bc)``: ``M[r*cb +
    slot, cols[r, slot]] = 1``; the reduction over column blocks as one
    product.  ``n_bc``, the column blocks, defaults to ``n_br`` (a square
    coupling; a population shard holds some of its block rows)."""
    n_br, cb = cols_np.shape
    M = np.zeros((n_br * cb, n_bc or n_br), dtype=np.float32)
    M[np.arange(n_br * cb), np.asarray(cols_np).ravel()] = 1.0
    return torch.as_tensor(M)


def _transposed_block_table(cols_np, n_bc: int = None):
    """The transposed block structure of the gather backward: for each of
    the ``n_bc`` column blocks (default ``n_br``: a square coupling), the
    (row block, slot) pairs with ``cols[r, slot] == c``, padded to the
    largest in-degree (``rows_T``, ``slot_T``, ``mask_T``)."""
    n_br, cb = cols_np.shape
    n_bc = n_bc or n_br
    lists = [[] for _ in range(n_bc)]
    for r in range(n_br):
        for j in range(cb):
            lists[int(cols_np[r, j])].append((r, j))
    cb_t = max(1, max(len(entry) for entry in lists))
    rows_T = np.zeros((n_bc, cb_t), dtype=np.int64)
    slot_T = np.zeros((n_bc, cb_t), dtype=np.int64)
    mask_T = np.zeros((n_bc, cb_t), dtype=np.float32)
    for c, pairs in enumerate(lists):
        for k, (r, j) in enumerate(pairs):
            rows_T[c, k], slot_T[c, k], mask_T[c, k] = r, j, 1.0
    return torch.as_tensor(rows_T), torch.as_tensor(slot_T), torch.as_tensor(mask_T)


def sparse_bwd_mode() -> str:
    """``RECTIPY_SPARSE_BWD``: the column-block reduction of the transposed
    block contraction, ``scatter`` (default), ``gather`` or ``onehot``;
    read when a coupling's ops are built, as the JAX package reads it."""
    mode = os.environ.get("RECTIPY_SPARSE_BWD", "scatter")
    if mode not in ("scatter", "gather", "onehot"):
        raise ValueError(f"RECTIPY_SPARSE_BWD={mode!r}: use 'scatter', 'gather' or 'onehot'")
    return mode


def _np_cols(cols) -> np.ndarray:
    return (cols.detach().cpu().numpy() if isinstance(cols, torch.Tensor)
            else np.asarray(cols)).astype(np.int64)


def block_grad_w(deltas, srcs, cols, cast=None) -> torch.Tensor:
    """``dA[r, c] = sum_t delta_t[row block r] (x) src_t[block cols[r, c]]``
    over every leading (time, trial) axis, one batched product: ``deltas
    (..., n_br*bs)``, ``srcs (..., n_in)``; float32 result.  Float64 factors
    sum in float64 and round once (the JAX package's
    ``preferred_element_type=float32``); ``cast`` rounds both factors first
    (bfloat16: exact products, float32 sums)."""
    n_br, cb = cols.shape
    bs = deltas.shape[-1] // n_br
    d = deltas.reshape(-1, n_br, bs)
    s = srcs.reshape(-1, srcs.shape[-1] // bs, bs)[:, cols.long().to(srcs.device)]
    if cast is not None:
        d, s = d.to(cast), s.to(cast)
    acc = torch.float64 if torch.float64 in (d.dtype, s.dtype) else torch.float32
    M = d.shape[0]
    dA = torch.bmm(d.to(acc).permute(1, 2, 0), s.to(acc).permute(1, 0, 2, 3).reshape(n_br, M, cb * bs))
    return dA.reshape(n_br, bs, cb, bs).permute(0, 2, 1, 3).contiguous().to(torch.float32)


def make_block_int8_ops(cols, n_bc: int = None, group=None):
    """``(prep, mv, mv_t, grad_w)`` of an ``int8_master`` block-sparse
    coupling for the deferred-gradient trajectories; ``cols (n_br, cb)`` is
    its block structure (a tensor or an array).  ``RECTIPY_SPARSE_BWD`` is
    read here, when the ops are built.  ``n_bc``: the source's column
    blocks (default ``n_br``: a square coupling).  ``group``: ``cols`` are a
    population shard's block rows (``n_bc`` the whole source's); the
    cotangent's scale is the group's maximum, and ``mv_t`` gives the whole
    source cotangent: the group's sum of the ranks' integer sums times the
    scale."""
    cols_np = _np_cols(cols)
    n_br, cb = cols_np.shape
    n_bc = n_bc or n_br
    cols_t = torch.as_tensor(cols_np.astype(np.int32))
    mode = sparse_bwd_mode()
    table = _transposed_block_table(cols_np, n_bc) if mode == "gather" else None
    onehot = _onehot_col_matrix(cols_np, n_bc) if mode == "onehot" else None
    amax = _amax(group)

    def mv(wp, src):
        return block_int8_matvec(wp, cols_t.to(wp[0].device), src)

    def mv_t(wp, delta):
        """``A^T @ delta``: the row scales fold into delta before the
        dynamic quantization; exact integer contractions in the forward
        tile layout, then the mode's reduction over column blocks."""
        bq, scale = wp
        bs = bq.shape[-2]
        lead = delta.shape[:-1]
        v = scale.to(delta.dtype) * delta.reshape(*lead, n_br, bs)
        vq, vs = quant_vec(v.reshape(*lead, n_br * bs), reduce=amax)
        vq = vq.reshape(-1, n_br, bs)
        L, dev = vq.shape[0], bq.device
        if mode == "gather":
            rows_T, slot_T, mask_T = (t.to(dev) for t in table)
            G = bq[rows_T, slot_T].to(torch.float64)  # (n_bc, cb_t, bs, bs)
            D = vq[:, rows_T].to(torch.float64) * mask_T[..., None].to(torch.float64)
            out = torch.einsum("qcij,lqci->lqj", G, D)  # exact: float64 integer sums
            out = out if group is not None else out.to(torch.float32)
        else:
            contrib = _block_t_contrib(bq, vq).reshape(L, n_br * cb, bs)
            if mode == "onehot":
                out = torch.einsum("lkj,kq->lqj", contrib, onehot.to(dev))
            else:
                out = torch.zeros((L, n_bc, bs), dtype=torch.float32, device=dev)
                out.index_add_(1, cols_t.to(dev).long().reshape(-1), contrib)
        out = out.reshape(L, n_bc * bs)
        if group is not None:
            out = _psum_exact(out, group)
        out = out * _rows_scale(vs)
        return out.reshape(*lead, n_bc * bs).to(delta.dtype)

    def grad_w(deltas, srcs):
        """The master's gradient in float32, never quantized (STE)."""
        return block_grad_w(deltas.to(torch.float32), srcs.to(torch.float32), cols_t)

    return quantize_blocks, mv, mv_t, grad_w


class _BlockInt8MasterMatvec(torch.autograd.Function):
    """STE quantized block matvec of the plain autograd path: the forward
    quantizes the master and contracts in int8, the backward takes ``dsrc``
    through the quantized transpose and ``dA`` as the full-precision
    product (the deferred trajectory's numerics)."""

    @staticmethod
    def forward(ctx, blocks, src, ops):
        prep, mv, _, _ = ops
        ctx.save_for_backward(blocks, src)
        ctx.ops = ops
        return mv(prep(blocks.detach()), src)

    @staticmethod
    def backward(ctx, g):
        blocks, src = ctx.saved_tensors
        prep, _, mv_t, grad_w = ctx.ops
        db = grad_w(g, src).to(blocks.dtype) if ctx.needs_input_grad[0] else None
        dsrc = mv_t(prep(blocks.detach()), g) if ctx.needs_input_grad[1] else None
        return db, dsrc, None


def make_block_int8_master_matvec(cols, n_bc: int = None, group=None):
    """STE quantized block-sparse matvec ``f(blocks, src)`` of an
    ``int8_master`` coupling for the plain autograd path (the deferred
    trajectories use :func:`make_block_int8_ops` and prep once); ``n_bc``
    and ``group`` as there."""
    ops = make_block_int8_ops(cols, n_bc, group)

    def f(blocks, src):
        return _BlockInt8MasterMatvec.apply(blocks, src, ops)

    return f


_STACK_IDX: dict = {}


def _stack_idx(n_br: int, cb: int, device) -> torch.Tensor:
    """``arange(n_br * cb)`` as the ``(n_br, cb)`` int32 index table of a
    gathered stack, made once per shape and device."""
    if torch.compiler.is_exporting():  # a constant of the program, never cached
        return torch.arange(n_br * cb, dtype=torch.int32, device=device).reshape(n_br, cb)
    key = (n_br, cb, str(device))
    if key not in _STACK_IDX:
        _STACK_IDX[key] = torch.arange(n_br * cb, dtype=torch.int32,
                                       device=device).reshape(n_br, cb)
    return _STACK_IDX[key]


def _stack_mv(wp, s_blk, group=None):
    """The forward contraction of a gathered stack, one dynamic activation
    scale over the stack (``group``: a shard's block rows of it, the scale
    the group's maximum, the whole stack's)."""
    bq, scale = wp
    n_br, cb, bs = bq.shape[-4], bq.shape[-3], bq.shape[-2]
    lead = s_blk.shape[:-3]
    xq, xs = quant_vec(s_blk.reshape(*lead, n_br * cb * bs), reduce=_amax(group))
    acc = block_int8_product(bq, scale, xq.reshape(-1, n_br * cb, bs),
                             _stack_idx(n_br, cb, bq.device))
    return (acc * _rows_scale(xs)).reshape(*lead, n_br * bs)


def _stack_mv_t(wp, delta, group=None):
    """``W^T @ delta`` in gathered form ``(..., n_br, cb, bs)``, float32:
    the row scales fold into delta (in float32) before the dynamic
    quantization (``group``: a shard's rows, the scale the group's
    maximum; each block's cotangent is the unsharded one)."""
    bq, scale = wp
    n_br, cb, bs = bq.shape[-4], bq.shape[-3], bq.shape[-2]
    lead = delta.shape[:-1]
    v = scale * delta.reshape(*lead, n_br, bs).to(torch.float32)
    vq, vs = quant_vec(v.reshape(*lead, n_br * bs), reduce=_amax(group))
    contrib = _block_t_contrib(bq, vq.reshape(-1, n_br, bs))
    out = contrib * _rows_scale(vs)[:, :, None, None]
    return out.reshape(*lead, n_br, cb, bs)


def _stack_grad_w(deltas, srcs):
    """``dW[r, c] = sum_t delta_t[row r] (x) src_t[r, c]`` in float32 (STE)
    over every leading axis; ``srcs (..., n_br, cb, bs)``."""
    n_br, cb, bs = srcs.shape[-3:]
    d = deltas.reshape(-1, n_br, bs).to(torch.float32)
    s = srcs.reshape(-1, n_br, cb * bs).to(torch.float32)
    dW = torch.bmm(d.permute(1, 2, 0), s.permute(1, 0, 2))  # (n_br, bs, cb*bs)
    return dW.reshape(n_br, bs, cb, bs).permute(0, 2, 1, 3).contiguous()


def make_block_int8_stack_ops(group=None):
    """``(prep, mv, mv_t, grad_w)`` of ``int8_master`` contractions on an
    already gathered ``(..., n_br, cb, bs)`` source stack: the delayed
    ``BlockSparseLinear`` edge, whose history read resolves each block's
    delay before the contraction.  One dynamic activation scale per stack
    (per trial), taken over the gathered blocks; on the card the forward
    launches ``block_int8_mv`` with ``idx = arange(n_br * cb)``.
    ``group``: the stack of a population shard's block rows; both scales
    are the group's maxima (the whole stack's, the whole cotangent's)."""
    if group is None:
        return quantize_blocks, _stack_mv, _stack_mv_t, _stack_grad_w
    return (quantize_blocks, functools.partial(_stack_mv, group=group),
            functools.partial(_stack_mv_t, group=group), _stack_grad_w)


class _BlockStackApply(torch.autograd.Function):
    """The STE apply of a trainable ``int8_master`` edge: the master
    quantized in the step, the backward's ``dW`` at full precision and
    ``ds`` through the quantized transpose."""

    @staticmethod
    def forward(ctx, blocks, s_blk, group):
        ctx.save_for_backward(blocks, s_blk)
        ctx.group = group
        return _stack_mv(quantize_blocks(blocks.detach()), s_blk, group)

    @staticmethod
    def backward(ctx, g):
        blocks, s_blk = ctx.saved_tensors
        db = _stack_grad_w(g, s_blk).to(blocks.dtype) if ctx.needs_input_grad[0] else None
        ds = (_stack_mv_t(quantize_blocks(blocks.detach()), g, ctx.group).to(s_blk.dtype)
              if ctx.needs_input_grad[1] else None)
        return db, ds, None


def make_block_int8_stack_apply(group=None):
    """The STE-wrapped single-step apply ``f(blocks, s_blk)`` of the
    gathered-stack form (the trainable edge's in-step quantization;
    ``group`` as :func:`make_block_int8_stack_ops`')."""
    return lambda blocks, s_blk: _BlockStackApply.apply(blocks, s_blk, group)


class _BlockStackPrepped(torch.autograd.Function):
    """The prepped (frozen) ``int8_master`` edge's contraction: the forward
    from the once-per-run ``(bq, scale)``, and the source gradient of the
    stack form's STE ``mv_t``.  (The JAX package's frozen edge takes plain
    autodiff through its int8 einsum here and gives exactly zero source
    gradients; the port does not copy that.)"""

    @staticmethod
    def forward(ctx, s_blk, bq, scale, group):
        ctx.wp = (bq, scale)
        ctx.dtype = s_blk.dtype
        ctx.group = group
        return _stack_mv((bq, scale), s_blk, group)

    @staticmethod
    def backward(ctx, g):
        return _stack_mv_t(ctx.wp, g, ctx.group).to(ctx.dtype), None, None, None


def block_int8_stack_prepped(wp, s_blk, group=None) -> torch.Tensor:
    """:func:`make_block_int8_stack_ops`' forward on prepped ``wp``, with
    the STE source gradient (``group`` as there)."""
    return _BlockStackPrepped.apply(s_blk, wp[0], wp[1], group)
