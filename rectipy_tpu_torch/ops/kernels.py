"""Fused QIF+SFA Euler step: plain PyTorch version, CUDA kernel, node attach.

Counterpart of ``rectipy_tpu/ops/kernels.py``.  The benchmark-dominant op is
one explicit-Euler step of a QIF(+SFA) spiking population with dense
coupling: a bandwidth-bound ``W @ s`` matvec fused with the elementwise
vector field, threshold test and hard reset.

- :func:`qif_sfa_reference_step` is the plain PyTorch version (a copy of the
  JAX oracle).  For a bfloat16 W it rounds ``s`` to bfloat16 before the
  product, as the TPU kernel does, and sums in float32.
- :func:`qif_sfa_step` launches the hand-written CUDA kernel
  ``csrc/qif_sfa_step.cu`` for CUDA tensors and takes the plain version for
  CPU tensors.  There is no fallback: a CUDA tensor the kernel does not take
  raises.
- :func:`attach_fused_qif_step` swaps a qif/qif_sfa ``SpikeResetNet``'s step
  for the kernel (forward path only).

Each takes one state ``(n,)`` or, for ``Network.run_batch``, ``B`` trials'
states ``(B, n)`` that share W (the TPU kernel under the JAX package's
``vmap``): the B-row kernel reads W once for up to 32 trials.  An aligned
bfloat16 W takes its tensor-core instance, an aligned float32 W its tiled
instance on the CUDA cores (:func:`rows_route`).

The kernels have no backward (nor has the TPU kernel), so on the card the
wrappers raise when autograd would need one; the plain version on CPU
tensors is what autograd sees there.

W stays row-major and unpadded: the JAX package's transposed, tile-padded
copy and padded state layout existed for the TPU's matrix unit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..dsl.lower import matvec
from ..nodes import resolve_dtype
from ._build import build
from .generic_fused import refuse_autograd

__all__ = ["qif_sfa_reference_step", "qif_sfa_step", "qif_sfa_launch", "qif_sfa_rows_step",
           "rows_route", "attach_fused_qif_step"]

# elements per 16-byte vector load of W
_VEC_ELEMS = {torch.float32: 4, torch.bfloat16: 8}
# the B-row C entry's route codes ("vec", the CUDA cores' older f32 vector
# instance, is reached only through the C entry: no route picks it)
_ROWS_ROUTES = {"scalar": 0, "vec": 1, "mma": 2, "tiled": 3}


def qif_sfa_reference_step(v, s, x, W, eta, inp, *, dt, tau, tau_s, tau_x, k, alpha,
                           thresh, v_reset):
    """Plain PyTorch version of one QIF+SFA SpikeResetNet Euler step, for a
    state ``(n,)`` or trials' states ``(B, n)`` (any operand may be ``(n,)``,
    shared by the trials)."""
    spikes = torch.heaviside(v - thresh, torch.ones((), dtype=v.dtype, device=v.device)) / dt
    reset = spikes * dt  # 0/1 mask
    if W.dtype in (torch.bfloat16, torch.float16):
        s_in = matvec(W.to(torch.float32), s.to(W.dtype).to(torch.float32)).to(v.dtype)
    else:
        s_in = matvec(W.to(s.dtype), s)
    dv = (v * v + (eta - x) + inp) / tau + k * s_in
    ds = -s / tau_s + spikes
    dx = -x / tau_x + alpha * spikes
    v_new = (v + dt * dv) * (1.0 - reset) + reset * v_reset
    return v_new, s + dt * ds, x + dt * dx


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The kernel's C entry point, built and declared once per process."""
    fn = build("qif_sfa_step").lib.qif_sfa_step_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, i, p, p, p, p, p, p, p, p, i, f, f, f, f, f, f, f, f, f, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _rows_launch_fn():
    """The B-row kernel's C entry point."""
    fn = build("qif_sfa_step").lib.qif_sfa_rows_launch
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn.argtypes = [p, i, i, p, p, p, p, p, ll, ll, ll, ll, ll, p, i, i,
                   f, f, f, f, f, f, f, f, f, p]
    fn.restype = ctypes.c_int
    return fn


def _check_vec(name: str, t: torch.Tensor, n: int, device: torch.device):
    if t.device != device:
        raise ValueError(f"qif_sfa_step: {name} is on {t.device}, W on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"qif_sfa_step: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != (n,):
        raise ValueError(f"qif_sfa_step: {name} must have shape ({n},), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"qif_sfa_step: {name} must be contiguous")


def qif_sfa_step(v, s, x, W, eta, inp, *, dt, tau, tau_s, tau_x, k, alpha, thresh, v_reset):
    """One fused QIF+SFA step.  Returns a new ``(3, n)`` float32 tensor whose
    rows are ``v'``, ``s'`` and ``x'`` (so ``v2, s2, x2 = qif_sfa_step(...)``
    unpacks it); the inputs are never written.  For ``B`` trials ``v`` is
    ``(B, n)`` and the result ``(B, 3, n)``: :func:`qif_sfa_rows_step`.

    A W on the CPU takes :func:`qif_sfa_reference_step`.  A W on the GPU
    launches the kernel on the current stream: W ``(n, n)`` float32 or
    bfloat16, the five vectors ``(n,)`` float32, all contiguous and on the
    current device; anything else raises.  Each launch adds one to
    ``qif_sfa_step.launches``.

    While ``torch.export`` traces, the call goes to the registered operator
    ``rectipy::qif_sfa_step`` (``rectipy::qif_sfa_rows_step`` for ``B``
    trials) instead, which an exported program can hold (``ops/library.py``).
    """
    if torch.compiler.is_exporting():
        from . import library

        op = library.qif_sfa_rows_step if v.dim() == 2 else library.qif_sfa_step
        return op(v, s, x, W, eta, inp, float(dt), float(tau), float(tau_s), float(tau_x),
                  float(k), float(alpha), float(thresh), float(v_reset))
    device = W.device
    if device.type == "cpu" or v.dim() == 2:
        if device.type == "cpu":
            return torch.stack(qif_sfa_reference_step(
                v, s, x, W, eta, inp, dt=dt, tau=tau, tau_s=tau_s, tau_x=tau_x, k=k,
                alpha=alpha, thresh=thresh, v_reset=v_reset), dim=-2)
        return qif_sfa_rows_step(v, s, x, W, eta, inp, dt=dt, tau=tau, tau_s=tau_s,
                                 tau_x=tau_x, k=k, alpha=alpha, thresh=thresh, v_reset=v_reset)
    return qif_sfa_launch(v, s, x, W, eta, inp, dt=dt, tau=tau, tau_s=tau_s, tau_x=tau_x, k=k,
                          alpha=alpha, thresh=thresh, v_reset=v_reset)


def qif_sfa_launch(v, s, x, W, eta, inp, *, dt, tau, tau_s, tau_x, k, alpha, thresh, v_reset):
    """The single-state kernel launch of :func:`qif_sfa_step` on CUDA tensors
    (the CUDA implementation of ``rectipy::qif_sfa_step``): its checks, the
    launch and the launch counter."""
    device = W.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(
            f"qif_sfa_step: W must be on the current CUDA device, got {device}")
    refuse_autograd("qif_sfa_step", (v, s, x, W, eta, inp))
    n = v.shape[0] if v.dim() == 1 else -1
    if W.dtype not in _VEC_ELEMS:
        raise ValueError(f"qif_sfa_step: W must be float32 or bfloat16, got {W.dtype}")
    if tuple(W.shape) != (n, n) or not W.is_contiguous():
        raise ValueError(
            f"qif_sfa_step: W must be a contiguous ({n}, {n}) matrix, got {tuple(W.shape)}")
    for name, t in (("v", v), ("s", s), ("x", x), ("eta", eta), ("inp", inp)):
        _check_vec(name, t, n, device)

    out = torch.empty((3, n), dtype=torch.float32, device=device)
    vec = (n % _VEC_ELEMS[W.dtype] == 0 and W.data_ptr() % 16 == 0
           and s.data_ptr() % 16 == 0)
    base = out.data_ptr()
    err = _launch_fn()(
        W.data_ptr(), int(W.dtype == torch.bfloat16), int(vec),
        v.data_ptr(), s.data_ptr(), x.data_ptr(), eta.data_ptr(), inp.data_ptr(),
        base, base + 4 * n, base + 8 * n, n,
        float(dt), 1.0 / dt, 1.0 / tau, 1.0 / tau_s, 1.0 / tau_x, float(k), float(alpha),
        float(thresh), float(v_reset), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qif_sfa_step: kernel launch failed with CUDA error {err}")
    qif_sfa_step.launches += 1
    return out


qif_sfa_step.launches = 0
qif_sfa_step.mma_launches = 0  # B-row launches on the tensor cores (rows_route "mma")
qif_sfa_step.tiled_launches = 0  # B-row launches of the tiled f32 kernel (rows_route "tiled")


def rows_route(w_dtype, n: int, ld_s: int, w_ptr: int, s_ptr: int) -> str:
    """The B-row kernel's instance for a W of ``w_dtype``, rows of ``n``
    inputs, a row stride ``ld_s`` of s and the addresses of W and s:
    ``"mma"`` (a bfloat16 W on the tensor cores) or ``"tiled"`` (a float32
    W on the CUDA cores: register micro-tiles, W and s through a ring in
    shared memory) when ``n`` is a multiple of the vector width (8
    bfloat16, 4 float32), ``ld_s`` of 4 and both addresses of 16 bytes;
    else ``"scalar"``.  A float32 W stays on the CUDA cores, where its
    numbers are the plain version's; TF32 would change them."""
    if n % _VEC_ELEMS[w_dtype] or ld_s % 4 or w_ptr % 16 or s_ptr % 16:
        return "scalar"
    return "mma" if w_dtype == torch.bfloat16 else "tiled"


def qif_sfa_rows_step(v, s, x, W, eta, inp, *, dt, tau, tau_s, tau_x, k, alpha, thresh,
                      v_reset):
    """One fused QIF+SFA step of ``B`` trials that share W, through the B-row
    kernel of ``csrc/qif_sfa_step.cu``: ``v (B, n)``; ``s``, ``x``, ``eta``
    and ``inp`` each ``(B, n)`` or ``(n,)`` (one row shared by every trial),
    float32, each row contiguous (the rows may be strided: the node's ``(B,
    3n)`` state is read in place).  Returns a new ``(B, 3, n)`` float32
    tensor (``v'``, ``s'``, ``x'`` per trial).  CUDA tensors only (a CPU W
    takes the plain version through :func:`qif_sfa_step`); anything the
    kernel does not take raises.  Each launch adds one to
    ``qif_sfa_step.launches``, and one on the tensor cores also to
    ``qif_sfa_step.mma_launches``, one of the tiled f32 kernel to
    ``qif_sfa_step.tiled_launches``."""
    device = W.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(
            f"qif_sfa_step: W must be on the current CUDA device, got {device}")
    refuse_autograd("qif_sfa_step", (v, s, x, W, eta, inp))
    if v.dim() != 2:
        raise ValueError(f"qif_sfa_step: B-row v must be (B, n), got {tuple(v.shape)}")
    rows, n = v.shape
    if W.dtype not in _VEC_ELEMS:
        raise ValueError(f"qif_sfa_step: W must be float32 or bfloat16, got {W.dtype}")
    if tuple(W.shape) != (n, n) or not W.is_contiguous():
        raise ValueError(
            f"qif_sfa_step: W must be a contiguous ({n}, {n}) matrix, got {tuple(W.shape)}")
    lds = []
    for name, t in (("v", v), ("s", s), ("x", x), ("eta", eta), ("inp", inp)):
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"qif_sfa_step: {name} must be float32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if t.shape not in ((rows, n), (n,)) or t.stride(-1) != 1:
            raise ValueError(f"qif_sfa_step: {name} must be ({rows}, {n}) or ({n},) with "
                             f"contiguous rows, got {tuple(t.shape)} strides {t.stride()}")
        lds.append(t.stride(0) if t.dim() == 2 else 0)
    out = torch.empty((rows, 3, n), dtype=torch.float32, device=device)
    route = rows_route(W.dtype, n, lds[1], W.data_ptr(), s.data_ptr())
    err = _rows_launch_fn()(
        W.data_ptr(), int(W.dtype == torch.bfloat16), _ROWS_ROUTES[route],
        v.data_ptr(), s.data_ptr(), x.data_ptr(), eta.data_ptr(), inp.data_ptr(), *lds,
        out.data_ptr(), n, rows,
        float(dt), 1.0 / dt, 1.0 / tau, 1.0 / tau_s, 1.0 / tau_x, float(k), float(alpha),
        float(thresh), float(v_reset), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qif_sfa_step: B-row kernel launch failed with CUDA error {err}")
    qif_sfa_step.launches += 1
    if route == "mma":
        qif_sfa_step.mma_launches += 1
    elif route == "tiled":
        qif_sfa_step.tiled_launches += 1
    return out


def attach_fused_qif_step(node, weights_dtype=None) -> None:
    """Swap a qif / qif_sfa ``SpikeResetNet``'s step for the fused kernel
    (forward path; training keeps the differentiable plain path).

    Requirements: homogeneous scalar model parameters except ``eta`` (which
    may be a per-neuron array), ``output_var='s'``, framework-managed reset
    on ``v``, and float32 node state (the kernel writes float32).
    ``weights_dtype`` (float32 or bfloat16) is the kernel's copy of the
    coupling; default: the node's coupling dtype.  Raises ``ValueError``
    when the node does not qualify.

    The node keeps its state layout ``[v | s | (x)]``, its records,
    ``get_var`` and ``reset``.  ``set_param`` refreshes ``eta`` and
    ``weights`` in the kernel's copies and raises for the scalars.
    """
    if getattr(node, "_fused_attached", False):
        raise ValueError(
            "A fused step is already attached to this node. Rebuild the node to "
            "change the kernel configuration.")
    vm = node._var_map
    n = node._vf.n
    has_x = isinstance(vm.get("x"), tuple)
    order = ["v", "s"] + (["x"] if has_x else [])
    for name in ("v", "s"):
        if not isinstance(vm.get(name), tuple):
            raise ValueError(f"Fused QIF step requires state variable {name!r}")
    if (node._start, node._stop) != vm["s"]:
        raise ValueError("Fused QIF step requires output_var='s'")
    if (node._reset_lo, node._reset_hi) != vm["v"]:
        raise ValueError("Fused QIF step requires reset_var='v'")
    if node.dtype != torch.float32:
        raise ValueError(f"Fused QIF step requires float32 node state; got {node.dtype}")
    if (node.y.shape[0] != len(order) * n
            or [vm[name] for name in order] != [(i * n, (i + 1) * n) for i in range(len(order))]):
        raise ValueError(f"Fused QIF step requires the state layout {' | '.join(order)}")

    def scalar(name, default=None):
        key = node._param_map.get(name)
        if key is None:
            if default is None:
                raise ValueError(f"Fused QIF step: parameter {name!r} not found")
            return float(default)
        val = node._args[key]
        if getattr(val, "ndim", 0) > 0:
            raise ValueError(f"Fused QIF step requires scalar {name!r}; got array")
        return float(val)

    kw = dict(dt=node.dt, tau=scalar("tau"), tau_s=scalar("tau_s"),
              tau_x=scalar("tau_x", 1.0) if has_x else 1.0,
              k=scalar("k"), alpha=scalar("alpha", 0.0) if has_x else 0.0,
              thresh=node._thresh, v_reset=node._reset_val)
    if node._args["weights"].dim() != 2:
        raise ValueError("Fused QIF step takes a dense coupling; a block-sparse coupling runs "
                         "on the plain path")
    w_dtype = resolve_dtype(weights_dtype if weights_dtype is not None
                            else node._args["weights"].dtype)
    if w_dtype not in _VEC_ELEMS:
        raise ValueError(f"Fused QIF step takes float32 or bfloat16 weights; got {w_dtype}")
    eta_key = node._param_map["eta"]
    device = node.device

    def refresh_weights():
        node._args["__w_fused__"] = node._args["weights"].to(
            device=device, dtype=w_dtype).contiguous()

    def eta_rows(eta):  # (n,), or (B, n) for per-trial values
        if isinstance(eta, torch.Tensor):
            return eta.to(device=device, dtype=torch.float32).expand(
                eta.shape[:-1] + (n,)).contiguous()
        return torch.full((n,), float(eta), dtype=torch.float32, device=device)

    def refresh_eta():
        node._args["__eta_fused__"] = eta_rows(node._args[eta_key])

    def sweep(args):
        # batch_vars: a per-trial eta goes into the kernel's copy; every
        # other parameter is baked into the kernel or shared by the trials
        for key, val in args.items():
            if key != eta_key and val is not node._args.get(key):
                raise ValueError(
                    f"The fused QIF step bakes in or shares {key!r} across trials; only eta "
                    f"can be swept per trial.")
        return {**args, "__eta_fused__": eta_rows(args[eta_key])}

    refresh_weights()
    refresh_eta()
    for key in ("__w_fused__", "__eta_fused__"):
        if key not in node._keys:
            node._keys.append(key)
    x_zeros = None if has_x else torch.zeros(n, dtype=torch.float32, device=device)
    n_rows = len(order)

    def fused_step(y, args, x):
        v, s = y[..., :n], y[..., n:2 * n]
        xs = y[..., 2 * n:3 * n] if has_x else x_zeros
        inp = x.to(torch.float32).expand(y.shape[:-1] + (n,)).contiguous()
        y_new = qif_sfa_step(v, s, xs, args["__w_fused__"], args["__eta_fused__"], inp, **kw)
        # the output is the PRE-update s: a view of the old state, which no
        # later step writes (every step returns a new buffer); B trials'
        # states (B, 3n) give a (B, 3, n) result
        return y_new[..., :n_rows, :].reshape(y.shape[:-1] + (-1,)), s

    node.make_step = lambda: fused_step
    node._step_fn = None  # drop the cached forward() step (old step function)
    node._step_version = getattr(node, "_step_version", 0) + 1
    node._fused_refresh = {"weights": refresh_weights, eta_key: refresh_eta}
    node._fused_sweep = sweep
    node._fused_cfg = {"weights_dtype": w_dtype, "n": n}
    node._fused_attached = True
