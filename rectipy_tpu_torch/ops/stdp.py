"""The fused STDP weight update of the plastic edges (``edges.STDP``,
``edges.BlockSparseSTDP``).

The JAX package has no Pallas kernel here: XLA fuses the pair rule into one
read-modify-write pass over the plastic tensor (``rectipy_tpu/edges.py``
``STDP.update_fn``/``reward_update_fn``).  Eager PyTorch runs it as about ten
passes, so the port has a kernel of its own, ``csrc/stdp_update.cu``.  With
the traces already decayed (``x_pre * d_plus``, ``x_post * d_minus``, O(N)
operations the edges keep around the launch) and the constants rounded to
the weights' type:

    pot = a_plus * outer(spk_post, x_pre)        dep = a_minus * outer(x_post, spk_pre)
    hard:   W' = clip(W + pot - dep, w_min, w_max)
    soft:   W' = clip(W + pot*(w_max - W) - dep*(W - w_min), w_min, w_max)
    reward: E' = E*d_e + (pot - dep);  W' = clip(W + r*E', w_min, w_max)

On a block tensor ``(n_br, cb, bs, bs)`` the outer products are taken per
block on the pre-synaptic blocks gathered through ``cols``, in the JAX
package's order ``(a_plus * spk_post) * x_pre``.

- :func:`stdp_consts` makes the constants: 0-dim tensors of the weights'
  type (JAX rounds its weakly typed Python floats to the array's type; a
  PyTorch operation with a Python float would keep it at float32 for a
  bfloat16 tensor).
- :func:`pair_increments` and :func:`stdp_update_plain` are the plain
  version, in the JAX code's order of operations, for every layout: dense,
  blocks and 1-D (diagonal) weights.
- :func:`stdp_update` launches the kernel for CUDA tensors (float32, float64
  and bfloat16; dense or blocks) and takes the plain version for CPU
  tensors.  A CUDA tensor the kernel does not take raises; there is no
  fallback.  1-D weights are O(N) and not the kernel's: the edges run them
  through the plain version on every device.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace
from typing import Optional, Tuple

import torch

from ._build import build

__all__ = ["pair_increments", "stdp_consts", "stdp_update", "stdp_update_plain"]

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_HARD, _SOFT, _REWARD = 0, 1, 2


def stdp_consts(dtype: torch.dtype, device, a_plus: float, a_minus: float, w_min: float,
                w_max: float, d_e: float = 0.0) -> SimpleNamespace:
    """The rule's constants as 0-dim tensors of ``dtype`` on ``device``
    (``a_plus``, ``a_minus``, ``w_min``, ``w_max``, ``d_e``), and their
    values as Python floats (``values``) for the kernel."""
    c = {k: torch.tensor(float(v), dtype=dtype, device=device)
         for k, v in (("a_plus", a_plus), ("a_minus", a_minus), ("w_min", w_min),
                      ("w_max", w_max), ("d_e", d_e))}
    values = {k: float(torch.tensor(float(v), dtype=dtype)) for k, v in
              (("a_plus", a_plus), ("a_minus", a_minus), ("w_min", w_min), ("w_max", w_max),
               ("d_e", d_e))}
    return SimpleNamespace(**c, values=values)


def clip(W: torch.Tensor, c: SimpleNamespace) -> torch.Tensor:
    """``min(max(W, w_min), w_max)`` (``jnp.clip``; NaN passes through)."""
    return torch.minimum(torch.maximum(W, c.w_min), c.w_max)


def pair_increments(x_pre, x_post, spk_pre, spk_post, c: SimpleNamespace, shape,
                    cols: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pot, dep)`` of the pair rule on decayed traces, in the plastic
    tensor's ``shape``: dense ``(n_out, n_in)``, 1-D ``(n,)`` or blocks
    ``(n_br, cb, bs, bs)`` with the block-column table ``cols``."""
    if cols is not None:
        n_br, _, bs, _ = shape
        nb_in = x_pre.shape[0] // bs
        post_blk = spk_post.reshape(n_br, bs)
        xpre_blk = x_pre.reshape(nb_in, bs)[cols]
        xpost_blk = x_post.reshape(n_br, bs)
        pre_blk = spk_pre.reshape(nb_in, bs)[cols]
        pot = c.a_plus * post_blk[:, None, :, None] * xpre_blk[:, :, None, :]
        dep = c.a_minus * xpost_blk[:, None, :, None] * pre_blk[:, :, None, :]
        return pot, dep
    if len(shape) == 1:
        return c.a_plus * (spk_post * x_pre), c.a_minus * (x_post * spk_pre)
    return c.a_plus * torch.outer(spk_post, x_pre), c.a_minus * torch.outer(x_post, spk_pre)


def stdp_update_plain(W, x_pre, x_post, spk_pre, spk_post, c: SimpleNamespace,
                      soft: bool = False, cols: Optional[torch.Tensor] = None,
                      E: Optional[torch.Tensor] = None, r: Optional[torch.Tensor] = None):
    """Plain version: ``(W', E')`` (``E'`` None outside reward mode, which
    ``E`` and the 0-dim reward ``r`` select).  New tensors; the inputs are
    never written."""
    pot, dep = pair_increments(x_pre, x_post, spk_pre, spk_post, c, W.shape, cols)
    if E is not None:
        E = E * c.d_e + (pot - dep)
        return clip(W + r * E, c), E
    if soft:
        W = W + pot * (c.w_max - W) - dep * (W - c.w_min)
    else:
        W = W + pot - dep
    return clip(W, c), None


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build("stdp_update").lib.stdp_update_launch
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = [i, i] + [p] * 10 + [ctypes.c_longlong, i, i, i] + [d] * 5 + [p]
    fn.restype = ctypes.c_int
    return fn


def stdp_update(W, x_pre, x_post, spk_pre, spk_post, c: SimpleNamespace, soft: bool = False,
                cols: Optional[torch.Tensor] = None, E: Optional[torch.Tensor] = None,
                r: Optional[torch.Tensor] = None):
    """The update ``(W', E')``, the arguments as :func:`stdp_update_plain`'s.

    CPU tensors take :func:`stdp_update_plain`.  CUDA tensors launch the
    kernel on the current stream: ``W`` a contiguous float32, float64 or
    bfloat16 matrix ``(n_out, n_in)`` or block tensor ``(n_br, cb, bs,
    bs)`` with an int64 ``cols`` ``(n_br, cb)``; the four
    vectors contiguous, of ``W``'s type, ``(n_in,)`` and ``(n_out,)``; in
    reward mode ``E`` like ``W`` and ``r`` 0-dim of ``W``'s type, all on
    ``W``'s device; anything else raises.  ``W'`` and ``E'`` are new
    tensors.  Each launch adds one to ``stdp_update.launches``."""
    if W.device.type == "cpu":
        return stdp_update_plain(W, x_pre, x_post, spk_pre, spk_post, c, soft, cols, E, r)
    device = W.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"stdp_update: W must be on the current CUDA device, got {device}")
    if W.dtype not in _DTYPES:
        raise ValueError(f"stdp_update: the kernel takes float32, float64 and bfloat16 "
                         f"weights, got {W.dtype}")
    if not W.is_contiguous():
        raise ValueError("stdp_update: W must be contiguous")
    if cols is None:
        if W.dim() != 2:
            raise ValueError(f"stdp_update: the kernel takes (n_out, n_in) or (n_br, cb, bs, "
                             f"bs) weights, got shape {tuple(W.shape)}")
        n_out, n_in = W.shape
        n_rows, row_len, cb, bs = n_out, n_in, 0, 0
    else:
        if W.dim() != 4 or W.shape[2] != W.shape[3]:
            raise ValueError(f"stdp_update: block weights must be (n_br, cb, bs, bs), got "
                             f"{tuple(W.shape)}")
        n_br, cb, bs, _ = W.shape
        if cols.dtype != torch.int64 or cols.device != device or tuple(cols.shape) != (n_br, cb) \
                or not cols.is_contiguous():
            raise ValueError(f"stdp_update: cols must be a contiguous int64 ({n_br}, {cb}) "
                             f"tensor on {device}")
        n_out, n_in = n_br * bs, x_pre.shape[0]
        if n_in % bs:
            raise ValueError(f"stdp_update: {n_in} pre-synaptic neurons are not whole blocks "
                             f"of {bs}")
        n_rows, row_len = n_br * cb * bs, bs
    for name, t, n in (("x_pre", x_pre, n_in), ("x_post", x_post, n_out),
                       ("spk_pre", spk_pre, n_in), ("spk_post", spk_post, n_out)):
        if t.device != device or t.dtype != W.dtype or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"stdp_update: {name} must be a contiguous {W.dtype} ({n},) "
                             f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    mode = _SOFT if soft else _HARD
    if E is not None:
        if soft:
            raise ValueError("stdp_update: reward mode takes hard bounds")
        if E.device != device or E.dtype != W.dtype or E.shape != W.shape \
                or not E.is_contiguous():
            raise ValueError(f"stdp_update: E must be a contiguous {W.dtype} "
                             f"{tuple(W.shape)} tensor on {device}")
        if r is None or r.device != device or r.dtype != W.dtype or r.dim() != 0:
            raise ValueError(f"stdp_update: reward mode needs r, a 0-dim {W.dtype} tensor on "
                             f"{device}")
        mode = _REWARD
    W_out = torch.empty_like(W)
    E_out = torch.empty_like(E) if mode == _REWARD else None
    v = c.values
    err = _launch_fn()(
        _DTYPES[W.dtype], mode, W.data_ptr(), W_out.data_ptr(),
        None if E is None else E.data_ptr(), None if E_out is None else E_out.data_ptr(),
        x_pre.data_ptr(), x_post.data_ptr(), spk_pre.data_ptr(), spk_post.data_ptr(),
        None if cols is None else cols.data_ptr(), None if r is None else r.data_ptr(),
        n_rows, row_len, cb, bs, v["a_plus"], v["a_minus"], v["w_min"], v["w_max"], v["d_e"],
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stdp_update: kernel launch failed with CUDA error {err}")
    stdp_update.launches += 1
    return W_out, E_out


stdp_update.launches = 0
