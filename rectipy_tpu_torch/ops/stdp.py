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
- The kernel has two routes of one arithmetic (both equal the plain version
  bit for bit): ``"tile"``, 16-byte pieces of rows in tiles of a thread
  block (:func:`stdp_update_plan` gives its geometry), where every row is
  a whole number of 16-byte pieces and every streamed address 16-byte
  aligned; ``"row"``, a thread block a row and a thread an entry, for
  everything else.  :func:`stdp_update_routes` lists what the operands
  allow, :func:`stdp_update_route` picks one.
"""

from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import torch

from ._build import build

__all__ = ["pair_increments", "stdp_consts", "stdp_update", "stdp_update_plain",
           "stdp_update_plan", "stdp_update_route", "stdp_update_routes"]

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_HARD, _SOFT, _REWARD = 0, 1, 2
_ROUTES = {"row": 0, "tile": 1}  # the route codes of stdp_update_launch
# route "row": a grid-stride loop of ROW_BLOCKS_PER_SM thread blocks an SM
# of csrc/stdp_update.cu's kThreads
ROW_THREADS, ROW_BLOCKS_PER_SM = 256, 8
# route "tile": csrc/stdp_update.cu's kTileThreads, kTileUnroll, kTileMaxRows;
# the rows a thread walks in a tile by the weights' element size (the
# fastest of 4, 8 and 16 in turns on an H100 at the paths' shapes)
TILE_THREADS, TILE_UNROLL, TILE_MAX_ROWS = 256, 4, 512
TILE_ROWS_PER_THREAD = {2: 16, 4: 4, 8: 4}


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


class StdpPlan(NamedTuple):
    """A launch of the kernel: ``grid`` thread blocks of ``threads``; for
    route ``"tile"`` a thread block covers ``tile_rows`` rows x ``lanes``
    16-byte pieces of ``vec`` values of one segment (the dense matrix, or one
    ``(r, c)`` block), ``groups`` = ``threads // lanes`` row groups walking
    alternate rows; a row is ``strips`` strips of pieces, a segment
    ``row_tiles`` tiles (``"row"``: the last five are 0)."""
    route: str
    grid: int
    threads: int
    vec: int
    lanes: int
    groups: int
    strips: int
    tile_rows: int
    row_tiles: int


def stdp_update_plan(route: str, dtype: torch.dtype, seg_rows: int, row_len: int,
                     segments: int = 1, sms: int = 132) -> StdpPlan:
    """The geometry :func:`stdp_update` passes to the kernel for ``segments``
    segments of ``seg_rows`` rows of ``row_len`` entries (dense: one
    ``(n_out, n_in)`` segment; blocks: ``n_br * cb`` segments of ``bs`` rows
    of ``bs``) on a card of ``sms`` SMs.  ``"tile"`` cuts a row into the
    fewest strips of at most ``TILE_THREADS`` pieces, evenly, and gives a
    thread ``TILE_ROWS_PER_THREAD[element size]`` rows (a tile at most
    ``TILE_MAX_ROWS``)."""
    if segments * seg_rows * row_len == 0:  # nothing to update: the launch returns at once
        return StdpPlan(route, 0, ROW_THREADS, 1, 0, 0, 0, 0, 0)
    if route == "row":
        return StdpPlan("row", min(segments * seg_rows, ROW_BLOCKS_PER_SM * sms), ROW_THREADS,
                        1, 0, 0, 0, 0, 0)
    size = torch.empty((), dtype=dtype).element_size()
    vec = 16 // size
    if route != "tile" or row_len % vec:
        raise ValueError(f"stdp_update_plan: route {route!r} does not take rows of {row_len}")
    vecs = row_len // vec
    strips = -(-vecs // TILE_THREADS)
    lanes = -(-vecs // strips)
    groups = TILE_THREADS // lanes
    tile_rows = min(TILE_ROWS_PER_THREAD[size] * groups, seg_rows, TILE_MAX_ROWS)
    row_tiles = -(-seg_rows // tile_rows)
    return StdpPlan("tile", segments * row_tiles * strips, TILE_THREADS, vec, lanes, groups,
                    strips, tile_rows, row_tiles)


def stdp_update_routes(dtype: torch.dtype, row_len: int, ptrs) -> tuple:
    """Every route of the kernel that rows of ``row_len`` entries of
    ``dtype`` (``n_in`` dense, ``bs`` blocks) allow with the streamed
    tensors at ``ptrs`` (the addresses of W, W', x_pre and spk_pre, and E
    and E' in reward mode): ``"tile"`` where a row is a whole number of
    16-byte pieces and every address 16-byte aligned, and ``"row"``
    always."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    tile = row_len % vec == 0 and all(p % 16 == 0 for p in ptrs)
    return ("tile", "row") if tile else ("row",)


def stdp_update_route(dtype: torch.dtype, row_len: int, ptrs) -> str:
    """The route :func:`stdp_update` takes: the first of
    :func:`stdp_update_routes`, the tiles wherever the operands allow them."""
    return stdp_update_routes(dtype, row_len, ptrs)[0]


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build("stdp_update").lib.stdp_update_launch
    p, i, d, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    fn.argtypes = [i, i, i] + [p] * 10 + [ll, i, i, i, ll, i, i, i] + [d] * 5 + [p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stdp_update(W, x_pre, x_post, spk_pre, spk_post, c: SimpleNamespace, soft: bool = False,
                cols: Optional[torch.Tensor] = None, E: Optional[torch.Tensor] = None,
                r: Optional[torch.Tensor] = None, route: Optional[str] = None):
    """The update ``(W', E')``, the arguments as :func:`stdp_update_plain`'s.

    CPU tensors take :func:`stdp_update_plain`.  CUDA tensors launch the
    kernel on the current stream: ``W`` a contiguous float32, float64 or
    bfloat16 matrix ``(n_out, n_in)`` or block tensor ``(n_br, cb, bs,
    bs)`` with an int64 ``cols`` ``(n_br, cb)``; the four
    vectors contiguous, of ``W``'s type, ``(n_in,)`` and ``(n_out,)``; in
    reward mode ``E`` like ``W`` and ``r`` 0-dim of ``W``'s type, all on
    ``W``'s device; anything else raises.  ``W'`` and ``E'`` are new
    tensors.  ``route`` (default :func:`stdp_update_route`'s) forces a route
    of the kernel, for comparing them; one the operands do not allow
    raises, and so does any route for CPU tensors.  Each launch adds one to
    ``stdp_update.launches``, a launch of route ``"tile"`` also to
    ``stdp_update.tile_launches``."""
    if route is not None:
        _check_route(route, W, x_pre, spk_pre, E)
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
    if route is None:
        route = stdp_update_route(W.dtype, row_len, [t.data_ptr() for t in (
            W, W_out, x_pre, spk_pre, E, E_out) if t is not None])
    segments = 1 if cols is None else n_br * cb
    plan = stdp_update_plan(route, W.dtype, n_rows // segments, row_len, segments,
                            _sms(device.index))
    v = c.values
    err = _launch_fn()(
        _DTYPES[W.dtype], mode, _ROUTES[route], W.data_ptr(), W_out.data_ptr(),
        None if E is None else E.data_ptr(), None if E_out is None else E_out.data_ptr(),
        x_pre.data_ptr(), x_post.data_ptr(), spk_pre.data_ptr(), spk_post.data_ptr(),
        None if cols is None else cols.data_ptr(), None if r is None else r.data_ptr(),
        n_rows, row_len, cb, bs, plan.grid, plan.lanes, plan.strips, plan.tile_rows,
        v["a_plus"], v["a_minus"], v["w_min"], v["w_max"], v["d_e"],
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stdp_update: kernel launch failed with CUDA error {err}")
    stdp_update.launches += 1
    if route == "tile":
        stdp_update.tile_launches += 1
    return W_out, E_out


stdp_update.launches = 0
stdp_update.tile_launches = 0  # launches of route "tile"


def _check_route(route, W, x_pre, spk_pre, E) -> None:
    """A forced route must be the kernel's and allowed by the operands'
    row length and addresses (W' and E' are fresh allocations, 16-byte
    aligned, and the launch checks them too); CPU tensors take the plain
    version, which has no routes."""
    if route not in _ROUTES:
        raise ValueError(f"stdp_update: route must be one of {tuple(_ROUTES)}, got {route!r}")
    row_len = W.shape[-1]
    ptrs = [t.data_ptr() for t in (W, x_pre, spk_pre, E) if t is not None]
    if route not in stdp_update_routes(W.dtype, row_len, ptrs):
        raise ValueError(f"stdp_update: route {route!r} does not take rows of {row_len} "
                         f"{W.dtype} at these addresses")
    if W.device.type != "cuda":
        raise ValueError(f"stdp_update: route {route!r} is the kernel's; {W.device} tensors "
                         f"take the plain version")
