"""Generic fused step: plain PyTorch version, CUDA kernel, node attach.

Counterpart of ``rectipy_tpu/ops/generic_fused.py``.  One step of any
population node whose template has no population reductions: K coupling
matvecs fused with the node's own vector field (its lowered ``tile_func``),
the spiking of its class and the Euler update, in one pass over the
couplings.

- :func:`generic_fused_step_plain` is the plain PyTorch version of the
  kernel body (``generic_fused.py:165-222``).
- :func:`generic_fused_step` launches the CUDA kernel
  (``csrc/generic_fused_step.cuh`` with the tail that ``dsl/cuda.py`` emits
  from the template) for CUDA tensors and takes the plain version for CPU
  tensors.  There is no fallback: a CUDA tensor the kernel does not take
  raises.
- :func:`generic_fused_rows` is the same step for ``B`` trials that share
  the couplings and parameters (the TPU kernel under the JAX package's
  ``vmap``, ``rectipy_tpu/network.py:1476-1711``): one launch of a B-row
  kernel of ``csrc/generic_fused_step.cuh`` reads each W once for up to 32
  trials, on the tensor cores for an aligned bfloat16 W and on the tiled
  CUDA-core kernel for an aligned float32 one (:func:`generic_rows_route`);
  :func:`generic_fused_rows_plain` is its plain version.
- :func:`attach_generic_fused_step` swaps a node's step for it.
- The CUDA kernels have no backward (nor does the TPU kernel: JAX cannot
  differentiate through its ``pallas_call``), so on the card both wrappers
  raise when autograd would need one; the plain versions on CPU tensors
  stay differentiable.

Scope (``ValueError`` otherwise, with the JAX package's messages):
``RateNet``, ``SpikeResetNet``, ``SpikeNet`` and ``MultiSpikeResetNet``
nodes built through the DSL, float32 state, Euler integration (and Heun on
a ``RateNet``: the kernel in derivative mode, twice per step), one or more
dense float32/bfloat16 couplings whose sources are states or algebraics of
states and parameters only.  Frozen ``int8``/``int4`` and ``int8_master``/
``int4_master`` couplings, block-sparse couplings, rk4, templates with
population reductions and a
second attach are refused.

Unlike the TPU kernel, nothing is padded and W stays row-major: the node
keeps its state layout, so the JAX padding rules (parameters padded with
1.0, inputs with 0.0, source lanes past n forced to 0,
``generic_fused.py:275-298``) have nothing to act on.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import re
from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import torch

from ..dsl.cuda import emit_step_source
from ._build import build_generated

__all__ = ["GenericStep", "attach_generic_fused_step", "generic_fused_rows",
           "generic_fused_rows_plain", "generic_fused_step", "generic_fused_step_plain",
           "build_source", "generic_key", "generic_rows_route", "refuse_autograd", "source_dims"]

# elements per 16-byte vector load of W
_VEC_ELEMS = {torch.float32: 4, torch.bfloat16: 8}
# the B-row C entry's route codes (csrc/generic_fused_step.cuh, kRoute*)
_ROWS_ROUTES = {"scalar": 0, "vec": 1, "mma": 2, "tiled": 3}
# the most couplings of the tiled route: the ring and K couplings' sums in
# a block's 227 KB of shared memory (kTiledMaxK)
_TILED_MAX_K = 5
_NODE_CLASSES = ("RateNet", "SpikeResetNet", "SpikeNet", "MultiSpikeResetNet")


@dataclass(frozen=True)
class GenericStep:
    """What one node's generic fused step computes, fixed at attach time.

    ``spike_specs`` are ``(key receiving r/dt, state index tested against
    the threshold, hard reset?, extra keys also receiving r/dt)``: a
    ``SpikeResetNet`` has one with a hard reset, a ``SpikeNet`` one without
    (its reset key is the extra key), a ``MultiSpikeResetNet`` one per
    segment.  ``scalars`` are the baked scalar parameters; the kernel takes
    them at launch.  ``source`` is the generated CUDA source."""

    tile_func: Callable
    state_order: Tuple[str, ...]
    vec_keys: Tuple[str, ...]
    scalars: Dict[str, float]
    inp_key: str
    targets: Tuple[str, ...]
    spike_specs: Tuple[Tuple[str, int, bool, Tuple[str, ...]], ...]
    dt: float
    thresh: float
    reset_val: float
    derivative: bool
    source: str


def _matvec(W: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``W @ src`` in f32 sums; a bf16 W takes the source rounded to bf16.
    Source rows ``(B, n)`` take one matvec each, so that every trial's sum
    is the single-trial one."""
    if src.dim() == 2:
        return torch.stack([_matvec(W, row) for row in src.unbind(0)])
    if W.dtype == torch.float32:
        return torch.mv(W, src)
    return torch.mv(W.to(torch.float32), src.to(W.dtype).to(torch.float32))


def generic_fused_step_plain(step: GenericStep, srcs: Sequence[torch.Tensor],
                             Ws: Sequence[torch.Tensor], drive: torch.Tensor,
                             states: Sequence[torch.Tensor],
                             vecs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of one generic fused step: a new ``(V, n)``
    tensor, the updated state rows (or, in derivative mode, the vector
    field).  The drive goes into the input first, then each coupling sum
    into its target (two may share one, and a target may be the input
    itself), then each spike spec's ``r/dt``."""
    accs = [_matvec(W, src) for W, src in zip(Ws, srcs)]
    st = dict(zip(step.state_order, states))
    a_tile = dict(step.scalars)
    a_tile.update(zip(step.vec_keys, vecs))
    ext = {step.inp_key: drive}
    for tgt, acc in zip(step.targets, accs):
        ext[tgt] = ext.get(tgt, 0.0) + acc
    resets = {}
    for skey, vidx, hard, extra in step.spike_specs:
        v = states[vidx]
        r = (v - step.thresh >= 0.0).to(v.dtype)
        if hard:
            resets[vidx] = r
        for k in (skey,) + tuple(extra):
            ext[k] = ext.get(k, 0.0) + r / step.dt
    d = step.tile_func(st, a_tile, ext)
    if step.derivative:
        return torch.stack([d[q] for q in step.state_order], dim=-2)
    rows = []
    for i, q in enumerate(step.state_order):
        new = states[i] + step.dt * d[q]
        if i in resets:
            new = new * (1.0 - resets[i]) + resets[i] * step.reset_val
        rows.append(new)
    return torch.stack(rows, dim=-2)


def generic_fused_rows_plain(step: GenericStep, srcs: Sequence[torch.Tensor],
                             Ws: Sequence[torch.Tensor], drive: torch.Tensor,
                             states: Sequence[torch.Tensor],
                             vecs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of one generic fused step of ``B`` trials: the
    sources, the drive and the states ``(B, n)`` (or ``(n,)``, shared by
    every trial), the per-neuron rows ``(n,)``; a new ``(B, V, n)`` tensor.
    Each trial's coupling sums are its own matvecs, so row ``b`` is
    :func:`generic_fused_step_plain` of trial ``b``."""
    B = next(t.shape[0] for t in list(states) + list(srcs) + [drive] if t.dim() == 2)
    n = drive.shape[-1]

    def rows(t):
        return t.expand(B, n)

    return generic_fused_step_plain(step, [rows(t) for t in srcs], Ws, rows(drive),
                                    [rows(t) for t in states], vecs)


def generic_key(source: str) -> str:
    """The name of a generated source in the operators' calls and in a
    serving bundle: the first 16 hex digits of the SHA-256 of its text.
    (The build's own tag, ``ops/_build.build_generated``, also covers the
    ``csrc/`` headers and the flags; the key names the text alone, so a
    bundle keeps its key across builds of the package.)"""
    return hashlib.sha256(source.encode()).hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def source_dims(source: str) -> Tuple[int, int, int]:
    """``(K, V, P)`` of a generated source: its couplings, state rows and
    per-neuron rows, as its ``Program`` declares them (``dsl/cuda.py``)."""
    dims = dict(re.findall(r"static constexpr int ([KVP]) = (\d+);", source))
    if sorted(dims) != ["K", "P", "V"]:
        raise ValueError("generic_fused_step: the source declares no Program's K, V and P")
    return int(dims["K"]), int(dims["V"]), int(dims["P"])


@functools.lru_cache(maxsize=None)
def _launch_fn(source: str):
    """The C entry point of a generated source, built and declared once per
    process (one library per distinct source)."""
    fn = build_generated("generic_fused_step", source).lib.generic_fused_step_launch
    i, f = ctypes.c_int, ctypes.c_float
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_double), i, i, i,
                   f, f, f, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build_source(source: str) -> None:
    """Build a generated source (or reuse its build) and declare both C
    entries; a source nvcc refuses raises ``RuntimeError``."""
    _launch_fn(source)
    _rows_launch_fn(source)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device: torch.device,
           who: str = "generic_fused_step"):
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, the drive on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{who}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{who}: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def generic_fused_step(step: GenericStep, srcs: Sequence[torch.Tensor],
                       Ws: Sequence[torch.Tensor], drive: torch.Tensor,
                       states: Sequence[torch.Tensor],
                       vecs: Sequence[torch.Tensor]) -> torch.Tensor:
    """One generic fused step (see :func:`generic_fused_step_plain`).

    A drive on the CPU takes the plain version.  A drive on the GPU
    launches the kernel on the current stream: K couplings ``(n, n)``, all
    float32 or all bfloat16, and the K sources, the drive, the V state rows
    and the P per-neuron rows ``(n,)`` float32, all contiguous and on the
    current device; anything else raises.  The first launch of a source
    builds it.  Each launch adds one to ``generic_fused_step.launches``.

    While ``torch.export`` traces, the call goes to the registered operator
    ``rectipy::generic_fused_step`` instead, which names the source by its
    :func:`generic_key` (``ops/library.py``).
    """
    if torch.compiler.is_exporting():
        from . import library

        return library.generic_fused_step(*library.generic_args(step, srcs, Ws, drive, states,
                                                                vecs))
    if drive.device.type == "cpu":
        return generic_fused_step_plain(step, srcs, Ws, drive, states, vecs)
    return generic_step_launch(step.source, srcs, Ws, drive, states, vecs,
                               step.scalars.values(), step.dt, step.thresh, step.reset_val)


def generic_step_launch(source: str, srcs, Ws, drive, states, vecs, scalars, dt: float,
                        thresh: float, reset_val: float) -> torch.Tensor:
    """The kernel launch of :func:`generic_fused_step` on CUDA tensors, for
    the generated ``source`` and its baked ``scalars`` in the source's order
    (the CUDA implementation of ``rectipy::generic_fused_step``): its
    checks, the launch and the launch counter."""
    device = drive.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(
            f"generic_fused_step: the drive must be on the current CUDA device, got {device}")
    refuse_autograd("generic_fused_step", list(srcs) + list(Ws) + [drive] + list(states)
                     + list(vecs))
    K, V, P = source_dims(source)
    if (len(Ws), len(srcs), len(states), len(vecs)) != (K, K, V, P):
        raise ValueError(
            f"generic_fused_step: expected {K} couplings and sources, {V} state rows and "
            f"{P} per-neuron rows; got {len(Ws)}, {len(srcs)}, {len(states)} and {len(vecs)}")
    n = drive.shape[0] if drive.dim() == 1 else -1
    w_dtype = Ws[0].dtype
    if w_dtype not in _VEC_ELEMS:
        raise ValueError(f"generic_fused_step: W must be float32 or bfloat16, got {w_dtype}")
    for c, W in enumerate(Ws):
        _check(f"W[{c}]", W, (n, n), w_dtype, device)
    vectors = ([("drive", drive)] + [(f"src[{c}]", t) for c, t in enumerate(srcs)]
               + [(f"state[{v}]", t) for v, t in enumerate(states)]
               + [(f"vec[{j}]", t) for j, t in enumerate(vecs)])
    for name, t in vectors:
        _check(name, t, (n,), torch.float32, device)

    out = torch.empty((V, n), dtype=torch.float32, device=device)
    vec = n % _VEC_ELEMS[w_dtype] == 0 and all(
        t.data_ptr() % 16 == 0 for t in list(Ws) + list(srcs))
    base = out.data_ptr()
    ptrs = ([W.data_ptr() for W in Ws] + [t.data_ptr() for t in srcs] + [drive.data_ptr()]
            + [t.data_ptr() for t in states] + [t.data_ptr() for t in vecs]
            + [base + 4 * n * v for v in range(V)])
    scalars = list(scalars)
    err = _launch_fn(source)(
        (ctypes.c_uint64 * len(ptrs))(*ptrs), (ctypes.c_double * max(len(scalars), 1))(*scalars),
        n, int(w_dtype == torch.bfloat16), int(vec), dt, thresh, reset_val,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"generic_fused_step: kernel launch failed with CUDA error {err}")
    generic_fused_step.launches += 1
    return out


generic_fused_step.launches = 0


def refuse_autograd(name: str, tensors) -> None:
    """The kernels write their results through ctypes, with no autograd
    history: refuse, rather than cut a gradient silently, when autograd
    would need one through them."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the CUDA kernel has no backward (nor has "
            f"the JAX package's Pallas kernel). Train without the fused step attached (CPU "
            f"tensors take the plain version instead).")


@functools.lru_cache(maxsize=None)
def _rows_launch_fn(source: str):
    """The B-row C entry point of a generated source (the same library as
    :func:`_launch_fn`'s)."""
    fn = build_generated("generic_fused_step", source).lib.generic_fused_rows_launch
    i, f = ctypes.c_int, ctypes.c_float
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_double), i, i, i, i, f, f, f, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def generic_rows_route(w_dtype, n: int, src_lds: Sequence[int], ptrs: Sequence[int]) -> str:
    """The B-row kernel's instance for couplings of ``w_dtype``, rows of
    ``n`` inputs, the K sources' row strides ``src_lds`` (0 for a row
    shared by every trial) and the addresses ``ptrs`` of the W and the
    sources.  When ``n`` is a multiple of 4, every address of 16 bytes and
    every stride of 4: ``"mma"`` (the tensor cores) for a bfloat16 W with
    ``n`` a multiple of 8; ``"tiled"`` (the CUDA cores' tiled kernel: W and
    the sources through a ring in shared memory, 80-row strips) for a
    float32 W of at most ``_TILED_MAX_K`` couplings, whose sums must fit
    beside the ring; else ``"vec"`` (16-byte loads of W, asynchronous
    copies of the sources).  Otherwise ``"scalar"``.  A float32 W stays on
    the CUDA cores, where its numbers are the plain version's; TF32 would
    change them."""
    if n % 4 or any(p % 16 for p in ptrs) or any(ld % 4 for ld in src_lds):
        return "scalar"
    if w_dtype == torch.bfloat16:
        return "mma" if n % 8 == 0 else "vec"
    return "tiled" if len(src_lds) <= _TILED_MAX_K else "vec"


def _ld(t: torch.Tensor) -> int:
    """The row stride of ``(B, n)`` rows, 0 for one ``(n,)`` row."""
    return t.stride(0) if t.dim() == 2 else 0


def generic_fused_rows(step: GenericStep, srcs: Sequence[torch.Tensor],
                       Ws: Sequence[torch.Tensor], drive: torch.Tensor,
                       states: Sequence[torch.Tensor],
                       vecs: Sequence[torch.Tensor]) -> torch.Tensor:
    """One generic fused step of ``B`` trials that share the couplings and
    the parameters (see :func:`generic_fused_rows_plain`): a new ``(B, V,
    n)`` float32 tensor, the node's ``(B, V*n)`` state layout.

    A drive on the CPU takes the plain version.  A drive on the GPU
    launches the B-row kernel on the current stream: K couplings ``(n, n)``,
    all float32 or all bfloat16 and contiguous; the K sources, the drive
    and the V states float32 ``(B, n)`` or ``(n,)`` (one row shared by every
    trial) with contiguous rows (the rows may be strided: the node's state
    is read in place); the P per-neuron rows ``(n,)`` float32 and
    contiguous; all on the current device.  Anything else raises.  The
    kernel's instance is :func:`generic_rows_route`'s.  Each launch adds one
    to ``generic_fused_rows.launches``, and one on the tensor cores also to
    ``generic_fused_rows.mma_launches``, one on the tiled kernel to
    ``generic_fused_rows.tiled_launches``.  While ``torch.export`` traces,
    the call goes to the registered operator ``rectipy::generic_fused_rows``
    instead (``ops/library.py``)."""
    if torch.compiler.is_exporting():
        from . import library

        return library.generic_fused_rows(*library.generic_args(step, srcs, Ws, drive, states,
                                                                vecs))
    if drive.device.type == "cpu":
        return generic_fused_rows_plain(step, srcs, Ws, drive, states, vecs)
    return generic_rows_launch(step.source, srcs, Ws, drive, states, vecs,
                               step.scalars.values(), step.dt, step.thresh, step.reset_val)


def generic_rows_launch(source: str, srcs, Ws, drive, states, vecs, scalars, dt: float,
                        thresh: float, reset_val: float) -> torch.Tensor:
    """The B-row kernel launch of :func:`generic_fused_rows` on CUDA tensors
    (the CUDA implementation of ``rectipy::generic_fused_rows``), as
    :func:`generic_step_launch` is the single-trial one: its checks, route,
    launch and launch counters."""
    device = drive.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(
            f"generic_fused_rows: the drive must be on the current CUDA device, got {device}")
    refuse_autograd("generic_fused_rows", list(srcs) + list(Ws) + [drive] + list(states)
                     + list(vecs))
    K, V, P = source_dims(source)
    if (len(Ws), len(srcs), len(states), len(vecs)) != (K, K, V, P):
        raise ValueError(
            f"generic_fused_rows: expected {K} couplings and sources, {V} state rows and "
            f"{P} per-neuron rows; got {len(Ws)}, {len(srcs)}, {len(states)} and {len(vecs)}")
    per_trial = list(srcs) + [drive] + list(states)
    two_d = [t for t in per_trial if t.dim() == 2]
    if not two_d:
        raise ValueError("generic_fused_rows: no operand has a trial axis (B, n)")
    B, n = two_d[0].shape
    w_dtype = Ws[0].dtype
    if w_dtype not in _VEC_ELEMS:
        raise ValueError(f"generic_fused_rows: W must be float32 or bfloat16, got {w_dtype}")
    for c, W in enumerate(Ws):
        _check(f"W[{c}]", W, (n, n), w_dtype, device, "generic_fused_rows")
    for j, t in enumerate(vecs):
        _check(f"vec[{j}]", t, (n,), torch.float32, device, "generic_fused_rows")
    names = ([f"src[{c}]" for c in range(K)] + ["drive"] + [f"state[{v}]" for v in range(V)])
    for name, t in zip(names, per_trial):
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"generic_fused_rows: {name} must be float32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if t.shape not in ((B, n), (n,)) or t.stride(-1) != 1:
            raise ValueError(f"generic_fused_rows: {name} must be ({B}, {n}) or ({n},) with "
                             f"contiguous rows, got {tuple(t.shape)} strides {t.stride()}")

    out = torch.empty((B, V, n), dtype=torch.float32, device=device)
    ptrs = ([W.data_ptr() for W in Ws] + [t.data_ptr() for t in per_trial]
            + [t.data_ptr() for t in vecs] + [out.data_ptr()])
    lds = [_ld(t) for t in per_trial] + [V * n]
    route = generic_rows_route(w_dtype, n, lds[:K], ptrs[:2 * K])
    scalars = list(scalars)
    err = _rows_launch_fn(source)(
        (ctypes.c_uint64 * len(ptrs))(*ptrs), (ctypes.c_longlong * len(lds))(*lds),
        (ctypes.c_double * max(len(scalars), 1))(*scalars), n, B,
        int(w_dtype == torch.bfloat16), _ROWS_ROUTES[route], dt, thresh, reset_val,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"generic_fused_rows: kernel launch failed with CUDA error {err}")
    generic_fused_rows.launches += 1
    if route == "mma":
        generic_fused_rows.mma_launches += 1
    elif route == "tiled":
        generic_fused_rows.tiled_launches += 1
    return out


generic_fused_rows.launches = 0
generic_fused_rows.mma_launches = 0  # launches on the tensor cores (generic_rows_route "mma")
generic_fused_rows.tiled_launches = 0  # launches on the tiled f32 kernel ("tiled")


def _row(val, n: int, device: torch.device, lead: tuple = ()) -> torch.Tensor:
    """A float32 ``(*lead, n)`` block of a tensor or a Python float, each
    row contiguous: a contiguous ``(n,)`` row, or ``(B, n)`` rows of which a
    row shared by every trial stays one row (row stride 0)."""
    if not isinstance(val, torch.Tensor):
        val = torch.full((n,), float(val), dtype=torch.float32, device=device)
    t = val.to(device=device, dtype=torch.float32).expand(*lead, n)
    return t if t.stride(-1) == 1 else t.contiguous()


def attach_generic_fused_step(node, weights_dtype=None) -> None:
    """Swap ``node``'s step for the generic fused kernel (see the module
    docstring for what qualifies).  ``weights_dtype`` (float32 or
    bfloat16) is the kernel's copy of the couplings; default: the node's
    coupling dtype.  On a CUDA node the generated source is built here, so a
    template the emitter or nvcc refuses fails now, not during a run.

    The node keeps its state layout, records, ``get_var`` and ``reset``.
    ``set_param`` refreshes the per-neuron parameters and the couplings in
    the kernel's copies and raises for the scalars, which are baked in.
    ``(B, S)`` states (``run_batch``) launch the B-row kernel once per step
    (twice for Heun), and a per-trial sweep of the node's parameters
    raises.
    """
    from ..nodes import resolve_dtype  # nodes imports ops: not at module level

    if getattr(node, "_fused_attached", False):
        raise ValueError(
            "A fused step is already attached to this node. Rebuild the node to change the "
            "kernel configuration.")
    vf = getattr(node, "_vf", None)
    if vf is None or vf.tile_func is None or not vf.tile_local:
        raise ValueError(
            "Generic fused step requires a DSL-built node without population reductions "
            "(mean()/sum() templates run on the plain path -- their tile_func is "
            "global-only).")
    cls_name = type(node).__name__
    if cls_name not in _NODE_CLASSES:
        raise ValueError(f"Generic fused step does not support {cls_name} nodes")
    integrator = getattr(node, "integrator", "euler")
    if integrator not in ("euler", "heun"):
        raise ValueError(f"Generic fused step does not support integrator={integrator!r} "
                         "(rk4 runs on the plain path)")
    heun = integrator == "heun"
    if heun and cls_name != "RateNet":
        raise ValueError("integrator='heun' is only supported on RateNet nodes")
    wkeys = [k for k in vf.keys if (k == "weights" or k.startswith("weights_"))
             and not k.endswith(("__scale", "__cols"))]
    if not wkeys:
        raise ValueError("Generic fused step requires at least one coupling matrix")
    for wk in wkeys:
        if node._args[wk].dtype == torch.int8 or vf.coupling_cast in ("int8", "int4"):
            raise ValueError("int8/int4 coupling runs on the plain path (STE quantization)")
        if node._args[wk].dim() != 2:
            raise ValueError("block-sparse coupling runs on the plain path "
                             "(already gather-free and bandwidth-light)")
    if node.dtype != torch.float32:
        raise ValueError("Generic fused step requires float32 node state")
    couplings = [(src, tgt, wk) for src, tgt, wk in vf.couplings if wk in wkeys]
    if sorted(wk for _, _, wk in couplings) != sorted(wkeys):
        raise ValueError("Coupling metadata does not match the node's weight keys")
    src_readers = [vf.make_tile_reader(src) for src, _, _ in couplings]
    if any(rd is None for rd in src_readers):
        raise ValueError(
            "Generic fused step requires every coupling source to be a state variable or an "
            "algebraic of states only (input-dependent sources run on the plain path).")
    out_reader = None
    if node._out_alg is not None:
        out_reader = vf.make_tile_reader(node._out_alg)
        if out_reader is None:
            raise ValueError(
                "Generic fused step requires an algebraic output to depend on states/params "
                "only (input-dependent outputs run on the plain path).")
    w_dtype = resolve_dtype(weights_dtype if weights_dtype is not None
                            else node._args[wkeys[0]].dtype)
    if w_dtype not in _VEC_ELEMS:
        raise ValueError(f"Generic fused step takes float32 or bfloat16 weights; got {w_dtype}")

    n, dt, device = vf.n, node.dt, node.device
    state_order = tuple(vf.state_order)
    n_vars = len(state_order)
    if node.y.shape[0] != n_vars * n:
        raise ValueError("Generic fused step requires the lowered state layout")
    inp_key = node._inp_key
    # per-neuron arguments travel as rows; scalars are baked at attach time
    vec_keys, scalars = [], {}
    for k in vf.keys:
        if k in wkeys or k == inp_key:
            continue
        val = node._args[k]
        if isinstance(val, torch.Tensor) and val.dim() == 1:
            vec_keys.append(k)
        else:
            scalars[k] = float(val)

    def var_idx(lo, hi):
        return next(i for i, q in enumerate(state_order)
                    if tuple(vf.var_map[q]) == (int(lo), int(hi)))

    thresh = reset_val = 0.0
    if cls_name == "SpikeResetNet":
        thresh, reset_val = node._thresh, node._reset_val
        spike_specs = [(node._spike_key, var_idx(node._reset_lo, node._reset_hi), True, ())]
    elif cls_name == "SpikeNet":
        thresh = node._thresh
        spike_specs = [(node._spike_key, var_idx(node._spike_lo, node._spike_hi), False,
                        (node._reset_key,))]
    elif cls_name == "MultiSpikeResetNet":
        thresh, reset_val = node._thresh, node._reset_val
        spike_specs = [(k, var_idx(lo, hi), True, ())
                       for k, (lo, hi) in zip(node._spike_keys, node._segments)]
    else:
        spike_specs = []
    targets = tuple(tgt for _, tgt, _ in couplings)
    source = emit_step_source(vf.tile_program, vec_keys=vec_keys, scalar_keys=list(scalars),
                              inp_key=inp_key, targets=targets, spike_specs=spike_specs,
                              derivative=heun)
    step = GenericStep(vf.tile_func, state_order, tuple(vec_keys), scalars, inp_key, targets,
                       tuple(spike_specs), float(dt), float(thresh), float(reset_val), heun,
                       source)
    if device.type == "cuda":
        build_source(source)
    from . import library  # library imports this module: not at module level

    library.register_generic(step)

    # the kernel's copies: couplings in the kernel's dtype, per-neuron rows
    # as contiguous float32 rows; set_param refreshes them
    def refresh_weights(c, wk):
        node._args[f"__w_fused_{c}__"] = node._args[wk].to(
            device=device, dtype=w_dtype).contiguous()

    def refresh_row(k):
        node._args[f"__row_{k}__"] = _row(node._args[k], n, device)

    refresh: Dict[str, Callable] = {}
    for c, (_, _, wk) in enumerate(couplings):
        refresh[wk] = functools.partial(refresh_weights, c, wk)
    for k in vec_keys:
        refresh[k] = functools.partial(refresh_row, k)
    for fn in refresh.values():
        fn()
    for key in [f"__w_fused_{c}__" for c in range(len(couplings))] + [
            f"__row_{k}__" for k in vec_keys]:
        if key not in node._keys:
            node._keys.append(key)

    post_out = cls_name in ("SpikeNet", "MultiSpikeResetNet")
    out_lo, out_hi = node._start, node._stop

    def pieces(args, x, lead):
        drive = _row(x, n, device, lead)
        vecs = [args[f"__row_{k}__"] for k in vec_keys]
        a_full = dict(scalars)
        a_full.update(zip(vec_keys, vecs))
        Ws = [args[f"__w_fused_{c}__"] for c in range(len(couplings))]
        return drive, vecs, a_full, Ws

    def launch(rows, drive, vecs, a_full, Ws):
        # a state source is a view of the state; an algebraic one is
        # computed here once per launch, as the JAX package does outside its
        # kernel (generic_fused.py:336-353).  (B, n) rows (run_batch) take
        # the B-row kernel, one launch for every trial.
        st = dict(zip(state_order, rows))
        lead = tuple(rows[0].shape[:-1])
        srcs = [_row(rd(st, a_full), n, device, lead) for rd in src_readers]
        kernel = generic_fused_rows if lead else generic_fused_step
        return kernel(step, srcs, Ws, drive, rows, vecs)

    def read_out(rows, a_full):
        return _row(out_reader(dict(zip(state_order, rows)), a_full), n, device,
                    tuple(rows[0].shape[:-1]))

    def fused_step(y, args, x):
        lead = tuple(y.shape[:-1])
        drive, vecs, a_full, Ws = pieces(args, x, lead)
        rows = list(y.reshape(*lead, n_vars, n).unbind(-2))
        new = launch(rows, drive, vecs, a_full, Ws)
        y_new = new.reshape(y.shape)
        # output per node class: RateNet/SpikeResetNet read the pre-update
        # state, SpikeNet/MultiSpikeResetNet the post-update state
        if out_reader is not None:
            out = read_out(list(new.unbind(-2)) if post_out else rows, a_full)
        else:
            out = (y_new if post_out else y)[..., out_lo:out_hi]
        return y_new, out

    def fused_step_heun(y, args, x):
        # the kernel in derivative mode, twice, with the RK2 combination
        # between (the plain Heun step's two vector-field evaluations)
        lead = tuple(y.shape[:-1])
        drive, vecs, a_full, Ws = pieces(args, x, lead)
        Y = y.reshape(*lead, n_vars, n)
        k1 = launch(list(Y.unbind(-2)), drive, vecs, a_full, Ws)
        k2 = launch(list((Y + dt * k1).unbind(-2)), drive, vecs, a_full, Ws)
        y_new = (Y + (dt * 0.5) * (k1 + k2)).reshape(y.shape)
        out = (read_out(list(Y.unbind(-2)), a_full) if out_reader is not None
               else y[..., out_lo:out_hi])  # RateNet: pre-update output
        return y_new, out

    chosen = fused_step_heun if heun else fused_step

    def sweep(args):
        raise ValueError("The generic fused step bakes in or shares every parameter across "
                         "trials; none can be swept per trial.")

    node.make_step = lambda: chosen
    node._step_fn = None  # drop the cached forward() step (old step function)
    node._step_version = getattr(node, "_step_version", 0) + 1
    node._fused_refresh = refresh
    node._fused_sweep = sweep
    node._fused_cfg = {"step": step, "weights_dtype": w_dtype, "n": n}
    node._fused_attached = True
