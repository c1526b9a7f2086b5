"""Template -> PyTorch vector-field lowering.

Counterpart of ``rectipy_tpu/dsl/lower.py``.  The population is vectorized
symbolically: every variable is an ``(N,)`` tensor, the recurrent coupling is
a single ``W @ source`` matvec, and ``mean()`` reductions act over the neuron
axis.  The result is ``f(t, y, args) -> dy`` on torch tensors, with the same
``args`` keys, ``keys`` order, ``y0`` layout, ``var_map``, ``param_map``,
``read_var`` and ``alg_vars`` as the JAX lowering, so parameters and states
carry across one to one (``rectipy_tpu_torch.convert``).

Couplings, every dense type of the JAX package:
- float32/float64 (``w @ src``);
- reduced-precision float16/bfloat16, where both W and the source are cast
  to the coupling type and the products are summed in float32;
- ``'bfloat16_master'`` (``'bf16_master'``): a float master under
  ``weights``, its matvec a bfloat16 one as above, gradients through the
  cast to the master;
- ``'int8_master'`` and ``'int4_master'``: a float master under ``weights``,
  quantized per row to [-127, 127] or [-7, 7] once per run or trajectory,
  the int8/int4 matvecs of ``ops/quant.py`` with STE gradients;
- frozen ``int8`` and ``'int4'``: the weights quantized at build into
  ``weights`` (int8, or an int8 carrier of [-7, 7]) and ``weights__scale``;
  the source is STE-rounded to int8 by ``max|src|/127`` in its own dtype,
  so gradients reach the source (not the frozen weights).
The int4 products run on weights packed two per byte (``ops/quant.py``
``pack_int4``).

A block-sparse coupling (``ops/sparse.BlockSparseCoupling``) stores its
``(n_br, cb, bs, bs)`` blocks under the coupling's key and the int32
block-column table under ``<key>__cols``: float32/float64/bfloat16 blocks
(``ops/sparse.block_sparse_matvec``, float32-rounded as the JAX package's
``preferred_element_type``), ``'bfloat16_master'`` (prepped to bfloat16
once per run), frozen ``int8`` (quantized per output row on the device at
build, ``<key>__scale``; no source gradient, as in the JAX package) and
``'int8_master'`` (quantized by ``prep_args`` once per run, or by the
per-step STE matvec in plain-autograd training); every int8 block product
is the ``block_int8_mv`` kernel.  int4 block couplings raise
``NotImplementedError``, as in the JAX package.

Besides ``func``, the lowering gives the deferred-gradient trajectories
(``ops/bptt.py``) and the generic fused step (``ops/generic_fused.py``)
``tile_func`` (the vector field with the coupling results supplied from
outside), ``tile_local`` (no population reductions), ``tile_program`` (the
same field as plain data, for the CUDA emitter ``dsl/cuda.py``),
``state_order``, ``make_tile_reader`` and ``coupling_cast``, and the
inference runs ``prep_args``: the once-per-run quantization of a master
(``__q``/``__qs``), the packing of a frozen int4 carrier (``__q4``) and the
bfloat16 rounding of a ``bfloat16_master`` (``__bf16``), each under the
coupling's key with that suffix.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .expr import CONSTANTS, evaluate, free_symbols, split_equation
from .parser import NodeTemplate, OperatorTemplate, TemplateError, _strip_node_prefix

_COUPLINGS = ("None, 'float32', 'float64', 'float16', 'bfloat16', 'bfloat16_master', "
              "'int8', 'int8_master', 'int4' or 'int4_master'")


@dataclass
class LoweredVar:
    """A fully-qualified (``op/var``) variable of the lowered population."""

    op: str
    var: str
    kind: str  # 'state' | 'algebraic' | 'input' | 'param'
    default: float = 0.0
    rhs_ast: Optional[tuple] = None  # for state (ODE RHS) and algebraic vars

    @property
    def qname(self) -> str:
        return f"{self.op}/{self.var}"


@dataclass(frozen=True)
class TileProgram:
    """``tile_func`` as plain data.  Each AST's symbols resolve in its
    operator's scope (``op/sym``), else in ``CONSTANTS``."""

    state_order: Tuple[str, ...]  # state qnames, y layout order
    keys: Tuple[str, ...]  # args keys: parameters and input placeholders
    schedule: Tuple[Tuple[str, str], ...]  # (qname, 'algebraic' | 'input'), evaluation order
    algebraic: Dict[str, Tuple[tuple, str]]  # qname -> (rhs AST, operator)
    wiring: Dict[str, str]  # input qname -> the output variable it adds
    input_defaults: Dict[str, float]  # input qname -> template default
    odes: Tuple[Tuple[str, tuple, str], ...]  # (state qname, rhs AST, operator), state_order


@dataclass
class VectorField:
    """A lowered neuron population: the vector field plus its metadata."""

    n: int
    dtype: torch.dtype
    device: torch.device
    func: Callable  # func(t, y, args: dict) -> dy
    args: Dict[str, torch.Tensor]  # default parameter/input values
    keys: List[str]  # deterministic arg ordering
    y0: torch.Tensor  # flat initial state, contiguous per-variable blocks
    var_map: Dict[str, Tuple[int, int]]  # state var -> (start, stop) slice into y
    param_map: Dict[str, str]  # user-facing name -> args key
    input_vars: List[str]  # args keys that are input placeholders
    source_var: Optional[str] = None
    target_var: Optional[str] = None
    read_var: Optional[Callable] = None  # read_var(qname, y, args) -> (N,) value
    alg_vars: List[str] = field(default_factory=list)  # algebraic (non-state) variables
    # tile_func(states, args, ext) -> {state qname: derivative}: the vector
    # field with the coupling contributions supplied in ``ext``
    tile_func: Optional[Callable] = None
    # False when an equation reduces over the population (mean/sum/min/max):
    # tile_func is then right only on the whole population, and the fused
    # kernels, which evaluate it per neuron, must refuse the node
    tile_local: bool = True
    tile_program: Optional[TileProgram] = None
    state_order: List[str] = field(default_factory=list)  # state var qnames, y layout order
    make_tile_reader: Optional[Callable] = None
    couplings: List[Tuple[str, str, str]] = field(default_factory=list)  # (src, tgt, wkey)
    coupling_cast: Optional[str] = None  # 'bf16' / 'int8' / 'int4' for the master couplings
    prep_args: Optional[Callable] = None  # once-per-run prep of the couplings


def _qualify(name: str, ops: List[OperatorTemplate]) -> str:
    """Resolve a possibly-bare variable name to ``op/var``."""
    if name is None:
        raise TemplateError("Variable name is None")
    if "/" in name:
        parts = name.split("/")
        if len(parts) >= 2:
            return "/".join(parts[-2:])  # strip any 'all/' node prefix
    matches = [op.name for op in ops if name in op.variables]
    if not matches:
        raise KeyError(f"Variable {name!r} not found in operators {[op.name for op in ops]}")
    if len(matches) > 1:
        raise KeyError(f"Variable {name!r} is ambiguous across operators {matches}; qualify as 'op/var'")
    return f"{matches[0]}/{name}"


def matvec(w: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``w @ src`` for a source vector (``torch.mv``), for source rows
    ``(..., n_in)`` with one shared ``w`` (one ``(rows, n_in) @ (n_in,
    n_out)`` product), and for per-trial weights ``(B, n_out, n_in)`` with
    sources ``(B, n_in)`` (a swept coupling: a batched product)."""
    if src.dim() == 1 and w.dim() == 2:
        return torch.mv(w, src)
    if w.dim() == 2:
        return src @ w.T
    return (w @ src.unsqueeze(-1)).squeeze(-1)


def _float_matvec(w: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``w @ src`` (any source of :func:`matvec`).  A float16/bfloat16
    coupling casts BOTH operands to its type and sums the products in
    float32 (the JAX lowering's ``dot_general(...,
    preferred_element_type=float32)``): the upcast operands hold the rounded
    values exactly, so one float32 product is the same function."""
    if w.dtype in (torch.bfloat16, torch.float16):
        out = matvec(w.to(torch.float32), src.to(w.dtype).to(torch.float32))
        return out.to(src.dtype)
    if w.dtype != src.dtype:
        dt = torch.promote_types(w.dtype, src.dtype)
        return matvec(w.to(dt), src.to(dt))
    return matvec(w, src)


class _FrozenQuantDot(torch.autograd.Function):
    """``float32(sum_j W[i, j] * round(scaled)[j]) * scale[i]`` of a frozen
    int8/int4 coupling, as a function of the scaled source.  The forward
    rounds ``scaled`` to int8 and runs ``mv`` (``int8_mv`` on the int8
    weights, ``int4_mv`` on the packed ones); the backward is the
    straight-through estimator of the JAX lowering (``_int8_matvec`` /
    ``_int4_matvec``'s JVP, transposed): ``W^T @ (g * scale)`` with the int8
    carrier ``wq`` in the source's dtype."""

    @staticmethod
    def forward(ctx, scaled, wq, w_mv, scale, mv):
        ctx.save_for_backward(wq, scale)
        ctx.dtype = scaled.dtype
        xq = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
        one = torch.ones(scaled.shape[:-1] + (1,) if scaled.dim() > 1 else (),
                         dtype=torch.float32, device=scaled.device)
        return mv(w_mv, xq, scale, one)

    @staticmethod
    def backward(ctx, g):
        wq, scale = ctx.saved_tensors
        gs = (g * scale).to(ctx.dtype)
        w = wq.to(ctx.dtype)
        if gs.dim() == 1:
            dscaled = torch.mv(w.T, gs)
        elif w.dim() == 3:  # per-trial weights (a swept coupling)
            dscaled = (gs.unsqueeze(-2) @ w).squeeze(-2)
        else:
            dscaled = gs @ w
        return dscaled, None, None, None, None


def _frozen_quant_matvec(wq: torch.Tensor, w_mv: torch.Tensor, scale: torch.Tensor,
                         src: torch.Tensor, mv) -> torch.Tensor:
    """Frozen int8/int4 coupling (the JAX lowering's int8 and int4
    branches): the source is scaled by ``max|src|/127`` in its own dtype and
    rounded to int8, the integer product sums exactly, and the result is
    ``(float32(sum) * scale) * s_scale`` with the last product in the
    source's dtype.  Source rows ``(..., n_in)`` take one ``s_scale`` each
    (one per trial).  The source's gradient is straight-through; the scale
    ``s_scale`` takes none."""
    s_scale = _source_scale(src)
    return _FrozenQuantDot.apply(src / s_scale, wq, w_mv, scale, mv).to(src.dtype) * s_scale


def _frozen_block_matvec(wq: torch.Tensor, scale: torch.Tensor, cols: torch.Tensor,
                         src: torch.Tensor) -> torch.Tensor:
    """Frozen int8 block coupling (the JAX lowering's int8 block branch):
    the source rounded to int8 by ``max|src|/127`` in its own dtype, the
    ``block_int8_mv`` kernel's ``float32(sum) * scale``, then ``*
    s_scale`` in the source's dtype.  No gradient passes: the JAX package's
    cast of the rounded source to int8 passes none either."""
    from ..ops import quant  # ops imports dsl: not at module level

    s_scale = _source_scale(src)
    xq = torch.clamp(torch.round(src.detach() / s_scale), -127, 127).to(torch.int8)
    bs = wq.shape[-2]
    acc = quant.block_int8_product(wq, scale, xq.reshape(-1, src.shape[-1] // bs, bs), cols)
    return acc.reshape(*src.shape[:-1], -1).to(src.dtype) * s_scale


def _source_scale(src: torch.Tensor) -> torch.Tensor:
    """The frozen coupling's source scale, ``max|src| / 127`` in the
    source's dtype (one per row of ``(..., n_in)`` sources), divided
    exactly on every device (``ops.quant.exact_div``)."""
    from ..ops.quant import exact_div  # ops imports dsl: not at module level

    a = src.detach().abs()
    return exact_div(torch.clamp_min(a.amax() if src.dim() == 1
                                     else a.amax(dim=-1, keepdim=True), 1e-30), 127.0)


def _bf16_values(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to bfloat16 and held in float32, where a product of two
    such values is exact: a float32 matvec of them is the bfloat16 matvec
    with float32 sums, without a cast of ``w`` per step."""
    return w.to(torch.bfloat16).to(torch.float32)


def _bf16_matvec(wb: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The ``bfloat16_master`` matvec on ``wb = _bf16_values(w)``: the
    source rounded to bfloat16, the products summed in float32."""
    return matvec(wb, src.to(torch.bfloat16).to(torch.float32)).to(src.dtype)


def _broadcast(value, shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``value`` (a number, a scalar, ``(n,)``, or per trial ``(B, 1)``/``(B,
    n)``) broadcast to a state block's ``shape``, ``(n,)`` or ``(B, n)``."""
    if isinstance(value, torch.Tensor):
        return value.expand(shape)
    return torch.full(shape, float(value), dtype=dtype, device=device)


def lower(
    node: Union[str, NodeTemplate],
    n: int = None,
    weights: Optional[np.ndarray] = None,
    source_var: Optional[str] = None,
    target_var: Optional[str] = None,
    node_vars: Optional[dict] = None,
    dtype=torch.float32,
    edges: Optional[List[Tuple[str, str, np.ndarray]]] = None,
    coupling_dtype=None,
    device=None,
) -> VectorField:
    """Lower a node template replicated over ``n`` neurons into a VectorField.

    ``weights`` is the ``N x N`` recurrent coupling realized as
    ``target_var += weights @ source_var``; ``node_vars`` overrides parameter
    values or initial states with scalars or per-neuron arrays (keys may be
    ``all/op/var``, ``op/var`` or ``var``).  ``edges`` optionally adds further
    (source_var, target_var, weight-matrix) couplings beyond the primary one.
    ``coupling_dtype`` (``torch.bfloat16`` or ``torch.float16``) stores the
    coupling matrices in reduced precision with float32 accumulation.
    ``device`` places every tensor (default: CUDA; ``"cpu"`` must be asked
    for explicitly).
    """
    from ..nodes import resolve_device
    from .parser import CircuitTemplate

    device = resolve_device(device)
    if isinstance(node, CircuitTemplate):
        # prebuilt circuit: extract size, primary coupling, and overrides
        circuit = node
        if circuit.heterogeneous:
            raise TemplateError(
                f"Circuit {circuit.name!r} mixes node templates with different "
                "equations and cannot lower to one vector field; heterogeneous "
                "circuits are not ported yet (ROADMAP Queue 1 item 3)."
            )
        node = circuit.node_template
        n = n or circuit.n
        if circuit.edges and weights is None:
            sv0, tv0, weights = circuit.edges[0]
            source_var, target_var = _strip_node_prefix(sv0), _strip_node_prefix(tv0)
            extra = [(_strip_node_prefix(sv), _strip_node_prefix(tv), w)
                     for sv, tv, w in circuit.edges[1:]]
            edges = list(edges or []) + extra
        if circuit.node_vars:
            merged = dict(circuit.node_vars)
            merged.update(node_vars or {})
            node_vars = merged
    if isinstance(node, str):
        node = NodeTemplate.from_yaml(node)
    ops = node.operators
    if not ops:
        raise TemplateError(f"Node template {node.name!r} has no operators")

    # the string couplings: float masters ('bf16', 'int8', 'int4' casts) and
    # the frozen int4 carrier; a torch dtype otherwise
    cast = {"bfloat16_master": "bf16", "bf16_master": "bf16", "int8_master": "int8",
            "int4_master": "int4"}.get(coupling_dtype) if isinstance(coupling_dtype, str) else None
    int4_frozen = coupling_dtype == "int4"
    if isinstance(coupling_dtype, str) and cast is None and not int4_frozen:
        raise ValueError(f"coupling_dtype={coupling_dtype!r} is not a coupling type; use "
                         f"{_COUPLINGS}.")
    if not isinstance(coupling_dtype, str) and coupling_dtype not in (
            None, torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8):
        raise ValueError(f"coupling_dtype={coupling_dtype!r} is not a coupling type; use "
                         f"{_COUPLINGS}.")

    def _as_matrix(w):
        if hasattr(w, "blocks"):  # a BlockSparseCoupling passes through
            return w
        if isinstance(w, torch.Tensor):
            w = w.detach().cpu().numpy()
        return np.asarray(w)

    if weights is not None:
        weights = _as_matrix(weights)
        if weights.ndim != 2 or weights.shape[0] != weights.shape[1]:
            raise ValueError(f"Recurrent weights must be square, got {weights.shape}")
        if n is None:
            n = weights.shape[0]
        elif n != weights.shape[0]:
            raise ValueError(f"weights shape {weights.shape} does not match N={n}")
    if n is None:
        raise ValueError("Either `weights` or `N` must be provided to size the population")

    # ------------------------------------------------------------------ classify
    lowered: Dict[str, LoweredVar] = {}
    state_order: List[str] = []
    for op in ops:
        eq_lhs = {}
        for eq in op.equations:
            lhs, is_ode, rhs = split_equation(eq)
            if lhs not in op.variables:
                raise TemplateError(
                    f"Equation LHS {lhs!r} of operator {op.name!r} is not declared in its variables"
                )
            eq_lhs[lhs] = (is_ode, rhs)
            # state-vector layout follows equation order within each operator
            if is_ode and f"{op.name}/{lhs}" not in state_order:
                state_order.append(f"{op.name}/{lhs}")
        for vname, spec in op.variables.items():
            qname = f"{op.name}/{vname}"
            if vname in eq_lhs:
                is_ode, rhs = eq_lhs[vname]
                kind = "state" if is_ode else "algebraic"
                lowered[qname] = LoweredVar(op.name, vname, kind, spec.default, rhs)
            elif spec.role == "input":
                lowered[qname] = LoweredVar(op.name, vname, "input", spec.default)
            else:
                lowered[qname] = LoweredVar(op.name, vname, "param", spec.default)
        # symbols used in equations must all be declared
        for eq in op.equations:
            _, _, rhs = split_equation(eq)
            for sym in free_symbols(rhs):
                if sym not in op.variables and sym not in CONSTANTS:
                    raise KeyError(
                        f"Symbol {sym!r} in operator {op.name!r} equations is undeclared"
                    )

    # ----------------------------------------------------------- coupling setup
    all_edges: List[Tuple[str, str, np.ndarray, str]] = []  # (src, tgt, W, args_key)
    if weights is not None:
        if source_var is None or target_var is None:
            raise ValueError(
                "If synaptic weights are passed (`weights`), please provide the names of the "
                "source and target variable that should be connected via `weights`."
            )
        sv = _qualify(source_var, ops)
        tv = _qualify(target_var, ops)
        if sv not in lowered:
            raise KeyError(f"Source variable {sv!r} not found in node template")
        if tv not in lowered or lowered[tv].kind != "input":
            raise KeyError(f"Target variable {tv!r} is not an input variable of the node template")
        all_edges.append((sv, tv, weights, "weights"))
    for i, (esv, etv, ew) in enumerate(edges or []):
        all_edges.append((_qualify(esv, ops), _qualify(etv, ops), _as_matrix(ew), f"weights_{i}"))

    # intra-node operator wiring: an input var of op B is driven by the output
    # var of the same bare name on another op (PyRates operator-chaining).
    wiring: Dict[str, str] = {}
    out_by_name: Dict[str, str] = {}
    for op in ops:
        for vname, spec in op.variables.items():
            if spec.role == "output":
                out_by_name[vname] = f"{op.name}/{vname}"
    for qname, lv in lowered.items():
        if lv.kind == "input" and lv.var in out_by_name and out_by_name[lv.var] != qname:
            wiring[qname] = out_by_name[lv.var]

    # --------------------------------------------------------------- args & y0
    node_vars = dict(node_vars or {})
    overrides: Dict[str, np.ndarray] = {}
    for key, val in node_vars.items():
        parts = key.split("/")
        if parts[0] == "all":
            parts = parts[1:]
        if len(parts) == 2:
            qname = "/".join(parts)
        else:
            qname = _qualify(parts[-1], ops)
        if qname not in lowered:
            raise KeyError(f"node_vars key {key!r} does not match any variable")
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu().numpy()
        overrides[qname] = np.asarray(val)

    def _tensor(arr, dt=dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, dtype=np.float64)).to(device=device, dtype=dt)

    def _vectorize(value, default_scalar):
        arr = np.asarray(value if value is not None else default_scalar, dtype=np.float64)
        if arr.ndim == 0:
            return _tensor(arr)  # scalar param stays scalar
        if arr.shape == (n,):
            return _tensor(arr)
        if arr.size == 1:
            return _tensor(arr.reshape(()))
        raise ValueError(f"Override with shape {arr.shape} incompatible with N={n}")

    args: Dict[str, torch.Tensor] = {}
    keys: List[str] = []
    input_vars: List[str] = []
    for qname, lv in lowered.items():
        if lv.kind == "param":
            args[qname] = _vectorize(overrides.get(qname), lv.default)
            keys.append(qname)
        elif lv.kind == "input":
            # inputs always materialize as (N,) placeholders so external feeds broadcast
            base = overrides.get(qname)
            if base is None:
                args[qname] = torch.full((n,), float(lv.default), dtype=dtype, device=device)
            else:
                args[qname] = _vectorize(base, lv.default).expand(n).contiguous()
            keys.append(qname)
            input_vars.append(qname)
    # A master coupling stores a float master (the network's dtype), which
    # trains; its bf16 rounding or int8/int4 quantization happens once per run
    # (prep_args) or per trajectory (ops/bptt.py).  Frozen 'int8' and 'int4'
    # quantize here, once, into the weights (int8) and their row scales.
    w_dtype = dtype if (cast or int4_frozen) else (coupling_dtype or dtype)
    quant_frozen = w_dtype == torch.int8 or int4_frozen
    from ..ops import quant

    def _check_fan_in(n_in: int, wkey: str, bits: int):
        # integer products accumulate in int32: worst case 127*127*n_in per
        # output sum for int8 weights, 7*127*n_in for int4
        limit = quant.INT8_DOT_MAX_FAN_IN if bits == 8 else quant.INT4_DOT_MAX_FAN_IN
        if n_in >= limit:
            raise ValueError(
                f"Dense int{bits} coupling {wkey!r} has fan-in {n_in} >= {limit}, which can "
                f"overflow the int32 accumulator in the worst case. Use bfloat16/float32 at "
                f"this size.")

    block_q_mv: Dict[str, Callable] = {}  # int8_master block couplings' STE matvecs
    for _, _, W, wkey in all_edges:
        if hasattr(W, "blocks"):
            # a block-sparse coupling (ops/sparse.py): the blocks at the
            # coupling's type, the block-column table as an int32 arg
            from ..ops.sparse import blocks_to_device

            if int4_frozen or cast == "int4":
                raise NotImplementedError(
                    "int4 coupling is dense-only; use 'int8_master'/'int8' for block-sparse "
                    "couplings (their fan-in is already bounded per row).")
            cols = torch.as_tensor(W.cols, dtype=torch.int32).to(device)
            if quant_frozen:
                # per-output-row int8, quantized on the device a chunk of
                # block rows at a time from the float32 blocks
                args[wkey], args[wkey + "__scale"] = quant.quantize_blocks_host(W.blocks, device)
                keys.append(wkey + "__scale")
            else:
                args[wkey] = blocks_to_device(W.blocks, w_dtype, device)
                if cast == "int8":
                    block_q_mv[wkey] = quant.make_block_int8_master_matvec(cols)
            args[wkey + "__cols"] = cols
            keys.extend([wkey, wkey + "__cols"])
            continue
        if quant_frozen:
            _check_fan_in(int(W.shape[1]), wkey, 4 if int4_frozen else 8)
            quantize = quant.quantize_rows_i4 if int4_frozen else quant.quantize_rows
            args[wkey], args[wkey + "__scale"] = quantize(_tensor(W, torch.float32))
            keys.extend([wkey, wkey + "__scale"])
            continue
        if cast in ("int8", "int4"):
            _check_fan_in(int(W.shape[1]), wkey, int(cast[3:]))
        args[wkey] = _tensor(W, w_dtype)
        keys.append(wkey)
    wkeys = [wkey for _, _, _, wkey in all_edges]

    # Once-per-run prep (Network.run applies it before the time loop through
    # the node's prep_params): the prepped forms ride along in args under
    # reserved keys that _coupling_matvec picks up.  The training paths never
    # see them: plain autograd keeps the per-step STE matvec (or the cast),
    # and the deferred trajectories prep inside ops/bptt.py.
    prep_args = None
    if wkeys and (cast or int4_frozen):

        def prep_args(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            a = dict(a)
            for wk in wkeys:
                w = a[wk].detach()  # (B, n, n) for a coupling swept per trial
                if wk + "__cols" in a:  # a block coupling (B, n_br, cb, bs, bs) when swept
                    if cast == "int8":
                        a[wk + "__q"], a[wk + "__qs"] = quant.quantize_blocks(w)
                    elif cast == "bf16":
                        a[wk + "__bf16"] = w.to(torch.bfloat16)
                elif int4_frozen:
                    a[wk + "__q4"] = quant.pack_int4(w)
                elif cast == "bf16":
                    a[wk + "__bf16"] = _bf16_values(w)
                elif cast == "int8":
                    a[wk + "__q"], a[wk + "__qs"] = quant.quantize_rows(w)
                else:
                    a[wk + "__q"], a[wk + "__qs"], _ = quant._i4_prep(w)
            return a

    def _block_matvec(w, src, a, wkey):
        from ..ops.sparse import block_sparse_matvec

        cols = a[wkey + "__cols"]
        if cast == "int8" and wkey + "__q" in a:
            # prepped master (inference runs): the block_int8_mv kernel
            return quant.block_int8_matvec((a[wkey + "__q"], a[wkey + "__qs"]), cols, src)
        if cast == "int8":  # plain-autograd training: the per-step STE matvec
            return block_q_mv[wkey](w, src).to(src.dtype)
        if w.dtype == torch.int8:
            return _frozen_block_matvec(w, a[wkey + "__scale"], cols, src)
        if cast == "bf16":  # the bfloat16 copy from prep_args, else the master cast here
            w = a.get(wkey + "__bf16", w)
        bf16 = cast == "bf16" or w.dtype == torch.bfloat16
        return block_sparse_matvec(w, cols, src, cast_dtype=torch.bfloat16 if bf16 else None)

    def _coupling_matvec(w, src, a, wkey):
        if wkey + "__cols" in a:
            return _block_matvec(w, src, a, wkey)
        if cast in ("int8", "int4") and wkey + "__q" in a:
            # prepped master (inference runs): the same numerics as the
            # per-step STE matvec's forward
            mv = quant._mv_prepped if cast == "int8" else quant._mv4_prepped
            return mv((a[wkey + "__q"], a[wkey + "__qs"]), src)
        if cast in ("int8", "int4"):
            # plain-autograd training: the per-step STE matvec
            mv = quant.int8_master_matvec if cast == "int8" else quant.int4_master_matvec
            return mv(w, src).to(src.dtype)
        if cast == "bf16":
            wb = a[wkey + "__bf16"] if wkey + "__bf16" in a else _bf16_values(w)
            return _bf16_matvec(wb, src)
        if int4_frozen:
            # the packed weights from prep_args, else packed here (the JAX
            # lowering's in-body cast fallback: the same numbers, slower)
            wp = a[wkey + "__q4"] if wkey + "__q4" in a else quant.pack_int4(w)
            return _frozen_quant_matvec(w, wp, a[wkey + "__scale"], src, quant.int4_product)
        if w.dtype == torch.int8:
            return _frozen_quant_matvec(w, w, a[wkey + "__scale"], src, quant.int8_product)
        return _float_matvec(w, src)

    # initial state, contiguous per-variable blocks
    y0_parts = []
    var_map: Dict[str, Tuple[int, int]] = {}
    offset = 0
    for qname in state_order:
        lv = lowered[qname]
        init = overrides.get(qname)
        if init is None:
            block = np.full((n,), lv.default, dtype=np.float64)
        else:
            block = np.broadcast_to(np.asarray(init, dtype=np.float64), (n,))
        y0_parts.append(block)
        var_map[qname] = (offset, offset + n)
        offset += n
    y0 = _tensor(np.concatenate(y0_parts) if y0_parts else np.zeros((0,)))

    # ------------------------------------------------------- evaluation schedule
    # Topologically order input + algebraic evaluations.  Dependencies:
    #   algebraic var -> free symbols within its own op
    #   input var     -> wiring source and edge sources
    pending: Dict[str, set] = {}
    for qname, lv in lowered.items():
        if lv.kind == "algebraic":
            deps = set()
            for sym in free_symbols(lv.rhs_ast):
                if sym in CONSTANTS and f"{lv.op}/{sym}" not in lowered:
                    continue
                dep = f"{lv.op}/{sym}"
                if lowered[dep].kind in ("algebraic", "input"):
                    deps.add(dep)
            pending[qname] = deps
        elif lv.kind == "input":
            deps = set()
            if qname in wiring and lowered[wiring[qname]].kind in ("algebraic", "input"):
                deps.add(wiring[qname])
            for esv, etv, _, _ in all_edges:
                if etv == qname and lowered[esv].kind in ("algebraic", "input"):
                    deps.add(esv)
            pending[qname] = deps
    schedule: List[str] = []
    while pending:
        ready = [q for q, deps in pending.items() if not deps]
        if not ready:
            raise TemplateError(
                f"Cyclic instantaneous dependency among variables {sorted(pending)}"
            )
        for q in sorted(ready):
            schedule.append(q)
            del pending[q]
            for deps in pending.values():
                deps.discard(q)

    edge_by_target: Dict[str, List[Tuple[str, str]]] = {}
    for esv, etv, _, wkey in all_edges:
        edge_by_target.setdefault(etv, []).append((esv, wkey))

    state_slices = [(q, var_map[q]) for q in state_order]
    ode_rhs = [(q, lowered[q].rhs_ast, lowered[q].op) for q in state_order]
    alg_items = {q: (lowered[q].rhs_ast, lowered[q].op) for q in schedule if lowered[q].kind == "algebraic"}

    def _op_env(env: Dict[str, torch.Tensor], opname: str) -> Dict[str, torch.Tensor]:
        scoped = {}
        for q, v in env.items():
            o, _, bare = q.partition("/")
            if o == opname:
                scoped[bare] = v
        return scoped

    def _build_env(y, a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Evaluate all state slices, inputs and algebraic vars."""
        env: Dict[str, torch.Tensor] = {}
        for qname, (lo, hi) in state_slices:
            env[qname] = y[..., lo:hi]
        for k in keys:
            env[k] = a[k]
        for qname in schedule:
            lv = lowered[qname]
            if lv.kind == "algebraic":
                rhs_ast, opname = alg_items[qname]
                env[qname] = evaluate(rhs_ast, _op_env(env, opname))
            else:  # input: placeholder + wiring + coupling
                val = env[qname]
                if qname in wiring:
                    val = val + env[wiring[qname]]
                for esv, wkey in edge_by_target.get(qname, []):
                    val = val + _coupling_matvec(a[wkey], env[esv], a, wkey)
                env[qname] = val
        return env

    def func(t, y, a: Dict[str, torch.Tensor]):
        del t  # autonomous systems only (the Euler call is f(0, y, ...))
        env = _build_env(y, a)
        dy_parts = []
        shape = y.shape[:-1] + (n,)
        for qname, rhs_ast, opname in ode_rhs:
            dv = evaluate(rhs_ast, _op_env(env, opname))
            dy_parts.append(_broadcast(dv, shape, y.dtype, y.device))
        return torch.cat(dy_parts, dim=-1) if dy_parts else torch.zeros_like(y)

    alg_names = [q for q in schedule if lowered[q].kind == "algebraic"]

    # ---- coupling-free variant (trajectories and fused kernels) -------------
    # Evaluates the same schedule with every coupling contribution supplied
    # precomputed via ``ext`` (the matvec happens outside).  The trajectories
    # evaluate it on the full population, so population reductions
    # (mean/sum/min/max over neurons) are exact there; the fused kernels
    # evaluate it per neuron and refuse templates with reductions
    # (``tile_local``).
    def _uses_reduction(ast) -> bool:
        tag = ast[0]
        if tag == "call":
            return ast[1] in ("mean", "sum", "min", "max") or any(
                _uses_reduction(x) for x in ast[2])
        if tag == "neg":
            return _uses_reduction(ast[1])
        if tag == "bin":
            return _uses_reduction(ast[2]) or _uses_reduction(ast[3])
        return False

    tile_local = not any(lv.rhs_ast is not None and _uses_reduction(lv.rhs_ast)
                         for lv in lowered.values())
    def tile_func(states: Dict[str, torch.Tensor], a_tile: Dict[str, torch.Tensor],
                  ext: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        env: Dict[str, torch.Tensor] = dict(states)
        for k in keys:
            if k in a_tile:
                env[k] = a_tile[k]
        for qname in schedule:
            lv = lowered[qname]
            if lv.kind == "algebraic":
                rhs_ast, opname = alg_items[qname]
                env[qname] = evaluate(rhs_ast, _op_env(env, opname))
            else:
                val = env.get(qname, lv.default)
                if qname in wiring:
                    val = val + env[wiring[qname]]
                if qname in ext:
                    val = val + ext[qname]
                env[qname] = val
        first = next(iter(states.values()))
        return {qname: _broadcast(evaluate(rhs_ast, _op_env(env, opname)), first.shape,
                                  first.dtype, first.device)
                for qname, rhs_ast, opname in ode_rhs}

    def make_tile_reader(qname: str, allow_global: bool = False):
        """Reader ``(states, args) -> value`` of a state or algebraic
        variable that depends (transitively) only on states and parameters;
        ``None`` when it reads a coupling-driven input.  Templates with
        population reductions give ``None`` too, unless ``allow_global``
        (the trajectories, which evaluate on the whole population)."""
        if not tile_local and not allow_global:
            return None
        if qname in var_map:
            return lambda states, a_tile: states[qname]
        if qname not in lowered or lowered[qname].kind != "algebraic":
            return None

        def deps_ok(q, seen=()):
            lv = lowered[q]
            if lv.kind in ("state", "param"):
                return True
            if lv.kind == "input":
                if q in edge_by_target:
                    return False  # coupling-driven: needs the global matvec
                if q in wiring:
                    return deps_ok(wiring[q], seen + (q,))
                return True  # pure external placeholder
            for sym in free_symbols(lv.rhs_ast):
                if sym in CONSTANTS and f"{lv.op}/{sym}" not in lowered:
                    continue
                dep = f"{lv.op}/{sym}"
                if dep in seen:
                    continue
                if not deps_ok(dep, seen + (q,)):
                    return False
            return True

        if not deps_ok(qname):
            return None

        def reader(states: Dict[str, torch.Tensor], a_tile: Dict[str, torch.Tensor]):
            env: Dict[str, torch.Tensor] = dict(states)
            for k in keys:
                if k in a_tile:
                    env[k] = a_tile[k]
            for q in schedule:
                lv = lowered[q]
                if lv.kind == "algebraic":
                    rhs_ast, opname = alg_items[q]
                    env[q] = evaluate(rhs_ast, _op_env(env, opname))
                elif lv.kind == "input" and q in wiring:
                    env[q] = env.get(q, lv.default) + env[wiring[q]]
                if q == qname:
                    break
            return env[qname]

        return reader

    def read_var(qname: str, y, a: Dict[str, torch.Tensor]):
        """Read the current value of a state, algebraic, or input variable.

        ``vmap_full`` (below) binds late, so bare state-variable aliases work.
        """
        if qname in vmap_full:
            lo, hi = vmap_full[qname]
            return y[..., lo:hi]
        env = _build_env(y, a)
        if qname not in env:
            raise KeyError(f"Variable {qname!r} not found in lowered population")
        return _broadcast(env[qname], y.shape[:-1] + (n,), y.dtype, y.device)

    # user-facing name maps: qualified plus unambiguous bare names
    param_map: Dict[str, str] = {}
    for k in keys:
        param_map[k] = k
    bare_counts: Dict[str, int] = {}
    for k in keys:
        bare = k.split("/")[-1]
        bare_counts[bare] = bare_counts.get(bare, 0) + 1
    for k in keys:
        bare = k.split("/")[-1]
        if bare_counts[bare] == 1 and bare not in param_map:
            param_map[bare] = k
    vmap_full = dict(var_map)
    bare_counts = {}
    for k in var_map:
        bare = k.split("/")[-1]
        bare_counts[bare] = bare_counts.get(bare, 0) + 1
    for k in list(var_map):
        bare = k.split("/")[-1]
        if bare_counts[bare] == 1 and bare not in vmap_full:
            vmap_full[bare] = var_map[k]

    return VectorField(
        n=n,
        dtype=dtype,
        device=device,
        func=func,
        args=args,
        keys=keys,
        y0=y0,
        var_map=vmap_full,
        param_map=param_map,
        input_vars=input_vars,
        source_var=_qualify(source_var, ops) if source_var else None,
        target_var=_qualify(target_var, ops) if target_var else None,
        read_var=read_var,
        alg_vars=alg_names,
        tile_func=tile_func,
        tile_local=tile_local,
        tile_program=TileProgram(
            state_order=tuple(state_order),
            keys=tuple(keys),
            schedule=tuple((q, lowered[q].kind) for q in schedule),
            algebraic=dict(alg_items),
            wiring=dict(wiring),
            input_defaults={q: float(lowered[q].default) for q in input_vars},
            odes=tuple(ode_rhs),
        ),
        state_order=list(state_order),
        make_tile_reader=make_tile_reader,
        couplings=[(esv, etv, wkey) for esv, etv, _, wkey in all_edges],
        coupling_cast=cast,
        prep_args=prep_args,
    )
