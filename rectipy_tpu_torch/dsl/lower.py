"""Template -> PyTorch vector-field lowering.

Counterpart of ``rectipy_tpu/dsl/lower.py``.  The population is vectorized
symbolically: every variable is an ``(N,)`` tensor, the recurrent coupling is
a single ``W @ source`` matvec, and ``mean()`` reductions act over the neuron
axis.  The result is ``f(t, y, args) -> dy`` on torch tensors, with the same
``args`` keys, ``keys`` order, ``y0`` layout, ``var_map``, ``param_map``,
``read_var`` and ``alg_vars`` as the JAX lowering, so parameters and states
carry across one to one (``rectipy_tpu_torch.convert``).

Couplings: dense float32/float64 (``w @ src``) and reduced-precision dense
float16/bfloat16, where both W and the source are cast to the coupling type
and the products are summed in float32.  The int8/int4, ``*_master`` and
block-sparse couplings of the JAX package are not ported yet (ROADMAP,
Queue 1 items 5 and 10) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .expr import CONSTANTS, evaluate, free_symbols, split_equation
from .parser import NodeTemplate, OperatorTemplate, TemplateError, _strip_node_prefix

_QUANT_TODO = ("ROADMAP Queue 1 item 5 (quantized and master-weight couplings) is not "
               "ported yet; use coupling_dtype=None, 'float32' or 'bfloat16'.")


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
    couplings: List[Tuple[str, str, str]] = field(default_factory=list)  # (src, tgt, wkey)


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


def _coupling_matvec(w: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``w @ src``.  A float16/bfloat16 coupling casts BOTH operands to its
    type and sums the products in float32 (the JAX lowering's
    ``dot_general(..., preferred_element_type=float32)``): the upcast
    operands hold the rounded values exactly, so one float32 product is the
    same function."""
    if w.dtype in (torch.bfloat16, torch.float16):
        out = torch.mv(w.to(torch.float32), src.to(w.dtype).to(torch.float32))
        return out.to(src.dtype)
    if w.dtype != src.dtype:
        dt = torch.promote_types(w.dtype, src.dtype)
        return torch.mv(w.to(dt), src.to(dt))
    return torch.mv(w, src)


def _broadcast(value, n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.expand(n)
    return torch.full((n,), float(value), dtype=dtype, device=device)


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

    if isinstance(coupling_dtype, str) and coupling_dtype in (
            "bfloat16_master", "bf16_master", "int8_master", "int4_master", "int4"):
        raise NotImplementedError(f"coupling_dtype={coupling_dtype!r}: {_QUANT_TODO}")
    if coupling_dtype is not None and coupling_dtype not in (
            torch.float32, torch.float64, torch.float16, torch.bfloat16):
        raise NotImplementedError(f"coupling_dtype={coupling_dtype!r}: {_QUANT_TODO}")

    def _as_matrix(w):
        if hasattr(w, "blocks"):
            raise NotImplementedError(
                "Block-sparse couplings are not ported yet (ROADMAP Queue 1 item 10).")
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
    w_dtype = coupling_dtype or dtype
    for _, _, W, wkey in all_edges:
        args[wkey] = _tensor(W, w_dtype)
        keys.append(wkey)

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
            env[qname] = y[lo:hi]
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
                    val = val + _coupling_matvec(a[wkey], env[esv])
                env[qname] = val
        return env

    def func(t, y, a: Dict[str, torch.Tensor]):
        del t  # autonomous systems only (the Euler call is f(0, y, ...))
        env = _build_env(y, a)
        dy_parts = []
        for qname, rhs_ast, opname in ode_rhs:
            dv = evaluate(rhs_ast, _op_env(env, opname))
            dy_parts.append(_broadcast(dv, n, y.dtype, y.device))
        return torch.cat(dy_parts) if dy_parts else torch.zeros_like(y)

    alg_names = [q for q in schedule if lowered[q].kind == "algebraic"]

    def read_var(qname: str, y, a: Dict[str, torch.Tensor]):
        """Read the current value of a state, algebraic, or input variable.

        ``vmap_full`` (below) binds late, so bare state-variable aliases work.
        """
        if qname in vmap_full:
            lo, hi = vmap_full[qname]
            return y[lo:hi]
        env = _build_env(y, a)
        if qname not in env:
            raise KeyError(f"Variable {qname!r} not found in lowered population")
        return _broadcast(env[qname], n, y.dtype, y.device)

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
        couplings=[(esv, etv, wkey) for esv, etv, _, wkey in all_edges],
    )
