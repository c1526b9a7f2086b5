"""Template -> CUDA C: the tile-local vector field as a ``__device__`` function.

The generic fused step (``ops/generic_fused.py``) runs the node's own
equations inside a hand-written CUDA kernel (``csrc/generic_fused_step.cuh``).
This module writes those equations as C: :func:`emit_tail` turns a lowered
``TileProgram`` into ``gf_tail``, one neuron's ``tile_func`` over ``float``s
with the coupling sums handed in, and :func:`emit_step_source` wraps it in
the ``Program`` the kernel instantiates (shape, spike wiring, the gather of
the external slots).

Numerics follow ``dsl/expr.py`` as the plain version evaluates it:

- a per-neuron value is a float32 tensor there, so it is a ``float`` here,
  with the f32 CUDA maths functions (no fast-math);
- arithmetic on scalar parameters and literals alone is Python float
  arithmetic there, so it is ``double`` here; a literal that meets a
  per-neuron value prints as a float with 9 significant digits and an ``f``
  suffix (exactly its float32 rounding);
- integer powers 1-4 are repeated multiplies, other powers ``powf``;
  ``heaviside(0) = 0``; ``round`` rounds half to even (``rintf``); ``exprel``
  fills in its removable singularity; ``pi`` is a constant.

A function the kernel cannot evaluate per neuron (the population
reductions, ``softmax``, ``interp``) or does not know raises ``ValueError``
naming it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .expr import CONSTANTS
from .lower import TileProgram

__all__ = ["emit_tail", "emit_step_source"]

# (float version, double version) of each one-argument function
_UNARY = {
    "exp": ("expf", "exp"), "log": ("logf", "log"), "log10": ("log10f", "log10"),
    "sin": ("sinf", "sin"), "cos": ("cosf", "cos"), "tan": ("tanf", "tan"),
    "sinh": ("sinhf", "sinh"), "cosh": ("coshf", "cosh"), "tanh": ("tanhf", "tanh"),
    "arcsin": ("asinf", "asin"), "arccos": ("acosf", "acos"), "arctan": ("atanf", "atan"),
    "sqrt": ("sqrtf", "sqrt"), "abs": ("fabsf", "fabs"), "absv": ("fabsf", "fabs"),
    "floor": ("floorf", "floor"), "ceil": ("ceilf", "ceil"), "round": ("rintf", "rint"),
    "expm1": ("expm1f", "expm1"), "sign": ("gf_sign", "gf_sign"),
    "sigmoid": ("gf_sigmoid", "gf_sigmoid"), "heaviside": ("gf_heaviside", "gf_heaviside"),
    "exprel": ("gf_exprel", "gf_exprel"),
}
_BINARY = {"maxi": "gf_max", "maximum": "gf_max", "mini": "gf_min", "minimum": "gf_min",
           "power": None, "pow": None}
_NOT_PER_NEURON = ("mean", "sum", "min", "max", "softmax", "interp")

DEV, HOST = "float", "double"  # the C type of a per-neuron / a scalar-only value


def _with_point(text: str) -> str:
    return text if ("." in text or "e" in text) else text + ".0"


def _f32_literal(x: float) -> str:
    # 9 significant digits name a float32 exactly
    return _with_point(f"{float(np.float32(x)):.9g}") + "f"


def _f64_literal(x: float) -> str:
    return _with_point(repr(float(x)))


class _Emitter:
    """Typed C expressions for the ASTs of one tile program."""

    def __init__(self, symbols: Dict[str, Tuple[str, str]]):
        self.symbols = symbols  # qname -> (C expression, DEV | HOST)

    @staticmethod
    def as_float(code: str, kind: str, ast) -> str:
        if kind == DEV:
            return code
        if ast is not None and ast[0] == "num":
            return _f32_literal(ast[1])
        return f"static_cast<float>({code})"

    def expr(self, ast, op: str) -> Tuple[str, str]:
        tag = ast[0]
        if tag == "num":
            return _f64_literal(ast[1]), HOST
        if tag == "var":
            hit = self.symbols.get(f"{op}/{ast[1]}")
            if hit is not None:
                return hit
            if ast[1] in CONSTANTS:
                return _f64_literal(CONSTANTS[ast[1]]), HOST
            raise KeyError(f"Unknown symbol {ast[1]!r} in operator {op!r}")
        if tag == "neg":
            code, kind = self.expr(ast[1], op)
            return f"(-{code})", kind
        if tag == "bin":
            return self.binary(ast, op)
        if tag == "call":
            return self.call(ast, op)
        raise ValueError(f"Malformed AST node {ast!r}")

    def binary(self, ast, op: str) -> Tuple[str, str]:
        sym, left, right = ast[1], ast[2], ast[3]
        lc, lk = self.expr(left, op)
        if sym == "^":
            return self.power(lc, lk, left, right, op)
        rc, rk = self.expr(right, op)
        if lk == HOST and rk == HOST:
            return f"({lc} {sym} {rc})", HOST
        return f"({self.as_float(lc, lk, left)} {sym} {self.as_float(rc, rk, right)})", DEV

    def power(self, bc: str, bk: str, base, exp_ast, op: str) -> Tuple[str, str]:
        # expr.py's _pow: a literal exponent is read straight from the AST
        if exp_ast[0] == "num":
            e = float(exp_ast[1])
            if e.is_integer() and 0 < e <= 4:
                return (bc if e == 1 else f"gf_pow{int(e)}({bc})"), bk
            if bk == HOST:
                return f"pow({bc}, {_f64_literal(e)})", HOST
            return f"powf({bc}, {_f32_literal(e)})", DEV
        ec, ek = self.expr(exp_ast, op)
        if ek == HOST:  # a scalar exponent: the integer test is on its value
            return f"gf_pow_scalar({bc}, {ec})", bk
        return f"powf({self.as_float(bc, bk, base)}, {ec})", DEV

    def call(self, ast, op: str) -> Tuple[str, str]:
        name, args = ast[1], ast[2]
        if name in _NOT_PER_NEURON:
            raise ValueError(
                f"The CUDA emitter cannot evaluate {name}() per neuron; templates using "
                f"{name}() run on the plain path.")
        if name not in _UNARY and name not in _BINARY:
            raise ValueError(f"The CUDA emitter does not know the function {name}()")
        want = 1 if name in _UNARY else 2
        if len(args) != want:
            raise ValueError(f"{name}() takes {want} argument(s), got {len(args)}")
        typed = [self.expr(a, op) for a in args]
        host = all(k == HOST for _, k in typed)
        codes = [c for c, _ in typed] if host else [
            self.as_float(c, k, a) for (c, k), a in zip(typed, args)]
        if name in _UNARY:
            fn = _UNARY[name][1 if host else 0]
        else:
            fn = _BINARY[name] or ("pow" if host else "powf")
        return f"{fn}({', '.join(codes)})", HOST if host else DEV


def emit_tail(program: TileProgram, vec_keys: Sequence[str], scalar_keys: Sequence[str],
              ext_keys: Sequence[str], name: str = "gf_tail") -> str:
    """``__device__`` function ``name(y, p, c, e, d)`` for one neuron:
    ``y`` the states in ``program.state_order``, ``p`` the per-neuron
    arguments ``vec_keys``, ``c`` the scalar arguments ``scalar_keys``
    (doubles), ``e`` the external contributions to the inputs ``ext_keys``;
    writes the derivatives to ``d``.  Each input placeholder is its stored
    value (its row, else its template default) + its wiring + its external
    slot, as ``tile_func`` computes it."""
    symbols: Dict[str, Tuple[str, str]] = {}
    for i, q in enumerate(program.state_order):
        symbols[q] = (f"y[{i}]", DEV)
    for i, k in enumerate(vec_keys):
        symbols[k] = (f"p[{i}]", DEV)
    for i, k in enumerate(scalar_keys):
        symbols[k] = (f"c[{i}]", HOST)
    slots = {q: i for i, q in enumerate(ext_keys)}
    em = _Emitter(symbols)
    lines: List[str] = []
    for j, (q, kind) in enumerate(program.schedule):
        if kind == "algebraic":
            ast, op = program.algebraic[q]
            code, ck = em.expr(ast, op)
        else:
            stored = None if q in symbols else ("num", program.input_defaults[q])
            code, ck = symbols[q] if stored is None else em.expr(stored, "")
            if q in program.wiring:
                wc, wk = symbols[program.wiring[q]]
                code, ck = (f"({code} + {wc})", HOST) if ck == wk == HOST else (
                    f"({em.as_float(code, ck, stored)} + {em.as_float(wc, wk, None)})", DEV)
                stored = None
            if q in slots:
                code, ck = f"({em.as_float(code, ck, stored)} + e[{slots[q]}])", DEV
        local = f"t{j}"
        lines.append(f"  const {ck} {local} = {code};  // {q}")
        symbols[q] = (local, ck)
    for i, (q, ast, op) in enumerate(program.odes):
        code, ck = em.expr(ast, op)
        lines.append(f"  d[{i}] = {em.as_float(code, ck, ast)};  // {q}'")
    return (f"__device__ __forceinline__ void {name}(const float* __restrict__ y, "
            f"const float* __restrict__ p, const double* __restrict__ c, "
            f"const float* __restrict__ e, float* __restrict__ d) {{\n"
            + "\n".join(lines) + "\n}\n")


def _select(name: str, arg: str, table: Dict[int, int]) -> str:
    body = "".join(f"{arg} == {k} ? {v} : " for k, v in table.items())
    return (f"  static __host__ __device__ constexpr int {name}(int {arg}) "
            f"{{ return {body}-1; }}\n")


def emit_step_source(program: TileProgram, *, vec_keys: Sequence[str],
                     scalar_keys: Sequence[str], inp_key: str, targets: Sequence[str],
                     spike_specs: Sequence[Tuple[str, int, bool, Tuple[str, ...]]],
                     derivative: bool) -> str:
    """The generated ``.cu`` of one generic fused step: the tail, the
    ``Program`` the kernel of ``generic_fused_step.cuh`` instantiates, and
    its C entry point.  ``targets`` is each coupling's target input;
    ``spike_specs`` are ``(spike key, state index, hard reset, extra keys)``
    as ``ops/generic_fused.py`` builds them.  The external slots gather, in
    the plain version's order, the drive into ``inp_key``, then each
    coupling sum into its target, then each spike spec's ``r/dt``."""
    ext: Dict[str, str] = {inp_key: "drive"}
    for c, tgt in enumerate(targets):
        ext[tgt] = f"({ext[tgt]} + acc[{c}])" if tgt in ext else f"acc[{c}]"
    for s, (skey, _, _, extra) in enumerate(spike_specs):
        for k in (skey,) + tuple(extra):
            ext[k] = f"({ext[k]} + spk[{s}])" if k in ext else f"spk[{s}]"
    ext_keys = list(ext)
    tail = emit_tail(program, vec_keys, scalar_keys, ext_keys)
    gather = "".join(f"    e[{i}] = {ext[k]};  // {k}\n" for i, k in enumerate(ext_keys))
    resets = {vidx: s for s, (_, vidx, hard, _) in enumerate(spike_specs) if hard}
    return (
        "// Generated by rectipy_tpu_torch/dsl/cuda.py from a node template: the\n"
        "// tail of one generic fused step; the kernel is generic_fused_step.cuh.\n"
        '#include "generic_fused_step.cuh"\n\n'
        "namespace {\n\n"
        + tail +
        "\nstruct Program {\n"
        f"  static constexpr int K = {len(targets)};  // couplings\n"
        f"  static constexpr int V = {len(program.state_order)};  // state rows\n"
        f"  static constexpr int P = {len(vec_keys)};  // per-neuron rows\n"
        f"  static constexpr int C = {len(scalar_keys)};  // scalar parameters\n"
        f"  static constexpr int S = {len(spike_specs)};  // spike specs\n"
        f"  static constexpr int E = {len(ext_keys)};  // external slots\n"
        f"  static constexpr bool kDerivative = {'true' if derivative else 'false'};\n"
        + _select("spike_var", "s", {s: spec[1] for s, spec in enumerate(spike_specs)})
        + _select("reset_spec", "v", resets)
        + "  static __device__ __forceinline__ void gather(float* e, const float* acc, "
          "float drive, const float* spk) {\n" + gather + "  }\n"
        "  static __device__ __forceinline__ void tail(const float* y, const float* p, "
        "const double* c, const float* e, float* d) { gf_tail(y, p, c, e, d); }\n"
        "};\n\n"
        "}  // namespace\n\n"
        "GF_DEFINE_LAUNCH(Program)\n")
