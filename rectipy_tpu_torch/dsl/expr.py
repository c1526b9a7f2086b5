"""Equation-string -> PyTorch expression evaluator.

Counterpart of ``rectipy_tpu/dsl/expr.py``: the same tokenizer and Pratt
parser (the AST is a plain tuple tree), with the evaluation table written on
torch.  Equations are authored as plain strings in the YAML templates, e.g.
``"v' = (v^2 + eta + I_ext)/tau + k*s_in"``, and evaluated eagerly against an
environment of tensors on the population's device.

Supported grammar
-----------------
- binary operators ``+ - * / ^`` (``^`` is exponentiation, as in PyRates)
- unary minus
- parentheses
- function calls with one or more arguments (see ``FUNCTIONS``)
- identifiers (variables/parameters) and numeric literals

Reductions such as ``mean(v)`` reduce over the neuron axis and broadcast back.
Numeric literals stay Python floats; a function applied to literals only is
evaluated on the host in float64 and returns a Python float, so no constant
ever needs a host-to-device copy.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Ast = Tuple  # ('num', float) | ('var', str) | ('neg', ast) | ('bin', op, l, r) | ('call', name, [asts])

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op>\*\*|[-+*/^(),])"
    r")"
)


class ExprError(ValueError):
    """Raised on malformed equation strings."""


def tokenize(s: str) -> List[Tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None:
            if s[pos:].strip() == "":
                break
            raise ExprError(f"Cannot tokenize {s!r} at position {pos}: {s[pos:]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            tokens.append(("num", m.group("num")))
        elif m.lastgroup == "name":
            tokens.append(("name", m.group("name")))
        else:
            op = m.group("op")
            tokens.append(("op", "^" if op == "**" else op))
    tokens.append(("end", ""))
    return tokens


# precedence for binary operators; ^ binds tightest and is right-associative
_BIN_PREC = {"+": 10, "-": 10, "*": 20, "/": 20, "^": 30}
_RIGHT_ASSOC = {"^"}


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]], src: str):
        self.tokens = tokens
        self.i = 0
        self.src = src

    def peek(self) -> Tuple[str, str]:
        return self.tokens[self.i]

    def next(self) -> Tuple[str, str]:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect_op(self, op: str):
        kind, val = self.next()
        if kind != "op" or val != op:
            raise ExprError(f"Expected {op!r} in {self.src!r}, got {val!r}")

    def parse_expr(self, min_prec: int = 0) -> Ast:
        left = self.parse_unary()
        while True:
            kind, val = self.peek()
            if kind != "op" or val not in _BIN_PREC:
                break
            prec = _BIN_PREC[val]
            if prec < min_prec:
                break
            self.next()
            next_min = prec if val in _RIGHT_ASSOC else prec + 1
            right = self.parse_expr(next_min)
            left = ("bin", val, left, right)
        return left

    def parse_unary(self) -> Ast:
        kind, val = self.peek()
        if kind == "op" and val == "-":
            self.next()
            # unary minus binds looser than ^ : -x^2 == -(x^2)
            return ("neg", self.parse_expr(_BIN_PREC["^"]))
        if kind == "op" and val == "+":
            self.next()
            return self.parse_expr(_BIN_PREC["^"])
        return self.parse_atom()

    def parse_atom(self) -> Ast:
        kind, val = self.next()
        if kind == "num":
            return ("num", float(val))
        if kind == "name":
            nkind, nval = self.peek()
            if nkind == "op" and nval == "(":
                self.next()
                args = [self.parse_expr()]
                while True:
                    akind, aval = self.peek()
                    if akind == "op" and aval == ",":
                        self.next()
                        args.append(self.parse_expr())
                    else:
                        break
                self.expect_op(")")
                return ("call", val, args)
            return ("var", val)
        if kind == "op" and val == "(":
            inner = self.parse_expr()
            self.expect_op(")")
            return inner
        raise ExprError(f"Unexpected token {val!r} in {self.src!r}")


def parse(expr: str) -> Ast:
    """Parse an equation right-hand side into an AST."""
    p = _Parser(tokenize(expr), expr)
    ast = p.parse_expr()
    kind, val = p.peek()
    if kind != "end":
        raise ExprError(f"Trailing tokens in {expr!r}: {val!r}")
    return ast


def free_symbols(ast: Ast) -> set:
    """All identifiers referenced by the expression (excluding function names)."""
    out = set()

    def rec(node):
        tag = node[0]
        if tag == "var":
            out.add(node[1])
        elif tag == "neg":
            rec(node[1])
        elif tag == "bin":
            rec(node[2])
            rec(node[3])
        elif tag == "call":
            for a in node[2]:
                rec(a)

    rec(ast)
    return out


def _tensor_fn(fn: Callable) -> Callable:
    """Apply a torch function to its arguments; when none is a tensor (all
    literals), evaluate on the host in float64 and return a Python float."""

    def wrapped(*args):
        like = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if like is None:
            return fn(*[torch.tensor(float(a), dtype=torch.float64) for a in args]).item()
        return fn(*[a if isinstance(a, torch.Tensor)
                    else torch.full((), float(a), dtype=like.dtype, device=like.device)
                    for a in args])

    return wrapped


def _interp(x, xp, fp):
    """``numpy.interp`` semantics: piecewise-linear, clamped at the ends."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    y0, y1 = fp[i - 1], fp[i]
    y = y0 + (x - x0) * (y1 - y0) / (x1 - x0)
    return torch.where(x <= xp[0], fp[0], torch.where(x >= xp[-1], fp[-1], y))


def _exprel(x):
    """(exp(x) - 1) / x with the removable singularity at 0 filled in.

    Used by conductance-based gate kinetics (Hodgkin-Huxley style
    ``alpha_m = c / exprel(-(v - v0)/s)`` rational forms), where the naive
    expression is 0/0 whenever a membrane potential lands exactly on the
    singular voltage.  The double-``where`` keeps the gradient NaN-free too
    (the masked-out branch never sees the singular input)."""
    small = torch.abs(x) < 1e-5
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 + x * 0.5, torch.expm1(safe) / safe)


def _population(fn: Callable) -> Callable:
    """A reduction over the neuron axis: the whole of a population vector,
    the last axis (kept, to broadcast back) of per-trial rows ``(B, n)``."""

    def reduce(x):
        return fn(x) if x.dim() <= 1 else fn(x, dim=-1, keepdim=True)

    return reduce


def _heaviside(x):
    # heaviside(0) = 0.0 in the equation language (jnp.heaviside(x, 0.0))
    return torch.heaviside(x, torch.zeros((), dtype=x.dtype, device=x.device))


FUNCTIONS: Dict[str, Callable] = {
    name: _tensor_fn(fn) for name, fn in {
        "exp": torch.exp,
        "log": torch.log,
        "log10": torch.log10,
        "sin": torch.sin,
        "cos": torch.cos,
        "tan": torch.tan,
        "sinh": torch.sinh,
        "cosh": torch.cosh,
        "tanh": torch.tanh,
        "arcsin": torch.asin,
        "arccos": torch.acos,
        "arctan": torch.atan,
        "sqrt": torch.sqrt,
        "abs": torch.abs,
        "absv": torch.abs,
        "sign": torch.sign,
        # population reductions (PyRates `mean()` semantics); the scalar
        # result broadcasts back over the neuron axis
        "mean": _population(torch.mean),
        "sum": _population(torch.sum),
        "min": _population(torch.amin),
        "max": _population(torch.amax),
        "maxi": torch.maximum,
        "mini": torch.minimum,
        "maximum": torch.maximum,
        "minimum": torch.minimum,
        "sigmoid": torch.sigmoid,
        "softmax": lambda x: torch.softmax(x, dim=-1),
        "heaviside": _heaviside,
        "round": torch.round,  # half to even, as jnp.round
        "floor": torch.floor,
        "ceil": torch.ceil,
        "interp": _interp,
        "expm1": torch.expm1,
        "exprel": _exprel,
        "power": torch.pow,
        "pow": torch.pow,
    }.items()
}


def _pow(base, exponent):
    # integer powers lower to repeated multiplies (the rounding the JAX
    # package's equations see); everything else uses torch.pow
    if isinstance(exponent, (int, float)) and float(exponent).is_integer() and 0 < exponent <= 4:
        out = base
        for _ in range(int(exponent) - 1):
            out = out * base
        return out
    if not isinstance(base, torch.Tensor) and not isinstance(exponent, torch.Tensor):
        return float(base) ** float(exponent)
    return torch.pow(base, exponent)


# named mathematical constants usable in equations without declaration
CONSTANTS: Dict[str, float] = {"pi": float(np.pi), "PI": float(np.pi)}


def evaluate(ast: Ast, env: Dict[str, torch.Tensor], fns: Dict[str, Callable] = None):
    """Evaluate an AST against ``env`` (name -> tensor/scalar).  ``fns``
    replaces ``FUNCTIONS`` (a population shard's reductions gather the
    whole population first)."""
    tag = ast[0]
    if tag == "num":
        return ast[1]
    if tag == "var":
        try:
            return env[ast[1]]
        except KeyError:
            if ast[1] in CONSTANTS:
                return CONSTANTS[ast[1]]
            raise KeyError(f"Unknown symbol {ast[1]!r}; available: {sorted(env)}")
    if tag == "neg":
        return -evaluate(ast[1], env, fns)
    if tag == "bin":
        op, l, r = ast[1], ast[2], ast[3]
        lv = evaluate(l, env, fns)
        if op == "^":
            rv = r[1] if r[0] == "num" else evaluate(r, env, fns)
            return _pow(lv, rv)
        rv = evaluate(r, env, fns)
        if op == "+":
            return lv + rv
        if op == "-":
            return lv - rv
        if op == "*":
            return lv * rv
        if op == "/":
            return lv / rv
        raise ExprError(f"Unknown operator {op}")
    if tag == "call":
        name, args = ast[1], ast[2]
        try:
            fn = (FUNCTIONS if fns is None else fns)[name]
        except KeyError:
            raise ExprError(f"Unknown function {name!r}; available: {sorted(FUNCTIONS)}")
        return fn(*[evaluate(a, env, fns) for a in args])
    raise ExprError(f"Malformed AST node {ast!r}")


def split_equation(eq: str) -> Tuple[str, bool, Ast]:
    """Split ``"lhs = rhs"`` -> (lhs_var, is_ode, rhs_ast).

    ``lhs'`` (trailing apostrophe, or ``d/dt * lhs`` style) marks an ODE.
    """
    if "=" not in eq:
        raise ExprError(f"Equation without '=': {eq!r}")
    lhs, rhs = eq.split("=", 1)
    lhs = lhs.strip()
    is_ode = False
    if lhs.endswith("'"):
        is_ode = True
        lhs = lhs[:-1].strip()
    m = re.fullmatch(r"d/dt\s*\*?\s*([A-Za-z_][A-Za-z_0-9]*)", lhs)
    if m:
        is_ode = True
        lhs = m.group(1)
    if not re.fullmatch(r"[A-Za-z_][A-Za-z_0-9]*", lhs):
        raise ExprError(f"Invalid equation LHS {lhs!r} in {eq!r}")
    return lhs, is_ode, parse(rhs.strip())


def substitute(eq: str, old: str, new: str) -> str:
    """Textual ``replace:`` semantics used by template inheritance.

    Identifier patterns are replaced with word-boundary awareness (so
    ``eta -> eta - x`` does not clobber ``beta``/``theta``); replacements are
    parenthesized to preserve operator precedence.  Multi-token patterns fall
    back to literal substring replacement, matching the templates' usage
    (e.g. ``k*r_in -> k*s_in``).
    """
    wrapped = f"({new.strip()})"
    if re.fullmatch(r"[A-Za-z_][A-Za-z_0-9]*", old.strip()):
        return re.sub(rf"\b{re.escape(old.strip())}\b", lambda _: wrapped, eq)
    return eq.replace(old, wrapped)
