"""YAML model-definition DSL and its PyTorch lowering.

The template format of the JAX package (``rectipy_tpu.dsl``), read with the
port's own YAML reader and lowered symbolically (never unrolling N node
copies) into vector fields on torch tensors.
"""

from .expr import ExprError, evaluate, free_symbols, parse, split_equation, substitute
from .parser import (
    CircuitTemplate,
    NodeTemplate,
    OperatorTemplate,
    TemplateError,
    VarSpec,
    clear_frontend_caches,
    load_template,
)
from .lower import VectorField, lower

__all__ = [
    "CircuitTemplate",
    "ExprError",
    "NodeTemplate",
    "OperatorTemplate",
    "TemplateError",
    "VarSpec",
    "VectorField",
    "clear_frontend_caches",
    "evaluate",
    "free_symbols",
    "load_template",
    "lower",
    "parse",
    "split_equation",
    "substitute",
]
