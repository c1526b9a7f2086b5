"""Compute-path ops: surrogate gradients and the hand-written CUDA kernels.

Kernels are compiled at first use, never on import (``ops._build``).
"""

from .generic_fused import attach_generic_fused_step
from .surrogate import spike

__all__ = ["attach_generic_fused_step", "spike"]
