"""Compute-path ops: surrogate gradients and the hand-written CUDA kernels.

Kernels are compiled at first use, never on import (``ops._build``).
"""

from .surrogate import spike

__all__ = ["spike"]
