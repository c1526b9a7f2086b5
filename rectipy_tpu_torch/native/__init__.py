"""Native (C++) host-side helpers, bound with ctypes.

Counterpart of ``rectipy_tpu/native``: ``connectivity.cpp`` is compiled
with g++ at first use into the package's ``_build/`` directory; every entry
point has a numpy fallback, so the package works without a toolchain.
"""

from .build import load_native
from .connectivity import fill_block_fanin, sample_fixed_fanin

__all__ = ["fill_block_fanin", "load_native", "sample_fixed_fanin"]
