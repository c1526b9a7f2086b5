"""Lazy g++ compilation and ctypes loading of the native helpers.

Counterpart of ``rectipy_tpu/native/build.py``, with one difference: the
shared library goes into the package's ``_build/`` directory (as the CUDA
kernels do, ``ops/_build.py``), not into the system's temporary directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lib_cache: dict = {}
_lock = threading.Lock()


def load_native(name: str = "connectivity") -> Optional[ctypes.CDLL]:
    """Compile (once) and load ``rectipy_tpu_torch/native/<name>.cpp``.

    Returns None when no C++ toolchain is available, and callers fall back
    to numpy.  The library's file name carries a hash of the source and the
    flags, so an edited source builds anew; a finished build is reused by
    later processes.  The file appears by atomic rename, so a concurrent
    process never loads half of one."""
    with _lock:
        if name in _lib_cache:
            return _lib_cache[name]
        src = os.path.join(_DIR, f"{name}.cpp")
        if not os.path.exists(src):
            _lib_cache[name] = None
            return None
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        with open(src, "rb") as f:
            h.update(f.read())
        so_path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so_path)
            except (OSError, subprocess.SubprocessError):
                _lib_cache[name] = None
                return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            lib = None
        _lib_cache[name] = lib
        return lib
