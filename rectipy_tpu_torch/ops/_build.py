"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library's file name carries a hash of the ``csrc/`` sources and the flags, so
an edited source builds anew; a finished build is reused by later processes.
Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, NamedTuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: str
    log: str  # nvcc's output (ptxas register/spill report); empty when reused
    seconds: float  # compile time; 0.0 when reused


_built: Dict[str, Built] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """``$NVCC``, then ``nvcc`` on ``PATH``, then ``$CUDA_HOME/bin/nvcc``."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc was not found (looked at $NVCC, PATH and $CUDA_HOME/bin); the CUDA "
        "kernels of rectipy_tpu_torch are compiled at first use and need the "
        "CUDA toolkit.")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith((".cu", ".cuh")):
            h.update(fname.encode())
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a build of the current sources
    exists, load it, and return it.  A failed compile raises
    ``RuntimeError`` with nvcc's output."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    path = os.path.join(BUILD_DIR, f"lib{name}_{_digest()}.so")
    with _lock:
        if path in _built:
            return _built[path]
        log, seconds = "", 0.0
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)  # atomic: a concurrent process never sees half a file
            log = proc.stdout + proc.stderr
        built = Built(ctypes.CDLL(path), path, log, seconds)
        _built[path] = built
        return built
