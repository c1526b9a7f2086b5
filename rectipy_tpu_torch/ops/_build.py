"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library's file name carries a hash of the ``csrc/`` sources and the flags, so
an edited source builds anew; a finished build is reused by later processes.
Generated sources (the generic fused step's, ``dsl/cuda.py``) are written
under ``_build/gen/`` and built the same way, with ``csrc/`` on the include
path; their hash covers the generated text too.  Nothing here runs when the
package is imported.
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
GEN_DIR = os.path.join(BUILD_DIR, "gen")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: str
    log: str  # nvcc's output (ptxas register/spill report); empty when reused
    seconds: float  # compile time; 0.0 when reused


_built: Dict[str, Built] = {}
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


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


def _build_once(src: str, path: str, write_src: str = None) -> Built:
    """Load the library ``path``, compiling ``src`` into it first unless it
    exists (writing ``write_src`` to ``src`` before, when given).  One lock
    per library; files appear by atomic rename, so a concurrent process never
    sees half of one."""
    with _locks_guard:
        lock = _locks.setdefault(path, threading.Lock())
    with lock:
        if path in _built:
            return _built[path]
        log, seconds = "", 0.0
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            if write_src is not None:
                with open(tmp, "w") as f:
                    f.write(write_src)
                os.replace(tmp, src)
            t0 = time.perf_counter()
            proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, src],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
            log = proc.stdout + proc.stderr
        built = Built(ctypes.CDLL(path), path, log, seconds)
        _built[path] = built
        return built


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a build of the current sources
    exists, load it, and return it.  A failed compile raises
    ``RuntimeError`` with nvcc's output.  Builds of different sources may
    run at the same time from several threads (one ``nvcc`` each)."""
    return _build_once(os.path.join(CSRC_DIR, name + ".cu"),
                       os.path.join(BUILD_DIR, f"lib{name}_{_digest()}.so"))


def build_generated(name: str, source: str) -> Built:
    """Write the generated CUDA ``source`` to ``_build/gen/<name>_<hash>.cu``
    and build it as :func:`build` builds a ``csrc/`` source (same flags,
    ``csrc/`` on the include path).  The hash covers the text, the ``csrc/``
    headers and the flags, so the same text builds once."""
    tag = hashlib.sha256((_digest() + source).encode()).hexdigest()[:16]
    return _build_once(os.path.join(GEN_DIR, f"{name}_{tag}.cu"),
                       os.path.join(GEN_DIR, f"lib{name}_{tag}.so"), write_src=source)
