"""Fixed-fan-in connectivity sampling: the native fast path and the numpy
fallback (counterpart of ``rectipy_tpu/native/connectivity.py``)."""

from __future__ import annotations

import ctypes

import numpy as np

from .build import load_native


def sample_fixed_fanin(n: int, m: int, n_conns: int, seed: int = 0,
                       force_numpy: bool = False) -> np.ndarray:
    """Sample ``n_conns`` distinct column indices in ``[0, m)`` per row.

    Returns an ``(n, n_conns)`` int64 array.  Uses the C++ Floyd sampler
    (O(n*k), deterministic per seed) when the toolchain is available; the
    numpy fallback is the argsort construction of
    ``utility.random_connectivity``."""
    if n_conns > m:
        raise ValueError(f"n_conns={n_conns} exceeds m={m}")
    lib = None if force_numpy else load_native("connectivity")
    if lib is not None:
        fn = lib.sample_fixed_fanin
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                       ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        cols = np.empty((n, n_conns), dtype=np.int64)
        scratch = np.empty(4 * n_conns, dtype=np.int64)
        rc = fn(n, m, n_conns, seed,
                cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc == 0:
            return cols
    rng = np.random.default_rng(seed)
    return np.argsort(rng.random((n, m)), axis=1)[:, :n_conns].astype(np.int64)


def fill_block_fanin(blocks: np.ndarray, source_blocks: int, block_size: int,
                     fan_in: int, seed: int, w: float) -> bool:
    """Fill a zeroed ``(nb_out, source_blocks, bs, bs)`` float32 block tensor
    in place with fixed fan-in rows through the C++ Floyd sampler
    (``sample_block_fanin`` in connectivity.cpp).  Returns False when the
    native library is unavailable or the array does not qualify; the caller
    (``ops/sparse.block_random_connectivity``) then takes numpy."""
    lib = load_native("connectivity")
    if lib is None or not hasattr(lib, "sample_block_fanin"):
        return False
    if blocks.dtype != np.float32 or not blocks.flags["C_CONTIGUOUS"]:
        return False
    fn = lib.sample_block_fanin
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_uint64, ctypes.c_float,
                   ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)]
    scratch = np.empty(4 * fan_in, dtype=np.int64)
    rc = fn(blocks.shape[0], source_blocks, block_size, fan_in, seed, ctypes.c_float(w),
            blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return rc == 0
