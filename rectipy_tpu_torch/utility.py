"""Connectivity generators, normalization, and scoring utilities.

Copy of ``rectipy_tpu/utility.py`` (numpy only).  One difference:
``random_connectivity`` has no native C++ sampler here, so every backend
choice but ``'native'`` builds the matrix with numpy, and ``'native'``
raises.
"""

from __future__ import annotations

from typing import Union

import numpy as np

__all__ = [
    "retrieve_from_dict",
    "add_op_name",
    "circular_connectivity",
    "line_connectivity",
    "random_connectivity",
    "input_connections",
    "normalize",
    "wta_score",
]


def retrieve_from_dict(keys: list, data: dict) -> dict:
    """Pop ``keys`` out of ``data`` into a new dict (reference:
    RectiPy's rectipy/utility.py:10-29)."""
    return {key: data.pop(key) for key in list(keys) if key in data}


def add_op_name(op: str, var: Union[str, None], new_var_names: dict) -> Union[str, None]:
    """Prefix a bare variable name with its operator, recording the mapping
    (reference: RectiPy's rectipy/utility.py:32-56).  Names already
    qualified (``op/var``) are recorded under their bare part; ``weights`` and
    ``None`` pass through untouched."""
    if var is None or var == "weights":
        return var
    if "/" in var:
        _, v = var.split("/", 1)
        new_var_names[v] = var
        return var
    new_var_names[var] = f"{op}/{var}"
    return new_var_names[var]


def _wrap_ring(idxs: np.ndarray, n: int) -> np.ndarray:
    return np.mod(idxs, n)


def circular_connectivity(
    N: int,
    p: float,
    spatial_distribution,
    homogeneous_weights: bool = True,
    rng: np.random.Generator = None,
) -> np.ndarray:
    """Ring-topology coupling: each node draws ``int(N*p)`` source offsets from
    ``spatial_distribution`` (a ``scipy.stats`` discrete distribution), with
    random sign, wrapped around the ring.  Row = target node.

    ``homogeneous_weights=True`` gives every realized in-edge the weight
    ``1/k`` (k = number of unique sources); otherwise weights are
    multiplicities/n_draws.
    """
    rng = rng or np.random.default_rng()
    C = np.zeros((N, N))
    n_conns = int(N * p)
    for n in range(N):
        offsets = np.asarray(spatial_distribution.rvs(size=n_conns))
        signs = rng.choice([-1, 1], size=n_conns)
        conns = _wrap_ring(n + offsets * signs, N)
        uniq, counts = np.unique(conns, return_counts=True)
        if homogeneous_weights:
            C[n, uniq] = 1.0 / len(uniq)
        else:
            C[n, uniq] = counts / n_conns
    return C


def line_connectivity(
    N: int,
    p: float,
    spatial_distribution,
    homogeneous_weights: bool = True,
    rng: np.random.Generator = None,
) -> np.ndarray:
    """Like :func:`circular_connectivity` but on a line: out-of-range draws are
    dropped instead of wrapped."""
    rng = rng or np.random.default_rng()
    C = np.zeros((N, N))
    n_conns = int(N * p)
    for n in range(N):
        offsets = np.asarray(spatial_distribution.rvs(size=n_conns))
        signs = rng.choice([-1, 1], size=n_conns)
        conns = n + offsets * signs
        conns = conns[(conns > 0) & (conns < N)]
        uniq, counts = np.unique(conns, return_counts=True)
        if len(uniq) == 0:
            continue
        if homogeneous_weights:
            C[n, uniq] = 1.0 / len(uniq)
        else:
            C[n, uniq] = counts / len(conns)
    return C


def random_connectivity(
    n: int, m: int, p: float, normalize: bool = True, rng: np.random.Generator = None,
    backend: str = "auto",
) -> np.ndarray:
    """Fixed fan-in random coupling: every row receives exactly ``int(m*p)``
    connections; ``normalize=True`` scales rows to sum to 1.

    ``backend``: 'numpy' (argsort construction, O(n m log m)), 'native' (the
    C++ Floyd sampler of ``native/``, O(n k)), or 'auto' (native for
    ``n * m >= 10_000_000`` when no ``rng`` is given, numpy otherwise), as
    in the JAX package.  A given ``rng`` seeds the native sampler from its
    stream.
    """
    n_conns = int(m * p)
    use_native = backend == "native" or (
        backend == "auto" and rng is None and n * m >= 10_000_000)
    if use_native:
        from . import native

        seed = int((rng or np.random.default_rng()).integers(2 ** 62))
        cols = native.sample_fixed_fanin(n, m, n_conns, seed=seed)
    else:
        rng = rng or np.random.default_rng()
        # vectorized fixed-fan-in sampling: argsort of uniform noise gives a
        # permutation per row
        cols = np.argsort(rng.random((n, m)), axis=1)[:, :n_conns]
    C = np.zeros((n, m))
    rows = np.repeat(np.arange(n), n_conns)
    C[rows, cols.ravel()] = 1.0 / n_conns if normalize else 1.0
    return C


def input_connections(
    n: int,
    m: int,
    p: float,
    variance: float = 1.0,
    zero_mean: bool = True,
    rng: np.random.Generator = None,
) -> np.ndarray:
    """Sparse Gaussian input weights (n x m); each column has ``int(n*p)``
    nonzero entries; ``zero_mean`` recenters each column's nonzeros."""
    rng = rng or np.random.default_rng()
    C = np.zeros((n, m))
    n_conns = int(n * p)
    for col in range(m):
        rows = rng.permutation(n)[:n_conns]
        vals = rng.standard_normal(n_conns) * variance
        if zero_mean:
            vals = vals - vals.mean()
        C[rows, col] = vals
    return C


def normalize(x: np.ndarray, mode: str = "minmax", row_wise: bool = False) -> np.ndarray:
    """In-place matrix normalization: 'minmax' (to [0,1]), 'zscore', or 'sum'
    (to total 1); optionally independently per row."""
    if row_wise:
        for i in range(x.shape[0]):
            x[i, :] = normalize(x[i, :], mode=mode, row_wise=False)
        return x
    flat = x.ravel()
    if mode == "minmax":
        x -= flat.min()
        mx = x.max()
        if mx > 0:
            x /= mx
    elif mode == "zscore":
        x -= flat.mean()
        sd = flat.std()
        if sd > 0:
            x /= sd
    elif mode == "sum":
        x /= flat.sum()
    else:
        raise ValueError(f"Invalid normalization mode: {mode}.")
    return x


def wta_score(x: np.ndarray, y: np.ndarray) -> float:
    """Winner-take-all accuracy: fraction of rows where argmax(x) == argmax(y)."""
    return float(np.mean(np.argmax(x, axis=1) == np.argmax(y, axis=1)))
