"""Carry a JAX network's parameters and state into a port ``Network``.

The port keeps the JAX package's names: lowered parameter keys
(``qif_sfa_op/eta``, ``weights``), edge keys (``"inp->qif"``) and the
per-variable state layout are the same on both sides, so a network built
the same way in both packages maps one to one.  The caller hands over plain
nested dicts of numpy arrays (``np.asarray`` of each ``jax.Array``); this
module never sees JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_params"]

# keys the JAX package derives from 'weights'/'eta' when a fused Pallas step
# is attached (transposed, tile-padded copies); rebuilt here, never copied
_JAX_DERIVED = ("__wt_pad__", "__eta_pad__")


def _numpy(val) -> np.ndarray:
    arr = np.array(val)  # a writable copy (arrays from JAX are read-only)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch cannot read it
        arr = arr.astype(np.float32)
    return arr


def _like(val, old):
    """``val`` in the device/dtype of the port's current value ``old``."""
    if isinstance(old, torch.Tensor):
        return torch.as_tensor(_numpy(val)).to(device=old.device, dtype=old.dtype)
    return float(np.asarray(val))


def _unpad_state(y: np.ndarray, n_state: int, jax_node_params: dict) -> np.ndarray:
    """A JAX fused node keeps its state padded, ``[v | s | x]`` blocks of
    ``n_pad`` each; return the unpadded ``(V*n,)`` vector."""
    if y.shape[0] == n_state or "__eta_pad__" not in jax_node_params:
        return y
    n_pad = np.shape(jax_node_params["__eta_pad__"])[0]
    n_vars = y.shape[0] // n_pad
    n = n_state // n_vars
    return np.concatenate([y[i * n_pad:i * n_pad + n] for i in range(n_vars)])


def load_jax_params(net, params: dict, state: dict = None) -> None:
    """Write a JAX network's ``parameters_pytree()`` (and optionally its
    ``init_state()``), as nested dicts of numpy arrays, into the port
    network ``net`` built the same way.

    Keys the port does not have raise ``KeyError``.  The padded copies of a
    JAX network with a fused step attached (``__wt_pad__``,
    ``__eta_pad__``) are not copied: a port node with the fused kernel
    attached rebuilds its own copies from ``weights``/``eta``.  A padded
    fused state is unpadded.
    """
    net.compile()
    for label, sub in params.get("nodes", {}).items():
        if label not in net.nodes:
            raise KeyError(f"Node {label!r} does not exist in the port network.")
        node = net.get_node(label)
        args = node.args
        for key, val in sub.items():
            if key in _JAX_DERIVED:
                continue
            if key not in args:
                raise KeyError(f"Node {label!r} has no parameter {key!r} in the port.")
            args[key] = _like(val, args[key])
        for refresh in getattr(node, "_fused_refresh", {}).values():
            refresh()
    for ekey, sub in params.get("edges", {}).items():
        u, _, v = ekey.partition("->")
        if not net.graph.has_edge(u, v):
            raise KeyError(f"Edge {ekey!r} does not exist in the port network.")
        eparams = net.get_edge(u, v).params
        for key, val in sub.items():
            if key not in eparams:
                raise KeyError(f"Edge {ekey!r} has no parameter {key!r} in the port.")
            eparams[key] = _like(val, eparams[key])
    if state is None:
        return
    for label, y in state.get("nodes", {}).items():
        if y is None:
            continue
        if label not in net.nodes:
            raise KeyError(f"Node {label!r} does not exist in the port network.")
        node = net.get_node(label)
        y = _unpad_state(_numpy(y), node.y.shape[0], params.get("nodes", {}).get(label, {}))
        node.reset(y=y)
    for ekey, es in state.get("edges", {}).items():
        if es is not None:
            raise KeyError(f"Edge state of {ekey!r}: stateful edges are not ported.")
