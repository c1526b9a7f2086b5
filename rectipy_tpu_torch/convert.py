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

# keys the JAX package derives from the couplings and per-neuron parameters
# when a fused Pallas step is attached (transposed, tile-padded copies):
# '__wt_pad__'/'__eta_pad__' (the QIF step), '__wt_pad_{c}__'/'__row_{k}__'
# (the generic step); rebuilt here, never copied
_JAX_DERIVED = ("__wt_pad__", "__eta_pad__")
_JAX_DERIVED_PREFIXES = ("__wt_pad_", "__row_")
# the once-per-run prepped forms of a coupling (dsl/lower.py prep_args): the
# quantized master ('__q', '__qs'), the packed int4 carrier ('__q4') and the
# bf16-rounded master ('__bf16'); rebuilt by every run, never copied
_PREPPED_SUFFIXES = ("__q", "__qs", "__q4", "__bf16")


def _jax_derived(key: str) -> bool:
    return (key in _JAX_DERIVED or key.startswith(_JAX_DERIVED_PREFIXES)
            or key.endswith(_PREPPED_SUFFIXES))


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
    """A JAX fused node keeps its state padded, one block of ``n_pad`` per
    state variable; return the unpadded ``(V*n,)`` vector.  ``n_pad`` is
    the length of ``__eta_pad__`` (the QIF step) or of a ``__row_*__`` or
    ``__wt_pad_0__`` copy (the generic step)."""
    if y.shape[0] == n_state:
        return y
    if "__eta_pad__" in jax_node_params:
        n_pad = np.shape(jax_node_params["__eta_pad__"])[0]
    else:
        rows = [k for k in jax_node_params if k.startswith("__row_")]
        if rows:
            n_pad = np.shape(jax_node_params[rows[0]])[-1]
        elif "__wt_pad_0__" in jax_node_params:
            n_pad = np.shape(jax_node_params["__wt_pad_0__"])[0]
        else:
            return y
    n_vars = y.shape[0] // n_pad
    n = n_state // n_vars
    return np.concatenate([y[i * n_pad:i * n_pad + n] for i in range(n_vars)])


def load_jax_params(net, params: dict, state: dict = None) -> None:
    """Write a JAX network's ``parameters_pytree()`` (and optionally its
    ``init_state()``), as nested dicts of numpy arrays, into the port
    network ``net`` built the same way.  That covers every dense coupling:
    the float master ``weights`` of a ``bfloat16_master``, ``int8_master``
    or ``int4_master`` node, the int8 ``weights`` (for ``int4``, the int8
    carrier of [-7, 7]) and their ``weights__scale`` of a frozen ``int8`` or
    ``int4`` node, and trainable ``Linear`` edges.

    Keys the port does not have raise ``KeyError``.  The padded copies of a
    JAX network with a fused step attached (``__wt_pad__``, ``__eta_pad__``,
    ``__wt_pad_{c}__``, ``__row_{k}__``) are not copied: a port node with a
    fused kernel attached rebuilds its own copies from the couplings and
    parameters.  Nor are the prepped forms of a coupling (``__q``,
    ``__qs``, ``__q4``, ``__bf16``), which every run rebuilds.  A padded
    fused state is unpadded.
    """
    net.compile()
    for label, sub in params.get("nodes", {}).items():
        if label not in net.nodes:
            raise KeyError(f"Node {label!r} does not exist in the port network.")
        node = net.get_node(label)
        args = node.args
        for key, val in sub.items():
            if _jax_derived(key):
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
