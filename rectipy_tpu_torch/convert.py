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


def _like(val, old, where: str = ""):
    """``val`` in the device/dtype of the port's current value ``old``.  A
    matrix or block tensor (two or more axes on either side: a coupling, its
    blocks, a block-column table) must keep its shape, or ``KeyError``; the
    values are carried as they are (quantized ones are never requantized)."""
    if isinstance(old, torch.Tensor):
        arr = _numpy(val)
        if (old.dim() >= 2 or arr.ndim >= 2) and tuple(arr.shape) != tuple(old.shape):
            raise KeyError(f"{where} has shape {tuple(arr.shape)} in the JAX network and "
                           f"{tuple(old.shape)} in the port's.")
        return torch.as_tensor(arr).to(device=old.device, dtype=old.dtype)
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


def _edge_state(ekey: str, val, old):
    """A JAX edge state (a delay buffer, a filter state, an STP ``(u, x)``
    pair) in the layout of the port edge's current state ``old``; a state
    whose structure or shapes differ raises ``KeyError``."""
    if isinstance(old, tuple):
        if not isinstance(val, (tuple, list)) or len(val) != len(old):
            raise KeyError(f"Edge state of {ekey!r}: expected a {len(old)}-tuple.")
        return tuple(_edge_state(ekey, v, o) for v, o in zip(val, old))
    if old is None or isinstance(val, (tuple, list)) or np.shape(val) != tuple(old.shape):
        want = "no state" if old is None else f"a state of shape {tuple(old.shape)}"
        raise KeyError(f"Edge state of {ekey!r} does not match the port edge's: {want}.")
    return torch.as_tensor(_numpy(val)).to(device=old.device, dtype=old.dtype)


def load_jax_params(net, params: dict, state: dict = None) -> None:
    """Write a JAX network's ``parameters_pytree()`` (and optionally its
    ``init_state()``), as nested dicts of numpy arrays, into the port
    network ``net`` built the same way.  That covers every dense coupling:
    the float master ``weights`` of a ``bfloat16_master``, ``int8_master``
    or ``int4_master`` node, the int8 ``weights`` (for ``int4``, the int8
    carrier of [-7, 7]) and their ``weights__scale`` of a frozen ``int8`` or
    ``int4`` node, a block-sparse coupling (its blocks, ``weights__cols``
    and a frozen ``int8`` one's ``weights__scale``, carried as they are),
    the edges' parameters (feedback edges too: ``weights``, a
    ``BlockSparseLinear``'s blocks, a mask, a filter, the float ``delays``
    of an ``interp`` delay matrix, an ``RLS`` edge's ``P``) and, in
    ``state``, the edges' states (the delay buffers, a filter's ``y``, an
    STP edge's ``(u, x)``, a block edge's ``(hist, t)``; a state whose
    structure or shape differs raises ``KeyError``, and so does a
    parameter with two or more axes whose shape differs).  A state with
    ``"fb"`` (the feedback outputs of a ``FeedbackNetwork``) sets the port
    network's carried feedback outputs.

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
            args[key] = _like(val, args[key], f"Parameter {key!r} of node {label!r}")
        for refresh in getattr(node, "_fused_refresh", {}).values():
            refresh()
    for ekey, sub in params.get("edges", {}).items():
        u, _, v = ekey.partition("->")
        try:  # get_edge also finds a FeedbackNetwork's feedback edges
            eparams = net.get_edge(u, v).params
        except KeyError:
            raise KeyError(f"Edge {ekey!r} does not exist in the port network.")
        for key, val in sub.items():
            if key not in eparams:
                raise KeyError(f"Edge {ekey!r} has no parameter {key!r} in the port.")
            eparams[key] = _like(val, eparams[key], f"Parameter {key!r} of edge {ekey!r}")
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
        if es is None:
            continue
        u, _, v = ekey.partition("->")
        try:
            edge = net.get_edge(u, v)
        except KeyError:
            raise KeyError(f"Edge {ekey!r} does not exist in the port network.")
        edge.set_state(_edge_state(ekey, es, edge.init_state()))
    if state.get("fb"):
        # the previous-step feedback outputs (the JAX network's _fb_store
        # after a run, else its sources' current outputs)
        port_fb = net.init_state()["fb"]
        net._fb_store = {u: torch.as_tensor(_numpy(val)).to(device=port_fb[u].device,
                                                             dtype=port_fb[u].dtype)
                         for u, val in state["fb"].items()}
