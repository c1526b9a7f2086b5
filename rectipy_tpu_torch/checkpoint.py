"""Checkpoint / resume for networks and training runs.

Counterpart of ``rectipy_tpu/checkpoint.py``.  Snapshots of (params, state,
optimizer state, metadata) are ``.npz`` files with the JAX package's
flattened key layout (``"params/nodes/<label>/<key>"``, a tuple's items by
index; ``None`` is an empty subtree), so that long training runs survive
restarts.  The JAX package saves with Orbax where it can; the port writes
``.npz`` alone.

numpy has no bfloat16: a bfloat16 leaf is stored as its 16-bit patterns in
an array of the one-field record dtype ``[("bfloat16", "<u2")]``, which
names the dtype, keeps the key layout and needs no pickle; it is restored
bit for bit.

Usage::

    save_network(net, "/path/ckpt")            # params + node/edge state
    restore_network(net, "/path/ckpt")         # in-place restore

    ckpt = TrainCheckpointer("/path/ckpts")    # rolling training snapshots
    ckpt.save(step, train=train, opt_state=opt_state, state=state)
    # restore needs a structure template (same tree shape as was saved):
    step, pieces = ckpt.restore_latest(
        {"train": train, "opt_state": opt_state, "state": state})
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import trees

__all__ = ["save_network", "restore_network", "save_pytree", "restore_pytree",
           "TrainCheckpointer"]

# a bfloat16 leaf on disk: its bit patterns under a field named for the dtype
BF16_RECORD = np.dtype([("bfloat16", "<u2")])


def _key(path) -> str:
    return "/".join(map(str, path))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(BF16_RECORD)
        return t.numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    """``{"a/b/c": array}`` of a tree's leaves, keyed as the JAX package's
    ``_flatten_with_paths`` keys them."""
    return {_key(path): _to_numpy(leaf) for path, leaf in trees.items(tree)}


def _from_numpy(arr: np.ndarray, like, key: str):
    """The stored ``arr`` as a leaf like the template's ``like``: a tensor of
    its dtype on its device, a numpy array of its dtype, or a Python
    scalar."""
    if arr.dtype == BF16_RECORD:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = None
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"Checkpoint leaf {key!r} has shape {arr.shape}, the template "
                             f"{tuple(like.shape)}")
        if t is None:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if t is not None:
        raise ValueError(f"Checkpoint leaf {key!r} is bfloat16; the template's is not a tensor")
    if isinstance(like, np.ndarray):
        if arr.shape != like.shape:
            raise ValueError(f"Checkpoint leaf {key!r} has shape {arr.shape}, the template "
                             f"{like.shape}")
        return arr.astype(like.dtype)
    if arr.shape != ():
        raise ValueError(f"Checkpoint leaf {key!r} has shape {arr.shape}; the template's is "
                         f"a scalar")
    return type(like)(arr.item()) if isinstance(like, (bool, int, float)) else arr.item()


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(tree, path: str) -> None:
    """Persist a tree of tensors, arrays and scalars as ``path`` + ``.npz``."""
    np.savez(_npz(path), **_flatten_with_paths(tree))


def restore_pytree(template, path: str):
    """Restore a tree saved by :func:`save_pytree` into ``template``'s
    structure: each tensor leaf takes the template leaf's dtype and device
    (bfloat16 bit for bit), each array its dtype, each scalar its type.  A
    missing file raises ``FileNotFoundError``, a missing leaf ``KeyError``,
    a leaf of another shape ``ValueError``."""
    npz_path = _npz(path)
    if not os.path.exists(npz_path):
        raise FileNotFoundError(f"No checkpoint found at {path!r} ({npz_path} is missing)")
    with np.load(npz_path) as data:
        def restore(p, leaf):
            key = _key(p)
            if key not in data.files:
                raise KeyError(f"Checkpoint {npz_path} is missing leaf {key!r}")
            return _from_numpy(data[key], leaf, key)

        return trees.rebuild(template, restore)


def _canonicalize_plastic_edges(tree: dict) -> None:
    """Add the lazily-created STDP eligibility trace to every plastic edge
    missing it (zeros of the weights' shape and dtype, as ``fit_stdp``'s
    first reward fit makes it), so that snapshot and template structures
    match whether or not a network has run reward-modulated STDP yet.  In
    place; host-side zeros (never device memory)."""
    for edge_params in tree.get("params", {}).get("edges", {}).values():
        if ("x_pre" in edge_params and "x_post" in edge_params
                and "elig" not in edge_params):
            w = edge_params["weights"]
            edge_params["elig"] = torch.zeros(tuple(w.shape), dtype=w.dtype)


def _all_edges(net):
    # graph edges first; a feedback edge sharing (u, v) with a graph edge is
    # skipped (get_edge resolves graph-first, so the sidecar stays
    # consistent with where the attributes would be written back)
    seen = set()
    for u, v in list(net.graph.edges):
        seen.add((u, v))
        yield u, v, net.get_edge(u, v)
    for u, v, edge in net._fb_edge_list():
        if (u, v) not in seen:
            yield u, v, edge


def _homeo_sidecar(net) -> dict:
    """Homeostatic-scaling side-state (``fit_stdp(homeostasis_steps=)``) of
    every 2-D STDP edge: the per-row target and the schedule's phase are
    edge ATTRIBUTES (not params), so snapshots carry them in a sidecar
    section.  Edges that never ran homeostasis get ``set=False`` and zero
    placeholders, so the structure depends only on the network."""
    side = {}
    for u, v, edge in _all_edges(net):
        p = getattr(edge, "params", None)
        if not (p and "x_pre" in p and "x_post" in p and p["weights"].dim() == 2):
            continue
        tgt = getattr(edge, "_homeo_target", None)
        w = p["weights"]
        side[f"{u}->{v}"] = {
            "set": torch.tensor(tgt is not None),
            "phase": torch.tensor(int(getattr(edge, "_homeo_phase", 0)), dtype=torch.int32),
            "target": tgt if tgt is not None else torch.zeros(w.shape[0], dtype=w.dtype),
        }
    return side


def save_network(net, path: str) -> None:
    """Snapshot a Network's parameters and state (nodes, edges, feedback),
    plus plasticity side-state (the STDP eligibility canonicalized into
    params; homeostasis target and phase in a sidecar section)."""
    net.compile()
    payload = {"params": net.parameters_pytree(), "state": net.init_state()}
    _canonicalize_plastic_edges(payload)
    homeo = _homeo_sidecar(net)
    if homeo:
        payload["homeo"] = homeo
    save_pytree(payload, path)


def _clear_homeo(edge) -> None:
    for attr in ("_homeo_target", "_homeo_phase"):
        if hasattr(edge, attr):
            delattr(edge, attr)


def restore_network(net, path: str) -> None:
    """Restore a snapshot produced by :func:`save_network` into ``net``.

    A node with a fused kernel attached rebuilds its kernel's copies (the
    coupling in the kernel's dtype, ``eta``) from the restored parameters,
    as ``set_param`` does."""
    net.compile()

    def _template(with_elig: bool, with_homeo: bool) -> dict:
        t = {"params": net.parameters_pytree(), "state": net.init_state()}
        if with_elig:
            _canonicalize_plastic_edges(t)
        if with_homeo:
            homeo = _homeo_sidecar(net)
            if homeo:
                t["homeo"] = homeo
        return t

    # fallback chain for snapshots of older layouts (no homeo sidecar, no
    # canonicalized eligibility)
    payload = None
    for with_elig, with_homeo in ((True, True), (True, False), (False, False)):
        try:
            payload = restore_pytree(_template(with_elig, with_homeo), path)
            break
        except (ValueError, KeyError):
            if (with_elig, with_homeo) == (False, False):
                raise
    # an all-zero eligibility trace is the lazy init: drop it, so that a
    # never-reward-trained edge carries no dead (n_out, n_in) zeros
    for ekey, sub in payload["params"]["edges"].items():
        elig = sub.get("elig")
        if elig is not None:
            edge = net.get_edge(*ekey.split("->", 1))
            if bool(elig.any()):
                sub["elig"] = elig.to(edge.params["weights"].device)
            else:
                del sub["elig"]
                edge.params.pop("elig", None)
    net._write_back(state=payload["state"], params=payload["params"])
    for label in net._compiled["order"]:
        for refresh in getattr(net.get_node(label), "_fused_refresh", {}).values():
            refresh()
    if "homeo" in payload:
        for ekey, side in payload["homeo"].items():
            edge = net.get_edge(*ekey.split("->", 1))
            if bool(side["set"]):
                edge._homeo_target = side["target"].to(edge.params["weights"].device)
                edge._homeo_phase = int(side["phase"])
            else:  # snapshot taken before any homeostatic fit on this edge
                _clear_homeo(edge)
    else:
        # a snapshot with no homeo sidecar: clear any schedule state of the
        # live net -- resuming the PRE-restore schedule against restored
        # weights would scale rows toward the wrong target (the next
        # fit_stdp re-derives it)
        for _, _, edge in _all_edges(net):
            _clear_homeo(edge)


class TrainCheckpointer:
    """Rolling step-indexed checkpoints of (train params, opt state, model
    state) with a JSON manifest -- resume support for long fits."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def save(self, step: int, **pieces) -> str:
        path = self._path(step)
        save_pytree(pieces, path)
        manifest = os.path.join(self.directory, "manifest.json")
        steps = sorted(set(self.all_steps() + [step]))
        # prune old checkpoints beyond `keep`
        for old in steps[:-self.keep] if self.keep else []:
            for suffix in ("", ".npz"):
                p = self._path(old) + suffix
                if os.path.isfile(p):
                    os.remove(p)
                elif os.path.isdir(p):
                    shutil.rmtree(p, ignore_errors=True)
            steps.remove(old)
        with open(manifest, "w") as f:
            json.dump({"steps": steps}, f)
        return path

    def all_steps(self) -> list:
        manifest = os.path.join(self.directory, "manifest.json")
        if os.path.exists(manifest):
            with open(manifest) as f:
                return list(json.load(f).get("steps", []))
        steps = []
        for name in os.listdir(self.directory):
            m = re.match(r"step_(\d+)", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(set(steps))

    def restore_latest(self, template: dict) -> Tuple[Optional[int], Optional[dict]]:
        steps = self.all_steps()
        if not steps:
            return None, None
        step = steps[-1]
        return step, restore_pytree(template, self._path(step))
