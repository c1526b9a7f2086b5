"""Serving bundles: export a network's step once, serve it without the model.

Counterpart of ``rectipy_tpu/serving.py``.  A network's one-step program is
exported with :mod:`torch.export` together with a parameter/state snapshot,
and served later by a process that builds no
:class:`~rectipy_tpu_torch.network.Network`: no YAML templates, no DSL
lowering, no model definition.

Usage::

    # build side (model definition available)
    net = Network(dt); net.add_diffeq_node(...); ...
    export_network(net, "/path/bundle", T=1000)

    # serving side
    from rectipy_tpu_torch.serving import load_network   # or vendor this module
    model = load_network("/path/bundle")
    outs = model(inputs)          # (T, m) -> (R, n_out); state carries over
    model.reset()                 # back to the exported state snapshot

The bundle is a directory: ``meta.json``, the programs ``step.pt2`` and (when
the network's parameters have a once-per-call prep, such as the
quantization of an ``int8_master`` coupling) ``prep.pt2``, written by
``torch.export.save`` without example inputs, ``snapshot.npz``, the
ordered tensor leaves of ``(params, state)``, and, for a generic fused
step, ``generic/`` (below).  No pickle, no Python source, no YAML.  A
bfloat16 leaf, which numpy lacks, is stored as its 16-bit pattern and
``meta.json`` records its dtype.  Python scalars among the parameters are
baked into the programs as constants, and ``meta.json`` lists them under
``baked``.

Where the JAX package exports the whole ``T``-step ``lax.scan``, this module
exports ONE step, ``(prepped params, state, x_t) -> (state', out_t)``, and
:class:`ServedNetwork` loops it ``T`` times on the host: each request runs
the same kernels as :meth:`Network.run`, step for step, and a
``T``-step loop is not built from PyTorch's private ``scan``.  The prep
program runs once per call, before the loop, as in ``run``.  ``R = T //
sampling_steps`` contiguous window means are returned (the trailing partial
window dropped), ``batch=B`` exports the ensemble step of
:meth:`Network.run_batch` (shared parameters, per-trial state), and
``n_in=1`` exports the single-channel broadcast drive.

**Kernels.**  The hand-written kernels reach an exported program as the
registered operators of ``rectipy_tpu_torch/ops/library.py`` (every forward
kernel of the package: the fused QIF and generic steps, single and B-row,
and the int8, int4 and int8 block products); ``meta.json`` lists those a
program calls under ``ops``.  A program that calls one needs that module,
hence the package, in the serving process: StableHLO embeds a Pallas
kernel, but ``torch.export`` cannot embed a kernel launched through
``ctypes``.  :func:`load_network` imports the op library only when
``meta.json`` lists an operator, so a bundle without one loads with torch
and numpy alone, from this file vendored on its own.

The generic fused step's CUDA source is generated from the node's
template, and its operators name the source by a key (a hash of the text).
A bundle whose programs call them carries, under ``generic/``, each key's
generated text (``<key>.cu``) and, when the bundle may be served on the
CPU, the node's plain step exported at the bundle's shapes as a program of
its own (``<key>_<i>.pt2``, one for each operator, set of baked scalars and
shapes the step calls); ``meta.json`` lists them under ``generic``.
:func:`load_network` records them with the op library before it loads the
step, and on CUDA builds the text (the same text builds once a process),
so a process that builds no network, reads no template and lowers nothing
serves the bundle.  A missing source, one whose hash is not its key, or
one that fails to build raises; nothing stands in for the kernel.

**Devices.**  A bundle records the device type it was exported on and the
``platforms`` it may be served on.  :func:`load_network` serves on the
exported device by default; another device of ``platforms`` moves the
programs (``torch.export.passes.move_to_device_pass``); anything else
raises.  A CUDA bundle never falls back to the CPU on its own.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["export_network", "load_network", "ServedNetwork"]

_STEP = "step.pt2"
_PREP = "prep.pt2"
_SNAPSHOT = "snapshot.npz"
_META = "meta.json"
_GENERIC = "generic"  # ops/library.py's GENERIC_DIR
# 2 adds generic/ and meta["generic"]; a version-1 bundle (no generic
# step) reads as one whose meta["generic"] is empty
_FORMAT_VERSION = 2
_READS = (1, 2)
_PLATFORMS = ("cpu", "cuda")
_OP_NAMESPACE = "rectipy"


def _path(path) -> str:
    return "/".join(map(str, path))


def _jsonable(value):
    if isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, np.generic):
        return value.item()
    return repr(value)


# --------------------------------------------------------------- export
class _Program(torch.nn.Module):
    """An ``nn.Module`` around a function of flat tensor arguments, the form
    ``torch.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *flat):
        return self._fn(*flat)


def _unaliased(outs, inputs) -> tuple:
    """The outputs, each that shares storage with an input cloned: an
    exported program's output may not alias its input (the fused QIF step
    returns the pre-update ``s``, a view of the old state)."""
    res = []
    for t in outs:
        root = t._base if t._base is not None else t
        res.append(t.clone() if any(root is u for u in inputs) else t)
    return tuple(res)


def _export(fn, args):
    # an input that views another input's storage (a fused node's row that
    # is its parameter itself) is traced as a tensor of its own: torch.export
    # gives such an input a symbolic size, which moving the program to
    # another device cannot evaluate; the program is the same function
    first, example = {}, []
    for a in args:
        ptr = a.untyped_storage().data_ptr()
        if first.setdefault(ptr, a) is not a:
            a = a.clone()
        example.append(a)
    with torch.no_grad():
        ep = torch.export.export(_Program(fn), tuple(example))
    ep.example_inputs = None  # no pickled sample inputs in the bundle
    return ep


def _op_nodes(ep):
    """The graph's calls of ``rectipy::`` operators."""
    return [node for node in ep.graph.nodes if node.op == "call_function"
            and getattr(node.target, "namespace", None) == _OP_NAMESPACE]


def _program_ops(ep) -> list:
    """The ``rectipy::`` operators an exported program calls."""
    return sorted({node.target._schema.name for node in _op_nodes(ep)})


def export_network(net, path: str, T: int, sampling_steps: int = 1,
                   n_in: Optional[int] = None, batch: Optional[int] = None,
                   platforms: Optional[Sequence[str]] = None) -> str:
    """Export ``net``'s step and prep programs and a params/state snapshot
    as a serving bundle at directory ``path``; returns ``path``.

    The input signature is fixed at ``(T, n_in)`` in the network dtype;
    ``n_in=1`` exports the single-channel drive broadcast across the input
    population (the broadcast :meth:`Network.run` accepts).  ``batch=B``
    exports the ``B``-trial ensemble (:meth:`Network.run_batch` semantics:
    shared params, per-trial state, ``(B, T, n_in)`` inputs; the products
    take the batched kernels).  ``platforms``: the device types (``"cpu"``,
    ``"cuda"``) the bundle may be served on; default the network's own.

    The programs are traced on the network's device with ``torch.export``
    under ``torch.no_grad()``; the kernels they reach are the op library's
    operators, and a generic fused step brings its generated source and,
    for the CPU, its plain step (see the module docstring).
    """
    from .trees import fill, items

    def tensors(tree) -> list:
        return [leaf for _, leaf in items(tree) if isinstance(leaf, torch.Tensor)]

    def fill_tensors(tree, values):
        it = iter(values)
        return fill(tree, [next(it) if isinstance(leaf, torch.Tensor) else leaf
                           for _, leaf in items(tree)])

    net.compile()
    T = int(T)
    if T < 1:
        raise ValueError(f"T={T} must be >= 1")
    if batch is not None and int(batch) < 1:
        raise ValueError(f"batch={batch} must be >= 1")
    s = int(sampling_steps)
    if s < 1:
        raise ValueError(f"sampling_steps={sampling_steps} must be >= 1")
    m = int(net.n_in) if n_in is None else int(n_in)
    if m not in (1, int(net.n_in)):
        raise ValueError(f"n_in={m} must be 1 (broadcast) or the input node "
                         f"width {net.n_in}")
    device = torch.device(net.device)
    platforms = [device.type] if platforms is None else list(platforms)
    for p in platforms:
        if p not in _PLATFORMS:
            raise ValueError(f"platforms: {p!r} is not one of {_PLATFORMS}")

    step = net.make_step()
    params = net.parameters_pytree()
    state0 = net.init_state()
    if batch:
        state0 = net._batch_state(state0, int(batch))
    for key, leaf in items(state0):
        if not isinstance(leaf, torch.Tensor):
            raise ValueError(f"The state leaf {_path(key)!r} is not a tensor "
                             f"({type(leaf).__name__}); it cannot be carried by a bundle")
    p_leaves, s_leaves = tensors(params), tensors(state0)
    baked = {_path(key): _jsonable(leaf) for key, leaf in items(params)
             if not isinstance(leaf, torch.Tensor)}

    # the prep: each prepped tensor leaf is a parameter leaf passed through
    # or one that the prep program computes
    with torch.no_grad():
        prepped0 = net._prep_params(params)
    index = {id(t): i for i, t in enumerate(p_leaves)}
    prep_src, n_comp = [], 0
    for leaf in tensors(prepped0):
        if id(leaf) in index:
            prep_src.append(["leaf", index[id(leaf)]])
        else:
            prep_src.append(["prep", n_comp])
            n_comp += 1

    def prep_fn(*flat):
        prepped = net._prep_params(fill_tensors(params, flat))
        ids = {id(t) for t in flat}
        computed = [t for t in tensors(prepped) if id(t) not in ids]
        if len(computed) != n_comp:
            raise RuntimeError("export_network: the traced prep computed another set of "
                               "leaves than the eager one")
        return _unaliased(computed, flat)

    n_pp = len(prep_src)
    s_paths = [key for key, _ in items(state0)]

    def step_fn(*flat):
        prepped = fill_tensors(prepped0, flat[:n_pp])
        state = fill_tensors(state0, flat[n_pp:-1])
        new_state, out, _ = step(state, prepped, flat[-1])
        new = list(items(new_state))
        if [key for key, _ in new] != s_paths or not all(
                isinstance(leaf, torch.Tensor) for _, leaf in new):
            raise RuntimeError("export_network: the step changed the state's structure")
        return _unaliased([leaf for _, leaf in new] + [out], flat)

    x_shape = (m,) if batch is None else (int(batch), m)
    x0 = torch.zeros(x_shape, dtype=net.dtype, device=device)
    prep_ep = _export(prep_fn, p_leaves) if n_comp else None
    prepped_leaves = tensors(prepped0)
    step_ep = _export(step_fn, prepped_leaves + s_leaves + [x0])
    ops = sorted(set(_program_ops(step_ep)) | set(_program_ops(prep_ep) if prep_ep else ()))

    os.makedirs(path, exist_ok=True)
    for name in (_STEP, _PREP):  # a bundle written over an older one
        if os.path.exists(os.path.join(path, name)):
            os.remove(os.path.join(path, name))
    shutil.rmtree(os.path.join(path, _GENERIC), ignore_errors=True)
    torch.export.save(step_ep, os.path.join(path, _STEP))
    if prep_ep is not None:
        torch.export.save(prep_ep, os.path.join(path, _PREP))
    generic = {}
    if ops:
        from .ops import library

        generic = library.export_generic(
            [node for ep in (step_ep, prep_ep) if ep is not None for node in _op_nodes(ep)],
            path, "cpu" in platforms, _export)

    leaves = p_leaves + s_leaves
    aliases, stored, dtypes = {}, {}, []
    first = {}
    for i, leaf in enumerate(leaves):
        dtypes.append(str(leaf.dtype).replace("torch.", ""))
        if id(leaf) in first:  # the same tensor twice (e.g. a fused copy of W)
            aliases[str(i)] = first[id(leaf)]
            continue
        first[id(leaf)] = i
        host = leaf.detach().cpu()
        if host.dtype == torch.bfloat16:
            host = host.view(torch.int16)
        stored[f"leaf_{i:05d}"] = host.numpy()
    np.savez(os.path.join(path, _SNAPSHOT), **stored)
    meta = {
        "format_version": _FORMAT_VERSION,
        "T": T,
        "n_in": m,
        "n_out": int(net.n_out),
        "sampling_steps": s,
        "batch": int(batch) if batch is not None else None,
        "dt": float(net.dt),
        "dtype": str(net.dtype).replace("torch.", ""),
        "n_leaves": len(leaves),
        "n_params": len(p_leaves),
        "leaf_dtypes": dtypes,
        "aliases": aliases,
        "prep": prep_src,
        "programs": {"step": _STEP, "prep": _PREP if prep_ep is not None else None},
        "ops": ops,
        "generic": generic,
        "baked": baked,
        "device": device.type,
        "platforms": platforms,
    }
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return path


# --------------------------------------------------------------- serving
def _callable(ep):
    """The exported program's graph as a function of its user inputs, with
    its lifted constants, parameters and buffers bound once.  The unlifted
    ``ep.module()`` flattens and checks every call's inputs, which costs
    more than a step of the main network; the served step calls the graph
    directly (the loop feeds it only tensors it made itself)."""
    from torch.export.graph_signature import InputKind, OutputKind

    sig = ep.graph_signature
    if any(spec.kind != OutputKind.USER_OUTPUT for spec in sig.output_specs):
        raise ValueError("serving: the program mutates its inputs or buffers")
    slots = []
    for spec in sig.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            slots.append(None)
        elif spec.target in ep.constants:
            slots.append(ep.constants[spec.target])
        else:
            slots.append(ep.state_dict[spec.target])
    forward = ep.graph_module.forward
    user = [i for i, slot in enumerate(slots) if slot is None]
    if len(user) == len(slots):
        return forward

    def call(*args):
        full = list(slots)
        for i, arg in zip(user, args):
            full[i] = arg
        return forward(*full)

    return call


class ServedNetwork:
    """A loaded serving bundle: the step (and prep) programs and the carried
    leaves.  ``model(inputs)`` advances the state; :meth:`reset` restores
    the exported snapshot.  Needs torch and numpy, and the op library when
    the programs call one of its operators."""

    def __init__(self, step, prep, leaves, meta: dict, device: torch.device):
        self._step = step
        self._prep = prep
        self._leaves0 = list(leaves)
        self._leaves = list(leaves)
        self.meta = dict(meta)
        self.device = device
        self._dtype = getattr(torch, meta["dtype"])

    @property
    def T(self) -> int:
        return self.meta["T"]

    @property
    def n_in(self) -> int:
        return self.meta["n_in"]

    @property
    def n_out(self) -> int:
        return self.meta["n_out"]

    def _prepped(self) -> list:
        n_p = self.meta["n_params"]
        params = self._leaves[:n_p]
        computed = self._prep(*params) if self._prep is not None else ()
        return [params[i] if kind == "leaf" else computed[i] for kind, i in self.meta["prep"]]

    def __call__(self, inputs) -> np.ndarray:
        """``(T, n_in)`` inputs (``(B, T, n_in)`` for a batched bundle) ->
        ``(R, n_out)`` outputs (``(B, R, n_out)``); the carried state
        advances (chain calls for longer horizons, exactly like chained
        ``Network.run`` windows)."""
        if isinstance(inputs, torch.Tensor):
            inputs = inputs.detach().to(device=self.device, dtype=self._dtype)
        else:
            inputs = torch.as_tensor(np.asarray(inputs), dtype=self._dtype, device=self.device)
        batch = self.meta.get("batch")
        expect = (self.T, self.n_in) if not batch else (batch, self.T, self.n_in)
        if tuple(inputs.shape) != expect:
            raise ValueError(
                f"ServedNetwork expects inputs of the exported shape {expect} "
                f"(the program is ahead-of-time exported), got {tuple(inputs.shape)}")
        n_p = self.meta["n_params"]
        with torch.no_grad():
            prepped = self._prepped()
            state = tuple(self._leaves[n_p:])
            step = self._step
            outs = []
            for x in inputs.unbind(1 if batch else 0):
                res = step(*prepped, *state, x)
                state, out = res[:-1], res[-1]
                outs.append(out)
            axis = 1 if batch else 0
            outs = torch.stack(outs, dim=axis)
            s = self.meta["sampling_steps"]
            if s > 1:
                R = self.T // s
                outs = outs.narrow(axis, 0, R * s)
                outs = outs.reshape(outs.shape[:axis] + (R, s) + outs.shape[axis + 1:])
                outs = outs.mean(dim=axis + 1)
        self._leaves = self._leaves[:n_p] + list(state)
        if outs.dtype == torch.bfloat16:
            outs = outs.float()
        return outs.cpu().numpy()

    def reset(self) -> None:
        """Restore the exported parameter/state snapshot."""
        self._leaves = list(self._leaves0)


def _load_ep(path: str, device: torch.device, moved: bool):
    """The exported program at ``path``, moved to ``device`` when ``moved``."""
    ep = torch.export.load(path)
    if moved:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, device)
        # the pass moves the constants, parameters and buffers; the tensors
        # a program makes (aten.ones, aten.full, ...) and its metadata
        # checks keep the exported device in their keyword arguments
        gm = ep.graph_module
        for node in gm.graph.nodes:
            dev = node.kwargs.get("device")
            if isinstance(dev, torch.device) and dev != device:
                node.kwargs = {**node.kwargs, "device": device}
        gm.recompile()
    return ep


def _load_program(path: str, device: torch.device, moved: bool):
    return _callable(_load_ep(path, device, moved))


def load_network(path: str, device=None) -> ServedNetwork:
    """Load a bundle written by :func:`export_network`.

    ``device``: where to serve; default the device type the bundle was
    exported on.  A device type outside the bundle's ``platforms`` raises
    ``ValueError``; CUDA without a CUDA device raises ``RuntimeError``.  The
    op library (``rectipy_tpu_torch.ops.library``) is imported only when
    the programs call one of its operators; a generic fused step's sources
    are recorded with it first (and built, on CUDA).  Bundles of formats 1
    and 2 load."""
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    if meta.get("format_version") not in _READS:
        raise ValueError(f"Unsupported bundle format {meta.get('format_version')} "
                         f"at {path!r} (this build reads {list(_READS)})")
    meta.setdefault("generic", {})
    device = torch.device(meta["device"] if device is None else device)
    if device.type not in meta["platforms"]:
        raise ValueError(f"The bundle at {path!r} may be served on {meta['platforms']}, "
                         f"not on {device.type!r}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("The bundle is served on CUDA, but no CUDA device is "
                               "available; pass device='cpu' to serve it on the CPU "
                               "(when its platforms allow it).")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    if meta["ops"]:
        import importlib

        library = importlib.import_module("rectipy_tpu_torch.ops.library")
        library.load_generic(path, meta["generic"], device,
                             lambda file: _load_program(file, device, False))
    moved = device.type != meta["device"]
    step = _load_program(os.path.join(path, meta["programs"]["step"]), device, moved)
    prep = None
    if meta["programs"]["prep"]:
        prep = _load_program(os.path.join(path, meta["programs"]["prep"]), device, moved)
    data = np.load(os.path.join(path, _SNAPSHOT))
    leaves = []
    for i in range(meta["n_leaves"]):
        alias = meta["aliases"].get(str(i))
        if alias is not None:
            leaves.append(leaves[alias])
            continue
        t = torch.from_numpy(np.array(data[f"leaf_{i:05d}"]))
        if meta["leaf_dtypes"][i] == "bfloat16":
            t = t.view(torch.bfloat16)
        leaves.append(t.to(device))
    return ServedNetwork(step, prep, leaves, meta, device)
