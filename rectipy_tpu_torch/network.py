"""Network: graph container, step composition, simulation and BPTT training.

Counterpart of the simulation and epoch-mode training subset of
``rectipy_tpu/network.py``.  ``compile()`` resolves the graph once into an
evaluation order; ``make_step()`` composes the node and edge steps into one
network step ``step(state, params, x) -> (state', out, taps)``; ``run``
drives it in a Python loop over time steps with the JAX package's windowed
recording semantics; ``fit_bptt`` (epoch mode) trains through the
deferred-gradient trajectory of ``ops/bptt.py`` on chain networks and through
plain autograd otherwise.

On the device: the inputs move to the device once, the records and epoch
losses stay on the device, and nothing inside the loops synchronises with
the host; they cross to the host once, at the end.

Not ported yet (ROADMAP Queue 1 items 7-14): ``fit_bptt`` step mode,
``remat_steps`` and ``mesh=``, the other trainers, ``run_batch``,
``FeedbackNetwork``, the edge classes beyond ``Linear``, heterogeneous
circuits, on-device input specs and spike rasters.
"""

from __future__ import annotations

import os
from time import perf_counter
from typing import Callable, Dict, List, Optional, Tuple, Union

import networkx as nx
import numpy as np
import torch
from networkx import DiGraph

from .edges import Linear
from .nodes import InstantNode, RateNet, SpikeNet, SpikeResetNet, resolve_device, resolve_dtype
from .observer import Observer
from .train import get_loss_function, get_optimizer
from .train.optimizers import tree_map
from .utility import add_op_name, retrieve_from_dict

__all__ = ["Network"]


def _ekey(u: str, v: str) -> str:
    return f"{u}->{v}"


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item}).")


# RECTIPY_FUSED_ADAM: 'off' = the split optimizer (optax formulas), 'on' = the
# one-pass adam + requantize of ops/fused_opt.adam_requant (the CUDA kernel on
# the card, its plain version on CPU tensors)
FUSED_ADAM_MODES = ("off", "on")


def fused_adam_mode() -> str:
    """The ``RECTIPY_FUSED_ADAM`` mode (default ``'off'``); any other value
    raises ``ValueError``."""
    mode = os.environ.get("RECTIPY_FUSED_ADAM", "off")
    if mode not in FUSED_ADAM_MODES:
        raise ValueError(f"RECTIPY_FUSED_ADAM={mode!r} is not a valid mode; valid modes are "
                         f"{', '.join(FUSED_ADAM_MODES)}.")
    return mode


def _flatten(tree: dict) -> Tuple[list, list]:
    """Paths ``(kind, label, key)`` and leaves of a params tree."""
    paths, leaves = [], []
    for kind in sorted(tree):
        for label in sorted(tree[kind]):
            for key in sorted(tree[kind][label]):
                paths.append((kind, label, key))
                leaves.append(tree[kind][label][key])
    return paths, leaves


def _unflatten(paths: list, leaves: list) -> dict:
    tree = {"nodes": {}, "edges": {}}
    for (kind, label, key), leaf in zip(paths, leaves):
        tree[kind].setdefault(label, {})[key] = leaf
    return tree


class Network:
    """Main user interface for building and simulating networks of
    differential-equation nodes, function nodes, and linear edges.

    ``device=None`` runs on the current CUDA device and raises
    ``RuntimeError`` when there is none; pass ``device="cpu"`` to run on the
    CPU.  (The JAX package accepts ``device`` and ignores it.)  ``dtype`` is
    the default of every node and edge; unlike the JAX package, diffeq nodes
    take the network's dtype unless given their own.
    """

    def __init__(self, dt: float, device=None, dtype=torch.float32):
        self.graph = DiGraph()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.dt = dt
        self._var_map: Dict[str, str] = {}
        self._in_node: Optional[str] = None
        self._out_node: Optional[str] = None
        self._compiled = None
        self._step_cache: Dict[tuple, Callable] = {}
        self.last_fit: Optional[dict] = None  # the paths the last fit_bptt took

    # ------------------------------------------------------------- container
    def __getitem__(self, item):
        if isinstance(item, tuple):
            return self.graph[item[0]][item[1]]
        return self.graph.nodes[item]

    def __iter__(self):
        for n in self.graph.nodes:
            yield self[n]

    def __len__(self):
        return len(self.graph.nodes)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    @property
    def n_out(self) -> int:
        """Output width of the network's unique output node."""
        if self._out_node is None:
            self.compile()
        return self[self._out_node]["n_out"]

    @property
    def n_in(self) -> int:
        """Input width of the network's unique input node."""
        if self._in_node is None:
            self.compile()
        return self[self._in_node]["n_in"]

    @property
    def nodes(self):
        return self.graph.nodes

    @property
    def state(self) -> dict:
        """State vectors of each differential-equation node."""
        states = {}
        for n in self.nodes:
            node = self.get_node(n)
            if hasattr(node, "y"):
                states[n] = node.y
        return states

    def get_node(self, node: str) -> Union[InstantNode, RateNet]:
        return self[node]["node"]

    def get_edge(self, source: str, target: str) -> Linear:
        return self[source, target]["edge"]

    def get_var(self, node: str, var: str):
        try:
            return self.get_node(node)[self._relabel_var(var)]
        except KeyError:
            return self[node][var]

    def set_var(self, node: str, var: str, val):
        try:
            n = self.get_node(node)
        except KeyError:
            raise KeyError(f"Node {node!r} does not exist in the network.")
        var = self._relabel_var(var)
        try:
            n.set_param(var, val)
        except KeyError:
            # state variable: write a copy, so no earlier state is changed
            spec = getattr(n, "_var_map", {}).get(var)
            if spec is None:
                raise KeyError(f"Variable {var} was not found on node {node}.")
            lo, hi = (spec if isinstance(spec, tuple) else (spec, spec + 1))
            y = n.y.clone()
            y[lo:hi] = torch.as_tensor(np.asarray(val) if not isinstance(val, torch.Tensor)
                                       else val).to(device=y.device, dtype=y.dtype)
            n.y = y

    # -------------------------------------------------------------- building
    def add_node(self, label: str, node, node_type: str, op: str = None, **node_attrs) -> None:
        """Insert a pre-built node instance into the graph."""
        if op:
            for p in getattr(node, "parameter_names", []):
                add_op_name(op, p, self._var_map)
            for v in getattr(node, "variable_names", []):
                add_op_name(op, v, self._var_map)
        self.graph.add_node(label, node=node, node_type=node_type, n_out=node.n_out,
                            n_in=node.n_in, **node_attrs)
        self._invalidate()

    def add_diffeq_node(self, label: str, node, input_var: str, output_var: str,
                        weights: np.ndarray = None, source_var: str = None,
                        target_var: str = None, spike_var: Union[str, list] = None,
                        reset_var: Union[str, list] = None, reset: bool = True,
                        op: str = None, train_params: list = None, **kwargs) -> RateNet:
        """Add a differential-equation population node built from a YAML template.

        Mirrors the JAX package's signature: the ``op`` shorthand that
        prefixes bare variable names, the node-class dispatch on
        ``spike_var``/``reset``, ``train_params``, and ``spike_def`` as an
        alias for ``reset_var``.  The node is placed on the network's device
        and, unless ``dtype=`` is given, takes the network's dtype.
        """
        if reset_var is None and "spike_def" in kwargs:
            reset_var = kwargs.pop("spike_def")

        from .dsl.parser import CircuitTemplate

        if isinstance(node, CircuitTemplate) and node.heterogeneous:
            raise _todo("A circuit of mixed node templates", "3")

        var_dict = {"svar": source_var, "tvar": target_var, "in_ext": input_var,
                    "out": output_var, "spike": spike_var, "reset": reset_var}
        if "record_vars" in kwargs:
            var_dict["record_vars"] = kwargs.pop("record_vars")

        if op is not None:
            for key, var in var_dict.copy().items():
                if key == "record_vars":
                    kwargs["var_mapping"] = {}
                    for v in var:
                        v_new = add_op_name(op, v, self._var_map)
                        kwargs["var_mapping"][v_new] = v_new
                elif isinstance(var, list):
                    var_dict[key] = [add_op_name(op, v, self._var_map) for v in var]
                else:
                    var_dict[key] = add_op_name(op, var, self._var_map)
            if train_params:
                train_params = [add_op_name(op, p, self._var_map) for p in train_params]
            if "node_vars" in kwargs:
                for key in list(kwargs["node_vars"]):
                    if "/" not in key:
                        kwargs["node_vars"][f"all/{op}/{key}"] = kwargs["node_vars"].pop(key)

        args = (node, var_dict["in_ext"], var_dict["out"])
        kwargs.pop("device", None)
        kwargs.setdefault("dtype", self.dtype)
        build_kwargs = {"weights": weights, "source_var": var_dict["svar"],
                        "target_var": var_dict["tvar"], "train_params": train_params,
                        "dt": self.dt, "device": self.device}
        if spike_var is None:
            NodeClass = RateNet
        elif reset_var is None:
            raise ValueError(
                "To define a reservoir with a spiking neural network layer, please provide "
                "the name of the variable that should be reset after a spike occurred "
                "(`reset_var`)."
            )
        else:
            # a list spike_var makes SpikeResetNet.from_pyrates build a
            # MultiSpikeResetNet
            build_kwargs["spike_var"] = var_dict["spike"]
            build_kwargs["reset_var"] = var_dict["reset"]
            NodeClass = SpikeResetNet if reset else SpikeNet
        kwargs.update(build_kwargs)
        node_instance = NodeClass.from_pyrates(*args, **kwargs)
        self.add_node(label, node=node_instance, node_type="diff_eq", op=op)
        return node_instance

    def add_func_node(self, label: str, n: int, activation_function: str, **kwargs) -> InstantNode:
        """Add a stateless activation node: tanh/sigmoid/softmax/softmin/
        log_softmax/identity."""
        kwargs.pop("node_type", None)
        node = InstantNode(n, activation_function, **kwargs)
        self.add_node(label, node=node, node_type="func_instant")
        return node

    def add_edge(self, source: str, target: str, weights=None, train: Optional[str] = None,
                 edge_attrs: dict = None, **kwargs) -> Linear:
        """Add a ``Linear`` edge, on the network's device and dtype.
        ``train`` is ``None`` or ``'gd'``.  The other edge classes of the
        JAX package (chosen there by ``mask``/``delays``/``filter_weights``/
        ``tau_facil``/``tau_depress`` or block-sparse weights) and the online
        rules (``'rls'``, ``'eprop'``, ``'stdp'``) raise
        ``NotImplementedError``."""
        edge_attrs = dict(edge_attrs or {})
        kwargs.pop("dtype", None)
        kwargs.pop("device", None)
        special = sorted({"mask", "delays", "filter_weights", "tau_facil", "tau_depress"}
                         & set(kwargs))
        if special or hasattr(weights, "blocks"):
            raise _todo(f"An edge with {'/'.join(special) or 'block-sparse weights'}", "10")
        if train not in (None, "gd"):
            if train in ("rls", "eprop", "stdp"):
                raise _todo(f"train={train!r}", "9/12")
            raise ValueError(
                "Invalid option for keyword argument `train`. Please see the docstring of "
                "`Network.add_edge` for valid options."
            )
        kwargs.update({"n_in": self[source]["n_out"], "n_out": self[target]["n_in"],
                       "weights": weights, "dtype": self.dtype, "device": self.device})
        edge = Linear(**kwargs, detach=train is None)
        self.graph.add_edge(source, target, edge=edge, trainable=train is not None,
                            n_in=edge.n_in, n_out=edge.n_out, **edge_attrs)
        self._invalidate()
        return edge

    # ------------------------------------------------------------- compiling
    def _invalidate(self):
        self._compiled = None
        self._in_node = None
        self._out_node = None
        self._step_cache.clear()

    def compile(self):
        """Identify the unique input and output nodes and freeze the
        evaluation order.  Idempotent."""
        if self._compiled is not None and self._in_node is not None:
            return self
        in_nodes = [n for n in self.graph.nodes if self.graph.in_degree(n) == 0]
        if len(in_nodes) != 1:
            raise ValueError(
                f"Unable to identify the input node of the Network. Nodes that have no "
                f"input edges: {in_nodes}. Make sure that exactly one such node without "
                f"input edges exists in the network."
            )
        self._in_node = in_nodes.pop()

        out_nodes = [n for n in self.graph.nodes if self.graph.out_degree(n) == 0]
        if len(out_nodes) != 1:
            raise ValueError(
                f"Unable to identify the output node of the Network. Nodes that have no "
                f"outgoing edges: {out_nodes}. Make sure that exactly one such node without "
                f"outgoing edges exists in the network."
            )
        self._out_node = out_nodes.pop()

        # evaluation set: ancestors of the output node, in topological order
        ancestors = nx.ancestors(self.graph, self._out_node) | {self._out_node}
        sub = self.graph.subgraph(ancestors)
        order = list(nx.topological_sort(sub))
        if self._in_node not in ancestors:
            raise ValueError("The input node is not connected to the output node.")
        self._compiled = {"order": order}
        self._step_cache.clear()
        return self

    def _step_versions(self) -> tuple:
        """Per-node step versions: attaching a fused kernel bumps a node's
        version, invalidating every cached step composed from it."""
        order = self._compiled["order"] if self._compiled else sorted(self.graph.nodes)
        return tuple(getattr(self.get_node(n), "_step_version", 0) for n in order)

    def make_step(self, taps: Tuple[str, ...] = ()) -> Callable:
        """Build (and cache) the network step.

        ``step(state, params, x) -> (state', out, taps_dict)`` where ``state``
        and ``params`` are the trees produced by :meth:`init_state` /
        :meth:`parameters_pytree`.
        """
        if self._compiled is None:
            self.compile()
        order = self._compiled["order"]
        key = (tuple(taps), self._step_versions())
        if key in self._step_cache:
            return self._step_cache[key]

        node_steps = {n: self.get_node(n).make_step() for n in order}
        preds = {n: sorted(self.graph.predecessors(n)) for n in order}
        edge_steps = {(u, n): self.get_edge(u, n).make_step() for n in order for u in preds[n]}
        out_node = self._out_node

        def step(state, params, x):
            nodes_st = dict(state["nodes"])
            edges_st = dict(state["edges"])
            outs = {}
            for n in order:
                if preds[n]:
                    inp = None
                    for u in preds[n]:
                        k = _ekey(u, n)
                        es, val = edge_steps[(u, n)](edges_st[k], params["edges"][k], outs[u])
                        edges_st[k] = es
                        inp = val if inp is None else inp + val  # fan-in sum
                else:
                    inp = x
                ns, out = node_steps[n](nodes_st[n], params["nodes"][n], inp)
                nodes_st[n] = ns
                outs[n] = out
            return {"nodes": nodes_st, "edges": edges_st}, outs[out_node], {t: outs[t] for t in taps}

        self._step_cache[key] = step
        return step

    def init_state(self) -> dict:
        """Current network state as a tree (node states, edge states)."""
        if self._compiled is None:
            self.compile()
        order = self._compiled["order"]
        state = {
            "nodes": {n: self.get_node(n).init_state() for n in order},
            "edges": {},
        }
        for n in order:
            for u in self.graph.predecessors(n):
                state["edges"][_ekey(u, n)] = self.get_edge(u, n).init_state()
        return state

    def parameters_pytree(self) -> dict:
        """All node/edge parameters as one tree of dicts."""
        if self._compiled is None:
            self.compile()
        order = self._compiled["order"]
        params = {"nodes": {n: dict(self.get_node(n).args) for n in order}, "edges": {}}
        for n in order:
            for u in self.graph.predecessors(n):
                params["edges"][_ekey(u, n)] = dict(self.get_edge(u, n).params)
        return params

    def trainable_paths(self) -> List[tuple]:
        """Paths ``(kind, label, key)`` of trainable leaves in the params tree."""
        if self._compiled is None:
            self.compile()
        paths = []
        order = self._compiled["order"]
        for n in order:
            for k in getattr(self.get_node(n), "train_keys", []):
                paths.append(("nodes", n, k))
        for n in order:
            for u in self.graph.predecessors(n):
                for k in self.get_edge(u, n).train_keys:
                    paths.append(("edges", _ekey(u, n), k))
        return paths

    @staticmethod
    def _partition(params: dict, paths: List[tuple]) -> Tuple[dict, dict]:
        """Split the params tree into (trainable, frozen) sub-trees."""
        train = {"nodes": {}, "edges": {}}
        frozen = {"nodes": {k: dict(v) for k, v in params["nodes"].items()},
                  "edges": {k: dict(v) for k, v in params["edges"].items()}}
        for kind, label, key in paths:
            train[kind].setdefault(label, {})[key] = frozen[kind][label].pop(key)
        return train, frozen

    @staticmethod
    def _combine(train: dict, frozen: dict) -> dict:
        params = {"nodes": {k: dict(v) for k, v in frozen["nodes"].items()},
                  "edges": {k: dict(v) for k, v in frozen["edges"].items()}}
        for kind in ("nodes", "edges"):
            for label, sub in train[kind].items():
                params[kind].setdefault(label, {}).update(sub)
        return params

    def _prep_params(self, params: dict) -> dict:
        """Once-per-run parameter prep of each node (the quantization of a
        master coupling, the packing of a frozen int4 one, ``nodes.py``
        ``prep_params``), applied before the
        time loop of ``run``, so it costs one pass per run, not per step.
        The training paths never use it (the trajectories prep inside; plain
        autograd needs the per-step STE matvec)."""
        nodes, changed = {}, False
        for n, sub in params["nodes"].items():
            prep = getattr(self.get_node(n), "prep_params", None)
            nodes[n] = prep(sub) if prep is not None else sub
            changed = changed or nodes[n] is not sub
        return {**params, "nodes": nodes} if changed else params

    def _write_back(self, state: dict = None, params: dict = None):
        """Push a state after a run, or trained parameters, back into the
        node and edge wrappers."""
        order = self._compiled["order"]
        if state is not None:
            for n in order:
                node = self.get_node(n)
                ns = state["nodes"].get(n)
                if ns is not None and hasattr(node, "set_state"):
                    node.set_state(ns)
        if params is not None:
            for n, sub in params["nodes"].items():
                node = self.get_node(n)
                for key, val in sub.items():
                    node._args[key] = val.detach() if isinstance(val, torch.Tensor) else val
            for k, sub in params["edges"].items():
                u, v = k.split("->")
                edge = self.get_edge(u, v)
                for key, val in sub.items():
                    edge.params[key] = val.detach()

    # ------------------------------------------------------------ simulation
    def forward(self, x):
        """Single step through the compiled network (updates the stored
        state).  For trajectories use :meth:`run`."""
        step = self.make_step()
        with torch.no_grad():
            state, out, _ = step(self.init_state(), self.parameters_pytree(),
                                 torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                                                 else x).to(self.device, self.dtype))
        self._write_back(state=state)
        return out

    def _resolve_record_vars(self, obs: Observer) -> list:
        """[(record key, node label, reader fn, reduce flag)] for recording."""
        resolved = []
        for (node_label, var), reduce in zip(obs.recorded_state_variables, obs.reduce_flags):
            node = self.get_node(node_label)
            var_r = self._relabel_var(var)
            spec = node._var_map.get(var_r)
            if spec is None:
                raise KeyError(f"Variable {var} was not found on node {node_label}.")
            if isinstance(spec, tuple):
                lo, hi = spec

                def reader(y, a, lo=lo, hi=hi):
                    return y[lo:hi]
            elif isinstance(spec, str):
                vf = node._vf

                def reader(y, a, vf=vf, q=spec):
                    return vf.read_var(q, y, a)
            else:
                def reader(y, a, i=spec):
                    return y[i]
            resolved.append(((node_label, var), node_label, reader, reduce))
        return resolved

    def run(self, inputs, sampling_steps: int = 1, cutoff: int = 0, verbose: bool = True,
            enable_grad: bool = True, **kwargs) -> Observer:
        """Integrate the input-driven network equations.

        Recording semantics are those of the JAX package's ``run``: step 0
        is a record of its own; then come full windows of ``sampling_steps``
        steps, each recording the mean output over its steps with
        ``step >= cutoff`` and ``record_vars`` read from the state after the
        window's last step (``reduce=True`` records the population mean);
        the steps after the last full window are integrated but not
        recorded.  ``inputs`` is a ``(T, m)`` array with ``m`` the input
        width or 1 (broadcast).

        The loop runs without autograd (``enable_grad`` is accepted and
        ignored, as in the JAX package: gradients belong to the trainers).
        """
        del enable_grad
        for key, what, item in (("mesh", "run(mesh=)", "14"),
                                ("record_spikes", "run(record_spikes=)", "11")):
            if kwargs.pop(key, None) is not None:
                raise _todo(what, item)
        if isinstance(inputs, torch.Tensor):
            inputs = inputs.to(device=self.device, dtype=self.dtype)
        elif hasattr(inputs, "build"):
            raise _todo("On-device input specs (rectipy_tpu.inputs)", "11")
        else:
            inputs = torch.as_tensor(np.asarray(inputs)).to(device=self.device, dtype=self.dtype)
        if inputs.ndim != 2:
            raise ValueError(f"`inputs` must be a (T, m) array; got shape {tuple(inputs.shape)}")
        steps = int(inputs.shape[0])
        n_chan = int(inputs.shape[1])
        if int(kwargs.pop("truncate_steps", steps)) < steps:
            raise _todo("run(truncate_steps=)", "9")

        self.compile()
        if self.n_in and n_chan not in (1, self.n_in):
            raise ValueError(
                f"`inputs` has {n_chan} channels but the network input node "
                f"{self._in_node!r} expects {self.n_in} (or 1, broadcast)."
            )
        if "obs" in kwargs:
            obs = kwargs.pop("obs")
        else:
            obs = Observer(dt=self.dt, record_loss=kwargs.pop("record_loss", False), **kwargs)

        s = int(sampling_steps)
        if s < 1:
            raise ValueError(f"sampling_steps must be >= 1; got {sampling_steps}")
        rec_info = self._resolve_record_vars(obs)
        with torch.no_grad():
            state, rec0, recs = self._run_windowed(
                self.init_state(), self._prep_params(self.parameters_pytree()), inputs, s,
                cutoff, rec_info, obs.record_output)
        self._write_back(state)

        rec_steps_all = [t for t in range(steps) if t % s == 0]
        outs, rec_vars = self._assemble_windowed_records(
            rec0, recs, rec_info, obs.record_output, rec_steps_all, cutoff)
        rec_steps = np.asarray([t for t in rec_steps_all if t >= cutoff], dtype=np.int64)
        obs.record_batch(rec_steps, outputs=outs,
                         losses=np.zeros(len(rec_steps)) if obs.record_loss else None,
                         var_values=rec_vars)
        if verbose:
            print(f"Progress: {steps}/{steps} integration steps finished.")
        return obs

    def _run_windowed(self, state, params, inputs, s, cutoff, rec_info, record_output):
        """The run loop.  Returns the final state, the step-0 record and the
        window records, all as host numpy arrays (one transfer, at the end)."""
        step = self.make_step()
        xs = inputs.unbind(0)
        steps = len(xs)
        n_win = (steps - 1) // s  # full windows after step 0

        def read_vars(state):
            vals = {}
            for (key, label, reader, reduce) in rec_info:
                val = reader(state["nodes"][label], params["nodes"][label])
                vals["var::" + "::".join(key)] = val.mean() if reduce else val
            return vals

        # step 0: its own record window
        state, out, _ = step(state, params, xs[0])
        out0 = (out if 0 >= cutoff else torch.zeros_like(out)) if record_output else None
        vars0 = read_vars(state)

        win_outs, win_vars = [], []
        t = 1
        for _ in range(n_win):
            acc, cnt = None, 0
            for _ in range(s):
                state, out, _ = step(state, params, xs[t])
                if record_output and t >= cutoff:
                    acc = out if acc is None else acc + out
                    cnt += 1
                t += 1
            if record_output:
                win_outs.append(torch.zeros_like(out) if acc is None else acc / cnt)
            win_vars.append(read_vars(state))
        while t < steps:  # tail: integrated, not recorded
            state, _, _ = step(state, params, xs[t])
            t += 1

        def host(x):
            return x.detach().cpu().numpy()

        rec0 = (host(out0) if record_output else None, {k: host(v) for k, v in vars0.items()})
        recs = None
        if n_win:
            recs = (host(torch.stack(win_outs)) if record_output else None,
                    {k: host(torch.stack([w[k] for w in win_vars])) for k in vars0})
        return state, rec0, recs

    @staticmethod
    def _assemble_windowed_records(rec0, recs, rec_info, record_output, rec_steps_all,
                                   cutoff):
        """Host-side record assembly: step 0 + window ends, filtered by
        cutoff (the JAX package's ``_assemble_windowed_records``)."""
        keep = np.asarray([t >= cutoff for t in rec_steps_all])
        if record_output:
            parts = [np.expand_dims(np.asarray(rec0[0]), 0)]
            if recs is not None:
                parts.append(np.asarray(recs[0]))
            outs = np.compress(keep, np.concatenate(parts, axis=0), axis=0)
        else:
            outs = None
        rec_vars = {}
        for (key, _, _, _) in rec_info:
            k = "var::" + "::".join(key)
            parts = [np.expand_dims(np.asarray(rec0[1][k]), 0)]
            if recs is not None:
                parts.append(np.asarray(recs[1][k]))
            rec_vars[key] = np.compress(keep, np.concatenate(parts, axis=0), axis=0)
        return outs, rec_vars

    def reset(self, state: dict = None):
        """Reset node states to zeros, or to the given per-node vectors."""
        for node in self.nodes:
            n = self.get_node(node)
            if hasattr(n, "y"):
                if state and node in state:
                    n.reset(y=state[node])
                else:
                    n.reset()

    def _relabel_var(self, var: str) -> str:
        return self._var_map.get(var, var)

    # -------------------------------------------------------------- training
    def fit_bptt(self, inputs, targets, optimizer: str = "sgd", optimizer_kwargs: dict = None,
                 loss: str = "mse", loss_kwargs: dict = None, lr: float = 1e-3,
                 sampling_steps: int = 1, update_steps: int = 100, verbose: bool = True,
                 **kwargs) -> Observer:
        """Backpropagation through time, epoch mode: ``inputs`` and
        ``targets`` are lists (or 3-D arrays ``(epochs, T, m)``); each epoch
        runs the trajectory from the pre-training state, takes the loss over
        its (downsampled) outputs and makes one optimizer update.

        ``fused_bptt`` (default ``'auto'``): chain networks ``[instants] ->
        population -> [instants]`` train through the deferred-gradient
        trajectory of ``ops/bptt.py`` (the stateless pre/post stages run
        outside the time loop, as one batched product each); anything else
        takes plain autograd through ``make_step``.  ``True`` raises where the
        chain trajectory does not apply; ``False`` always takes plain
        autograd.  (The JAX package's multi-population graph trajectory is
        not ported; plain autograd gives the same gradients.)

        ``RECTIPY_FUSED_ADAM`` picks the optimizer tail of a plain-adam fit
        of one trained dense ``int8_master`` coupling on a chain: ``off``
        (default: the split optax-formula optimizer) or ``on`` (one pass of
        adam + requantization through ``ops.fused_opt.adam_requant``, the
        CUDA kernel on the card).  Any other value raises ``ValueError``.

        Not ported yet: step mode (2-D inputs, ROADMAP Queue 1 item 9),
        ``remat_steps`` (item 7) and ``mesh=`` (item 14).
        """
        self.compile()
        loss_fn = get_loss_function(loss, loss_kwargs=loss_kwargs)
        opt = get_optimizer(optimizer, lr, optimizer_kwargs=optimizer_kwargs)
        retrieve_from_dict(["closure", "retain_graph"], kwargs)  # torch.optim-only knobs
        obs_kwargs = retrieve_from_dict(["record_output", "record_loss", "record_vars"], kwargs)
        if kwargs.pop("mesh", None) is not None:
            raise _todo("fit_bptt(mesh=)", "14")
        if int(kwargs.pop("remat_steps", 0)) > 1:
            raise _todo("fit_bptt(remat_steps=)", "7")
        fused_bptt = kwargs.pop("fused_bptt", "auto")
        if kwargs:
            raise TypeError(f"fit_bptt() got unexpected keyword arguments {sorted(kwargs)}")
        epoch_mode = isinstance(inputs, list) or getattr(inputs, "ndim", 0) == 3
        if not epoch_mode:
            raise _todo("fit_bptt step mode (2-D inputs)", "9")
        if len(inputs) != len(targets):
            raise ValueError(
                "Wrong dimensions of input and target output. Please make sure that "
                "`inputs` and `targets` agree in the first dimension (epochs)."
            )
        mode = fused_adam_mode()
        obs = Observer(dt=self.dt, **obs_kwargs)
        paths = self.trainable_paths()
        if not paths:
            raise ValueError("No trainable parameters in the network; pass `train_params` "
                             "to add_diffeq_node or train='gd' to add_edge.")
        train, frozen = self._partition(self.parameters_pytree(), paths)
        train = tree_map(lambda t: t.detach(), train)
        opt_state = opt.init(train)
        state0 = self.init_state()

        # plain adam (only b1/b2/eps overrides, a scalar lr) may take the fused
        # adam + requantize tail (decided per network in _build_fused_adam)
        fused_cfg = None
        okw = dict(optimizer_kwargs or {})
        if (optimizer == "adam" and not callable(lr) and mode != "off"
                and set(okw) <= {"b1", "b2", "eps"}
                and all(isinstance(v, (int, float)) for v in okw.values())):
            fused_cfg = {k: float(okw.get(k, d))
                         for k, d in (("b1", 0.9), ("b2", 0.999), ("eps", 1e-8))}

        t0 = perf_counter()
        *programs, self.last_fit = self._build_epoch_programs(
            loss_fn, opt, fused_bptt, sampling_steps, fused_cfg, paths)

        def epochs(tr, os_, ins, tgts):
            return self._bptt_epochs(programs, tr, frozen, os_, state0, ins, tgts, verbose)

        # the returned Observer records the LAST epoch's run (the weights
        # after K-1 updates, from the initial state), as in the reference;
        # that extra forward runs only when recording is asked for
        if obs_kwargs.get("record_vars") or obs_kwargs.get("record_output", False):
            losses = []
            if len(inputs) > 1:
                train, opt_state, losses = epochs(train, opt_state, list(inputs[:-1]),
                                                  list(targets[:-1]))
            self._write_back(params=self._combine(train, frozen))
            run_kw = {k: v for k, v in obs_kwargs.items() if k in ("record_output", "record_vars")}
            obs = self.run(inputs[-1], sampling_steps=sampling_steps, verbose=False, **run_kw)
            self._write_back(state=state0)  # the reference resets per epoch
            train, opt_state, last = epochs(train, opt_state, [inputs[-1]], [targets[-1]])
            losses = list(losses) + list(last)
        else:
            train, opt_state, losses = epochs(train, opt_state, list(inputs), list(targets))
        obs.save("epoch_loss", losses)
        obs.save("epochs", np.arange(len(losses)))
        self._write_back(params=self._combine(train, frozen))
        if verbose:
            print(f"Finished optimization after {perf_counter() - t0} s.")
        return obs

    def fit_bptt_batch(self, *args, **kwargs):
        """Batched-trial BPTT: not ported yet."""
        raise _todo("fit_bptt_batch", "11")

    def _chain_decompose(self):
        """Decompose a chain network ``[instants...] -> population ->
        [instants...]`` (stateless ``Linear`` edges) into ``(label,
        apply_prefix, apply_suffix)``; ``None`` when the topology does not
        qualify.  The stateless pre/post stages move outside the time loop:
        each becomes one batched product over the ``(T, n)`` series."""
        order = self._compiled["order"]
        if len(order) == 1:
            return order[0], None, None
        diffeq = [n for n in order if self[n].get("node_type") == "diff_eq"]
        if len(diffeq) != 1:
            return None
        label = diffeq[0]
        for i, nname in enumerate(order):
            preds = sorted(self.graph.predecessors(nname))
            if preds != ([] if i == 0 else [order[i - 1]]):
                return None  # not a simple chain
            if nname != label and not isinstance(self.get_node(nname), InstantNode):
                return None
        pre_ops, post_ops = [], []
        side_ops = pre_ops
        for i, nname in enumerate(order):
            if nname == label:
                side_ops = post_ops
            else:
                side_ops.append(("node", None, self.get_node(nname).make_step()))
            if i + 1 < len(order):
                edge = self.get_edge(nname, order[i + 1])
                if edge.init_state() is not None:
                    return None  # stateful edge: no chain trajectory
                side_ops.append(("edge", _ekey(nname, order[i + 1]), edge.make_step()))

        def apply(ops, params, H):
            for kind, key, fn in ops:
                p = params["edges"][key] if kind == "edge" else {}
                H = torch.func.vmap(lambda h, p=p, fn=fn: fn(None, p, h)[1])(H)
            return H

        return (label, lambda params, xs: apply(pre_ops, params, xs),
                lambda params, outs: apply(post_ops, params, outs))

    def _build_epoch_programs(self, loss_fn, opt, fused_bptt, sampling_steps, fused_cfg,
                              paths):
        """``(update, init_opt, pack, info)``: the per-epoch update
        ``update(train, frozen, opt_state, y0, inp, tgt) -> (train',
        opt_state', loss)``, the optimizer-state initializer of the fused
        adam path (else ``None``), the initial-state packer, and which paths
        the fit takes (``{"trajectory": "chain"|"autograd", "fused_adam":
        bool}``)."""
        combine = self._combine
        step = self.make_step()
        traj = chain = None
        if fused_bptt in ("auto", True):
            chain = self._chain_decompose()
            if chain is not None:
                from .ops.bptt import make_coupled_traj

                try:
                    traj, traj_wkeys = make_coupled_traj(self.get_node(chain[0]))
                except (ValueError, AttributeError, KeyError):
                    if fused_bptt is True:
                        raise
            elif fused_bptt is True:
                raise ValueError("fused_bptt=True needs a chain network [instants] -> "
                                 "population -> [instants]; the graph trajectory is not "
                                 "ported yet (ROADMAP Queue 1 item 10).")

        def downsample(outs):
            if sampling_steps > 1:
                n_keep = outs.shape[0] // sampling_steps
                outs = outs[: n_keep * sampling_steps]
                outs = outs.reshape(n_keep, sampling_steps, -1).mean(dim=1)
            return outs

        if traj is not None:
            label, apply_prefix, apply_suffix = chain

            def pack(state0):
                return state0["nodes"][label]

            def epoch_loss(train, frozen, y0, inp, tgt, traj_fn=None, wp=None):
                params = combine(train, frozen)
                nargs = params["nodes"][label]
                W = {k: nargs[k] for k in traj_wkeys}
                rest = {k: v for k, v in nargs.items() if k not in traj_wkeys}
                xs = apply_prefix(params, inp) if apply_prefix is not None else inp
                if traj_fn is None:
                    _, outs = traj(W, rest, y0, xs)
                else:
                    _, outs = traj_fn((wp,), W, rest, y0, xs)
                if apply_suffix is not None:
                    outs = apply_suffix(params, outs)
                return loss_fn(downsample(outs), tgt)

            fused = self._build_fused_adam(label, traj_wkeys, epoch_loss, fused_cfg, paths)
            if fused is not None:
                return fused + (pack, {"trajectory": "chain", "fused_adam": True})
        else:
            def pack(state0):
                return state0

            def epoch_loss(train, frozen, state0, inp, tgt):
                params = combine(train, frozen)
                state, outs = state0, []
                for x in inp.unbind(0):
                    state, out, _ = step(state, params, x)
                    outs.append(out)
                return loss_fn(downsample(torch.stack(outs)), tgt)

        def update(train, frozen, opt_state, y0, inp, tgt):
            lval, grads = _value_and_grad(epoch_loss, train, frozen, y0, inp, tgt)
            train, opt_state = opt.update(grads, opt_state, train)
            return tree_map(lambda t: t.detach(), train), opt_state, lval

        return update, None, pack, {"trajectory": "chain" if traj is not None else "autograd",
                                    "fused_adam": False}

    def _build_fused_adam(self, label, traj_wkeys, epoch_loss, fused_cfg, paths):
        """The fused adam + requantize update, or ``None`` when the fit does
        not qualify: plain adam (``fused_cfg`` given), one dense
        ``int8_master`` coupling on the chain, and that coupling trained.
        The ``(wq, scale)`` pair rides in the optimizer state into the next
        epoch's trajectory."""
        if fused_cfg is None or len(traj_wkeys) != 1:
            return None
        wkey = traj_wkeys[0]
        node = self.get_node(label)
        if ("nodes", label, wkey) not in paths or node._vf.coupling_cast != "int8" \
                or node._args[wkey].dim() != 2:
            return None
        from .ops.bptt import make_coupled_traj_prepped
        from .ops.fused_opt import adam_leaf, adam_requant, bias_corrections

        traj_p, _, preps = make_coupled_traj_prepped(node)
        b1, b2, eps = fused_cfg["b1"], fused_cfg["b2"], fused_cfg["eps"]

        def update(train, frozen, osf, y0, inp, tgt):
            lval, grads = _value_and_grad(
                lambda tr, fr, y, i, t: epoch_loss(tr, fr, y, i, t, traj_fn=traj_p,
                                                   wp=osf["wp"]),
                train, frozen, y0, inp, tgt)
            count = osf["count"] + 1
            bc1, bc2 = bias_corrections(count, b1, b2)
            lr = osf["lr"]
            mu, nu, new = {}, {}, {}
            paths_, leaves = _flatten(train)
            g_leaves, m_leaves, v_leaves = (_flatten(t)[1] for t in (grads, osf["mu"], osf["nu"]))
            wp = osf["wp"]
            for path, w, g, m, v in zip(paths_, leaves, g_leaves, m_leaves, v_leaves):
                if path == ("nodes", label, wkey):
                    w2, m2, v2, wq, scale = adam_requant(w, m, v, g, bc1, bc2, lr, b1=b1, b2=b2,
                                                         eps=eps)
                    wp = (wq, scale)
                else:
                    w2, m2, v2 = adam_leaf(w, m, v, g, bc1, bc2, lr, b1, b2, eps)
                new[path], mu[path], nu[path] = w2, m2, v2
            osf = {"count": count, "lr": lr, "wp": wp,
                   "mu": _unflatten(paths_, [mu[p] for p in paths_]),
                   "nu": _unflatten(paths_, [nu[p] for p in paths_])}
            return _unflatten(paths_, [new[p] for p in paths_]), osf, lval

        def init_opt(train, opt_state):
            # lr from the optimizer's injected hyperparameters; fresh moments;
            # the first quantization of the current master
            return {"count": 0, "lr": float(opt_state["hyperparams"]["learning_rate"]),
                    "mu": tree_map(torch.zeros_like, train),
                    "nu": tree_map(torch.zeros_like, train),
                    "wp": preps[0](train["nodes"][label][wkey])}

        return update, init_opt

    def _bptt_epochs(self, programs, train, frozen, opt_state, state0, inputs, targets,
                     verbose):
        update, init_opt, pack = programs
        if init_opt is not None and "hyperparams" in opt_state:
            # the fused carry replaces the optimizer state; an opt_state
            # without hyperparams is already a fused carry from an earlier
            # call of the same fit (the recording path splits one fit)
            opt_state = init_opt(train, opt_state)
        y0 = pack(state0)
        # stage each distinct input/target array on the device once; the
        # cache holds the source object too, so an id() is never reused
        staged: Dict[int, tuple] = {}

        def stage(x):
            hit = staged.get(id(x))
            if hit is None:
                if isinstance(x, torch.Tensor):
                    arr = x.to(device=self.device, dtype=self.dtype)
                else:
                    arr = torch.as_tensor(np.asarray(x)).to(device=self.device, dtype=self.dtype)
                hit = staged[id(x)] = (x, arr)
            return hit[1]

        losses = []
        for epoch in range(len(inputs)):
            inp, tgt = stage(inputs[epoch]), stage(targets[epoch])
            train, opt_state, lval = update(train, frozen, opt_state, y0, inp, tgt)
            losses.append(lval.detach())  # stays on the device until the end
            if verbose:
                print(f"Progress: {epoch + 1}/{len(inputs)} training epochs finished.")
                print(f"Epoch loss: {float(lval)}.")
                print("")
        if losses:
            losses = [float(x) for x in torch.stack(losses).cpu().tolist()]
        return train, opt_state, losses


def _value_and_grad(loss_fn, train, frozen, y0, inp, tgt):
    """``(loss, grads)`` of ``loss_fn(train, ...)`` with respect to every leaf
    of ``train``; a leaf the loss does not reach gets a zero gradient."""
    paths, leaves = _flatten(train)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        lval = loss_fn(_unflatten(paths, leaves), frozen, y0, inp, tgt)
        grads = torch.autograd.grad(lval, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return lval.detach(), _unflatten(paths, grads)
