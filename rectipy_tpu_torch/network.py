"""Network: graph container, step composition, simulation and training.

Counterpart of ``rectipy_tpu/network.py`` (``Network`` and
``FeedbackNetwork``).  ``compile()`` resolves the graph once into an
evaluation order; ``make_step()`` composes the node and edge steps into one
network step ``step(state, params, x) -> (state', out, taps)`` (feedback
edges read the previous step's source outputs from ``state["fb"]``);
``run`` drives it in a Python loop over time steps with the JAX package's
windowed recording semantics.  The trainers:

- ``fit_bptt``: epoch mode (one update per epoch) and step mode (truncated
  BPTT, one update per ``update_steps`` chunk), through the deferred-gradient
  trajectory of ``ops/bptt.py`` on chain networks and through plain autograd
  otherwise;
- ``fit_ridge``: a closed-form ridge readout (Gram matrix and solve);
- ``fit_rls``: online FORCE learning of an ``RLS`` edge;
- ``test``: a frozen run scored by a loss.

Batched trials: ``run_batch`` integrates ``B`` independent trials together
(``(B, T, m)`` inputs, or a shared ``(T, m)`` drive with per-trial
parameters, ``batch_vars``), and ``fit_bptt_batch`` trains on them in
minibatches.  Every node and edge step takes states with a leading trial
axis, so a step of ``B`` trials is one step whose products take ``(B, n)``
rows.

On the device: the inputs move to the device once, the records and losses
stay on the device, and nothing inside the loops synchronises with the host;
they cross to the host once, at the end.

Not ported yet (ROADMAP Queue 1 items 7 and 10-14): ``remat_steps`` and
``mesh=``, ``fit_bptt_multistart`` and ``fit_es``, ``fit_stdp`` and
``fit_eprop``, the STDP edges, the graph trajectory, heterogeneous
circuits, on-device input specs and spike rasters.
"""

from __future__ import annotations

import os
from time import perf_counter
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import networkx as nx
import numpy as np
import torch
from networkx import DiGraph

from .edges import (RLS, BlockSparseLinear, Linear, LinearFilter, LinearMasked, LinearMemory,
                    LinearMemoryFilter, LinearMemoryMatrix, LinearSTP)
from .nodes import InstantNode, RateNet, SpikeNet, SpikeResetNet, resolve_device, resolve_dtype
from .observer import Observer
from .train import get_loss_function, get_optimizer
from .train.optimizers import tree_map
from .utility import add_op_name, retrieve_from_dict

__all__ = ["FeedbackNetwork", "Network"]


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


def _detach(tree):
    """A state tree cut out of the autograd graph (the truncation of BPTT)."""
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, tuple):  # an STP edge's (u, x)
        return tuple(_detach(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _read_vars(rec_info: list, state: dict, params: dict) -> list:
    """The ``record_vars`` values of ``state`` (``_resolve_record_vars``'s
    entries; ``reduce`` takes the population mean)."""
    vals = []
    for (_, label, reader, reduce) in rec_info:
        val = reader(state["nodes"][label], params["nodes"][label])
        vals.append(val.mean() if reduce else val)
    return vals


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


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
        self._fb_store: Dict[str, torch.Tensor] = {}  # previous-step feedback outputs
        self._train_edge: Optional[Tuple[str, str]] = None  # the RLS edge (source, target)
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
    @classmethod
    def from_yaml(cls, node, weights=None, dt: float = 1e-3, source_var: str = None,
                  target_var: str = None, input_var: str = None, output_var: str = None,
                  device=None, dtype=torch.float32, label: str = "rnn",
                  train_params: list = None, **kwargs) -> "Network":
        """Legacy one-call constructor (an older RectiPy API): a Network with a
        single diffeq node built from a YAML template.  ``device=None`` is
        the current CUDA device, as for ``Network``."""
        net = cls(dt, device=device, dtype=dtype)
        net.add_diffeq_node(label, node, input_var=input_var, output_var=output_var,
                            weights=weights, source_var=source_var, target_var=target_var,
                            train_params=train_params, **kwargs)
        return net

    def add_input_layer(self, m: int, weights=None, train: Optional[str] = None,
                        **kwargs) -> Linear:
        """Legacy helper: add an identity input node of width ``m`` wired to
        the network's current input node."""
        self.compile()
        target = self._in_node
        self.add_func_node("input_layer", m, activation_function="identity")
        return self.add_edge("input_layer", target, weights=weights, train=train, **kwargs)

    def add_output_layer(self, k: int, weights=None, train: Optional[str] = None,
                         activation_function: str = "identity", **kwargs) -> Linear:
        """Legacy helper: add an activation output node of width ``k`` wired
        from the network's current output node."""
        self.compile()
        source = self._out_node
        self.add_func_node("output_layer", k, activation_function=activation_function)
        return self.add_edge(source, "output_layer", weights=weights, train=train, **kwargs)

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
        and, unless ``dtype=`` (or ``float_precision=``) is given, takes the
        network's dtype.
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
        if "dtype" not in kwargs and "float_precision" in kwargs:
            kwargs["dtype"] = kwargs.pop("float_precision")
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
        """Add an edge on the network's device, in the network's dtype.  The
        class follows the keyword arguments, as in the JAX package:
        ``mask`` -> ``LinearMasked``; ``delays`` -> ``LinearMemory`` (1-D,
        per source; with ``filter_weights`` ``LinearMemoryFilter``) or
        ``LinearMemoryMatrix`` (2-D, per connection; ``mode``,
        ``train_delays``, ``max_delay``, ``read_dtype``, ``fine_s``,
        ``interp_impl``); ``filter_weights`` -> ``LinearFilter``;
        ``tau_facil``/``tau_depress`` (and ``U``) -> ``LinearSTP`` with the
        network's ``dt``; a ``BlockSparseCoupling`` as ``weights`` ->
        ``BlockSparseLinear`` (per-block ``delays``, ``block_dtype``); else
        ``Linear``.  Short-term plasticity combined with a mask, delays or a
        filter, a 2-D delay matrix with a filter, and block-sparse weights
        with a mask or a filter, raise ``ValueError``.  ``train``:

        - ``None`` or ``'gd'``: the edge frozen or trained by ``fit_bptt``;
        - ``'rls'``: an ``RLS`` readout (``beta``, ``alpha``) that
          ``fit_rls`` trains online; its dtype is ``rls_dtype``, by default
          float64 (the JAX package takes float64 only with x64 on).

        The rules ``'eprop'`` and ``'stdp'`` raise ``NotImplementedError``."""
        edge_attrs = dict(edge_attrs or {})
        kwargs.pop("dtype", None)
        kwargs.pop("device", None)
        stp_req = {"tau_facil", "tau_depress"} & set(kwargs)
        if stp_req and ({"mask", "delays", "filter_weights"} & set(kwargs)):
            raise ValueError(
                "Short-term plasticity (tau_facil/tau_depress) cannot be combined "
                "with mask/delays/filter_weights on a single edge; chain two edges "
                "through an identity func-node instead.")
        if hasattr(weights, "blocks"):
            # a BlockSparseCoupling: the block-sparse edge, optionally with
            # per-block conduction delays
            if {"mask", "filter_weights"} & set(kwargs):
                raise ValueError(
                    "Block-sparse edges support only optional per-block "
                    "delays; chain a separate edge for masks/filters.")
            EdgeClass = BlockSparseLinear
        elif "mask" in kwargs:
            EdgeClass = LinearMasked
        elif "delays" in kwargs and np.ndim(kwargs["delays"]) == 2:
            if "filter_weights" in kwargs:
                raise ValueError(
                    "A 2-D delay matrix cannot be combined with filter_weights; "
                    "chain a LinearFilter edge through an identity func-node instead.")
            EdgeClass = LinearMemoryMatrix
        elif "delays" in kwargs:
            EdgeClass = LinearMemoryFilter if "filter_weights" in kwargs else LinearMemory
        elif "filter_weights" in kwargs:
            EdgeClass = LinearFilter
        elif stp_req:
            EdgeClass = LinearSTP
            kwargs["dt"] = self.dt
        else:
            EdgeClass = Linear
        if train not in (None, "gd", "rls"):
            if train in ("eprop", "stdp"):
                raise _todo(f"train={train!r}", "12")
            raise ValueError(
                "Invalid option for keyword argument `train`. Please see the docstring of "
                "`Network.add_edge` for valid options."
            )
        n_in, n_out = self[source]["n_out"], self[target]["n_in"]
        if train == "rls":
            edge = RLS(n_in, n_out, weights=weights,
                       dtype=resolve_dtype(kwargs.get("rls_dtype", torch.float64)),
                       beta=kwargs.get("beta", 1.0), alpha=kwargs.get("alpha", 1.0),
                       device=self.device)
            self._train_edge = (source, target)
        else:
            kwargs.update({"n_in": n_in, "n_out": n_out, "weights": weights,
                           "dtype": self.dtype, "device": self.device})
            edge = EdgeClass(**kwargs, detach=train is None)
        self.graph.add_edge(source, target, edge=edge, trainable=train == "gd",
                            n_in=edge.n_in, n_out=edge.n_out, **edge_attrs)
        self._invalidate()
        return edge

    def pop_edge(self, source: str, target: str):
        edge = self.get_edge(source, target)
        self.graph.remove_edge(source, target)
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

    def _fb_edge_list(self) -> list:
        """``[(source, target, edge)]`` of the feedback edges
        (``FeedbackNetwork``); none in a plain ``Network``."""
        return []

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
        fb_edges = self._fb_edge_list()
        fb_steps = {(u, v): e.make_step() for u, v, e in fb_edges}
        fb_by_target: Dict[str, list] = {}
        for u, v, _ in fb_edges:
            fb_by_target.setdefault(v, []).append(u)
        fb_sources = sorted({u for u, _, _ in fb_edges})
        # a feedback edge carries its source's out-slice after the update (the
        # next step's pre-update output, RectiPy's semantics); an instant
        # source passes this step's output
        fb_readers = {u: getattr(self.get_node(u), "_make_out_reader", lambda: None)()
                      for u in fb_sources}

        def step(state, params, x):
            nodes_st = dict(state["nodes"])
            edges_st = dict(state["edges"])
            fb_prev = state.get("fb", {})
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
                for u in fb_by_target.get(n, ()):
                    k = _ekey(u, n)
                    es, val = fb_steps[(u, n)](edges_st[k], params["edges"][k], fb_prev[u])
                    edges_st[k] = es
                    inp = inp + val
                ns, out = node_steps[n](nodes_st[n], params["nodes"][n], inp)
                nodes_st[n] = ns
                outs[n] = out
            new_state = {"nodes": nodes_st, "edges": edges_st}
            if fb_sources or "fb" in state:
                new_state["fb"] = {
                    u: outs[u] if fb_readers[u] is None
                    else fb_readers[u](nodes_st[u], params["nodes"][u]) for u in fb_sources}
            return new_state, outs[out_node], {t: outs[t] for t in taps}

        self._step_cache[key] = step
        return step

    def init_state(self) -> dict:
        """Current network state as a tree (node states, edge states and,
        with feedback edges, the previous-step feedback outputs)."""
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
        fb_edges = self._fb_edge_list()
        if fb_edges:
            fb = {}
            for u, v, e in fb_edges:
                state["edges"][_ekey(u, v)] = e.init_state()
                src = self.get_node(u)
                if u in self._fb_store:
                    fb[u] = self._fb_store[u]
                elif hasattr(src, "_make_out_reader"):
                    # the first step reads the initial state's output, not zeros
                    fb[u] = src._make_out_reader()(src.y, src.args)
                else:
                    fb[u] = torch.zeros(self[u]["n_out"], dtype=self.dtype, device=self.device)
            state["fb"] = fb
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
        for u, v, e in self._fb_edge_list():
            params["edges"][_ekey(u, v)] = dict(e.params)
        return params

    def describe(self) -> str:
        """Human-readable architecture summary: nodes (class, size,
        integrator, trainables), edges (class, weight shape and dtype, extra
        carried tensors), and parameter/state totals with their memory
        footprint; the JAX package's format.  ``print(net.describe())``."""
        self.compile()
        order = self._compiled["order"]
        lines = [f"Network(dt={self.dt}, dtype={_dtype_name(self.dtype)}): "
                 f"{len(order)} node(s), input={self._in_node!r} (n_in={self.n_in}), "
                 f"output={self._out_node!r} (n_out={self.n_out})"]

        def size(leaf):
            return leaf.numel() if isinstance(leaf, torch.Tensor) else int(np.size(leaf))

        def nbytes(leaf):  # a Python scalar counts as a float64
            if isinstance(leaf, torch.Tensor):
                return leaf.numel() * leaf.element_size()
            return size(leaf) * np.dtype(getattr(leaf, "dtype", np.float64)).itemsize

        def stats(tree):
            leaves = [v for v in tree.values() if v is not None]
            return sum(map(size, leaves)), sum(map(nbytes, leaves))

        n_param = n_bytes = 0
        lines.append("nodes:")
        for label in order:
            node = self.get_node(label)
            cnt, byt = stats(node.args)
            n_param += cnt
            n_bytes += byt
            y = getattr(node, "y", None)
            extra = ""
            if getattr(node, "integrator", "euler") != "euler":
                extra += f", integrator={node.integrator}"
            if node.train_keys:
                extra += f", train={list(node.train_keys)}"
            size_s = f"state={y.shape[0]}" if y is not None else f"n={node.n_in}"
            lines.append(f"  {label}: {type(node).__name__} ({size_s}, {cnt:,} params{extra})")
            if y is not None:
                n_bytes += nbytes(y)
        edges = [(u, v, self.get_edge(u, v), "") for v in order for u in self.graph.predecessors(v)]
        edges += [(u, v, e, " [feedback]") for u, v, e in self._fb_edge_list()]
        if edges:
            lines.append("edges:")
        for u, v, e, tag in edges:
            cnt, byt = stats(e.params)
            n_param += cnt
            n_bytes += byt
            w = e.params["weights"]
            shape = "x".join(map(str, w.shape)) if w.dim() else "scalar"
            extras = [k for k in e.params if k != "weights"]
            lines.append(f"  {u} -> {v}{tag}: {type(e).__name__} ({shape} {_dtype_name(w.dtype)}"
                         + (f", carry: {extras}" if extras else "")
                         + (f", train={list(e.train_keys)}" if e.train_keys else "") + ")")
        params = self.parameters_pytree()
        t_cnt = sum(size(params[kind][label][key]) for kind, label, key in self.trainable_paths())
        lines.append(f"totals: {n_param:,} parameters ({t_cnt:,} trainable), "
                     f"~{n_bytes/1e6:,.1f} MB params+state on device")
        return "\n".join(lines)

    def parameters(self, recurse: bool = True) -> Iterator:
        """The trainable parameters of the network's nodes and edges."""
        for n in self.graph:
            yield from self.get_node(n).parameters(recurse=recurse)
        for s, t in self.graph.edges:
            yield from self.graph[s][t]["edge"].parameters()

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
        for u, v, e in self._fb_edge_list():
            for k in e.train_keys:
                paths.append(("edges", _ekey(u, v), k))
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
        ``prep_params``) and each edge (the delay matrix's selectors,
        ``edges.py`` ``LinearMemoryMatrix.prep_params``), applied before the
        time loop of ``run``, so it costs one pass per run, not per step.
        The training paths take the edge prep alone (``_prep_edge_params``):
        the trajectories prep their nodes inside, and plain autograd needs
        the per-step STE matvec."""
        nodes, changed = {}, False
        for n, sub in params["nodes"].items():
            prep = getattr(self.get_node(n), "prep_params", None)
            nodes[n] = prep(sub) if prep is not None else sub
            changed = changed or nodes[n] is not sub
        params = self._prep_edge_params(params)
        return {**params, "nodes": nodes} if changed else params

    def _prep_edge_params(self, params: dict) -> dict:
        """The edges' prep alone, safe inside a differentiated loss: the
        selectors of an ``interp`` delay matrix derive from its trainable
        delays, so the prep must run inside the autograd graph for the
        delays to get their gradient; once per epoch, chunk or minibatch,
        never per step.  A swept ``delays`` (``(B, n_out, n_in)``) is
        prepped per trial."""
        edges, changed = {}, False
        for k, sub in params["edges"].items():
            prep = getattr(self.get_edge(*k.split("->")), "prep_params", None)
            edges[k] = prep(sub) if prep is not None else sub
            changed = changed or edges[k] is not sub
        return {**params, "edges": edges} if changed else params

    def _write_back(self, state: dict = None, params: dict = None):
        """Push a state after a run, or trained parameters, back into the
        node and edge wrappers."""
        order = self._compiled["order"]
        if state is not None:
            if "fb" in state:
                self._fb_store = dict(state["fb"])
            for n in order:
                node = self.get_node(n)
                ns = state["nodes"].get(n)
                if ns is not None and hasattr(node, "set_state"):
                    node.set_state(ns)
            for k, es in state["edges"].items():
                if es is not None:  # the buffers, filter states and (u, x)
                    self.get_edge(*k.split("->")).set_state(_detach(es))
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
                    return y[..., lo:hi]
            elif isinstance(spec, str):
                vf = node._vf

                def reader(y, a, vf=vf, q=spec):
                    return vf.read_var(q, y, a)
            else:
                def reader(y, a, i=spec):
                    return y[..., i]
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
        So ``truncate_steps`` (the JAX package cuts the gradient of its
        generic scan every ``truncate_steps`` steps) has no gradient to cut:
        it is checked and the records are those of the run without it, as
        in the JAX package.
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
        truncate_steps = int(kwargs.pop("truncate_steps", steps))
        if truncate_steps < 1:
            raise ValueError(f"truncate_steps must be >= 1; got {truncate_steps}")

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
                self.init_state(), self._prep_params(self.parameters_pytree()),
                inputs.unbind(0), s, cutoff, rec_info, obs.record_output)
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

    def _run_windowed(self, state, params, xs, s, cutoff, rec_info, record_output,
                      batched: bool = False):
        """The run loop over the per-step inputs ``xs``.  Returns the final
        state, the step-0 record and the window records, all as host numpy
        arrays (one transfer, at the end).  ``batched``: the states carry a
        leading trial axis; a reduced record is each trial's population mean
        and the window records stack along axis 1, ``(B, R, ...)``."""
        step = self.make_step()
        steps = len(xs)
        n_win = (steps - 1) // s  # full windows after step 0
        axis = 1 if batched else 0

        def read_vars(state):
            vals = {}
            for (key, label, reader, reduce) in rec_info:
                val = reader(state["nodes"][label], params["nodes"][label])
                if reduce:
                    val = val.mean(dim=-1) if batched else val.mean()
                vals["var::" + "::".join(key)] = val
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
            recs = (host(torch.stack(win_outs, dim=axis)) if record_output else None,
                    {k: host(torch.stack([w[k] for w in win_vars], dim=axis)) for k in vars0})
        return state, rec0, recs

    @staticmethod
    def _assemble_windowed_records(rec0, recs, rec_info, record_output, rec_steps_all,
                                   cutoff, axis: int = 0):
        """Host-side record assembly: step 0 + window ends, filtered by
        cutoff, along record axis ``axis`` (0 single-trial, 1 batched; the
        JAX package's ``_assemble_windowed_records``)."""
        keep = np.asarray([t >= cutoff for t in rec_steps_all])
        if record_output:
            parts = [np.expand_dims(np.asarray(rec0[0]), axis)]
            if recs is not None:
                parts.append(np.asarray(recs[0]))
            outs = np.compress(keep, np.concatenate(parts, axis=axis), axis=axis)
        else:
            outs = None
        rec_vars = {}
        for (key, _, _, _) in rec_info:
            k = "var::" + "::".join(key)
            parts = [np.expand_dims(np.asarray(rec0[1][k]), axis)]
            if recs is not None:
                parts.append(np.asarray(recs[1][k]))
            rec_vars[key] = np.compress(keep, np.concatenate(parts, axis=axis), axis=axis)
        return outs, rec_vars

    # ------------------------------------------------------- batched trials
    _CLASS_LOSSES = ("nll", "ce")  # integer class labels: (B, R) targets

    def _sweep_path(self, name: str, k) -> tuple:
        """Resolve a ``batch_vars`` key to a params-tree path ``("nodes"|
        "edges", label_or_ekey, param)``: ``(node, var)``, an exact path
        3-tuple, or ``("edge", source, target, param)`` for an edge
        parameter (the JAX package's ``_sweep_path``)."""
        k = tuple(k)
        if len(k) == 4 and k[0] == "edge":
            _, src, tgt, param = k
            edge = self.get_edge(src, tgt)  # raises with names if absent
            if param not in edge.params:
                raise KeyError(f"{name}: {param!r} is not a parameter of edge {src!r} -> "
                               f"{tgt!r} (available: {sorted(edge.params)}).")
            return ("edges", _ekey(src, tgt), param)
        if len(k) == 3 and k[0] in ("nodes", "edges"):
            sec, label, key = k
            try:
                owner = (getattr(self.get_node(label), "_args", {}) if sec == "nodes"
                         else self.get_edge(*label.split("->")).params)
            except KeyError:
                raise KeyError(f"{name}: path {k} not found (no such {sec[:-1]} {label!r}).")
            if key not in owner:
                raise KeyError(f"{name}: {key!r} is not a parameter of {sec[:-1]} {label!r} "
                               f"(path {k} not found).")
            return k
        nlabel, var = k
        node = self.get_node(nlabel)
        try:
            return ("nodes", nlabel, node._param_map[self._relabel_var(var)])
        except (AttributeError, KeyError):
            raise KeyError(f"{name}: {var!r} is not a parameter of node {nlabel!r}.")

    def _sweep_values(self, vals, leaf) -> torch.Tensor:
        """Per-trial values on the device in the leaf's dtype; ``(B,)`` (one
        scalar per trial) becomes ``(B, 1)``, so that it broadcasts over the
        neurons of ``(B, n)`` states."""
        dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else self.dtype
        vals = (vals.to(device=self.device, dtype=dtype) if isinstance(vals, torch.Tensor)
                else torch.as_tensor(np.asarray(vals)).to(device=self.device, dtype=dtype))
        return vals.reshape(-1, 1) if vals.dim() == 1 else vals

    def _with_sweeps(self, params: dict, sweeps: dict) -> dict:
        """``params`` with the per-trial leaves of ``sweeps`` (path -> all
        trials' values) spliced in.  A node with a fused kernel then passes
        its args through the kernel's ``_fused_sweep``, which routes what the
        kernel takes per trial into its copies and refuses the rest."""
        if not sweeps:
            return params
        params = {kind: {lbl: dict(sub) for lbl, sub in params[kind].items()}
                  for kind in ("nodes", "edges")}
        for (sec, label, key), val in sweeps.items():
            params[sec][label][key] = val
        for label in {label for sec, label, _ in sweeps if sec == "nodes"}:
            sweep = getattr(self.get_node(label), "_fused_sweep", None)
            if sweep is not None:
                params["nodes"][label] = sweep(params["nodes"][label])
        return params

    def _refuse_generic_fused(self):
        """``fit_bptt_batch`` refuses a node with the generic fused step: its
        kernel has no backward, as the JAX package's Pallas kernel has none
        (JAX raises in the kernel's JVP rule when a gradient must pass
        through it, and gives the node's own coupling, which the kernel reads
        from its copy, a zero gradient)."""
        for n in self._compiled["order"]:
            cfg = getattr(self.get_node(n), "_fused_cfg", None)
            if cfg is not None and "step" in cfg:
                raise NotImplementedError(
                    f"Node {n!r} has the generic fused step attached, whose kernel has no "
                    f"backward (nor has the JAX package's Pallas kernel): no gradient passes "
                    f"through it. Rebuild the node without it for fit_bptt_batch.")

    def _batch_state(self, state: dict, B: int) -> dict:
        """The state tree with every node state, edge state (an STP edge's
        ``(u, x)`` each) and carried feedback output repeated over ``B``
        trials, ``(B, ...)``."""
        def rows(t):
            if isinstance(t, tuple):
                return tuple(rows(v) for v in t)
            return None if t is None else t.expand((B,) + tuple(t.shape)).contiguous()

        out = {"nodes": {k: rows(v) for k, v in state["nodes"].items()},
               "edges": {k: rows(v) for k, v in state["edges"].items()}}
        if "fb" in state:
            out["fb"] = {k: rows(v) for k, v in state["fb"].items()}
        return out

    def run_batch(self, inputs, sampling_steps: int = 1, cutoff: int = 0,
                  verbose: bool = False, **kwargs) -> dict:
        """Integrate a batch of independent trials, every trial from the
        network's current state; the network's state (and a
        ``FeedbackNetwork``'s carried outputs) is left unchanged.

        ``inputs``: ``(B, T, m)``, or a shared ``(T, m)`` drive with
        ``batch_vars`` (staged once; no ``(B, T, m)`` copy).  Returns
        ``{"steps": (R,), "out": (B, R, n_out), (node, var): (B, R, ...)}``
        with the recording semantics of :meth:`run`.

        ``batch_vars``: ``{key: values}`` sweeps parameters across the
        trials; ``values`` is ``(B,)`` (one scalar per trial) or ``(B, n)``
        (per neuron), or ``(B, n, n)`` for a coupling.  Keys are ``(node,
        var)``, an exact path ``("nodes"|"edges", label, key)`` or
        ``("edge", source, target, param)``.  A master coupling swept per
        trial is quantized (or rounded) per trial once per run.

        All trials advance together: every step is one batched step, whose
        products take ``(B, n)`` rows (one ``int8_mm`` launch per step for an
        ``int8``/``int8_master`` coupling, one ``int4_mm`` for an ``int4``/
        ``int4_master`` one, one B-row ``qif_sfa_step`` for a node with the
        fused QIF step, one B-row ``generic_fused_rows`` for a node with the
        generic fused step, two for a Heun one).  A coupling swept per trial
        has its own W per trial, so nothing can be shared: an integer one
        (``int8``, ``int8_master``, ``int4``, ``int4_master``) launches its
        matvec (``int8_mv``, ``int4_mv``) once per trial per step.

        Not ported yet: on-device input specs and ``record_spikes`` (ROADMAP
        Queue 1 item 11) and ``mesh=`` (item 14).  A fused node refuses a
        sweep of a parameter its kernel bakes in or shares (the JAX
        package's fused QIF kernel ignores a swept eta, which the port
        applies).
        """
        for key, what, item in (("mesh", "run_batch(mesh=)", "14"),
                                ("record_spikes", "run_batch(record_spikes=)", "11")):
            if kwargs.pop(key, None) is not None:
                raise _todo(what, item)
        batch_vars = kwargs.pop("batch_vars", None)
        if hasattr(inputs, "build"):
            raise _todo("On-device input specs (rectipy_tpu.inputs)", "11")
        inputs = self._to_device(inputs)
        if inputs.ndim == 2 and batch_vars:
            B, T = int(np.shape(next(iter(batch_vars.values())))[0]), int(inputs.shape[0])
        elif inputs.ndim != 3:
            raise ValueError(f"run_batch expects (B, T, m) inputs -- or shared (T, m) inputs "
                             f"with batch_vars -- got {tuple(inputs.shape)}")
        else:
            B, T = int(inputs.shape[0]), int(inputs.shape[1])
        self.compile()
        n_chan = int(inputs.shape[-1])
        if self.n_in and n_chan not in (1, self.n_in):
            raise ValueError(f"`inputs` has {n_chan} channels but the network input node "
                             f"{self._in_node!r} expects {self.n_in} (or 1, broadcast).")
        s = int(sampling_steps)
        if s < 1:
            raise ValueError(f"sampling_steps must be >= 1; got {sampling_steps}")
        obs = Observer(dt=self.dt, record_loss=kwargs.pop("record_loss", False), **kwargs)
        rec_info = self._resolve_record_vars(obs)
        state0 = self.init_state()
        params = self.parameters_pytree()
        sweeps = self._resolve_batch_vars("run_batch", batch_vars, B, params, trainer=False)
        rec_steps_all = [t for t in range(T) if t % s == 0]
        results = {"steps": np.asarray([t for t in rec_steps_all if t >= cutoff],
                                       dtype=np.int64)}
        with torch.no_grad():
            pb = self._prep_params(self._with_sweeps(params, sweeps))
            xs = ([x.expand(B, n_chan) for x in inputs.unbind(0)] if inputs.ndim == 2
                  else inputs.unbind(1))
            _, rec0, recs = self._run_windowed(self._batch_state(state0, B), pb, xs, s, cutoff,
                                               rec_info, obs.record_output, batched=True)
        outs, rec_vars = self._assemble_windowed_records(
            rec0, recs, rec_info, obs.record_output, rec_steps_all, cutoff, axis=1)
        if outs is not None:
            results["out"] = outs
        results.update(rec_vars)
        if verbose:
            print(f"Progress: {B} trials x {T} steps finished.")
        return results

    def reset(self, state: dict = None):
        """Reset node states to zeros, or to the given per-node vectors, and
        drop the carried feedback outputs (the next run's first step reads
        them from the reset states)."""
        self._fb_store = {}
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
        """Backpropagation through time, in two modes, as in the JAX package:

        - epoch mode (``inputs`` and ``targets`` are lists, or 3-D arrays
          ``(epochs, T, m)``): each epoch runs the trajectory from the
          pre-training state, takes the loss over its (downsampled) outputs
          and makes one optimizer update;
        - step mode (2-D ``(T, m)`` arrays): truncated BPTT.  The run is cut
          into chunks of ``update_steps`` steps; each chunk is one
          trajectory from the state the previous one left (detached: that is
          the truncation), its loss over its per-step outputs, and one
          optimizer update.  Leftover steps run forward without an update.
          The records follow the global ``step % sampling_steps == 0`` grid
          (per-step outputs, no downsampling), each with the loss of the
          last completed chunk (0 before the first).

        ``fused_bptt`` (default ``'auto'``): chain networks ``[instants] ->
        population -> [instants]`` train through the deferred-gradient
        trajectory of ``ops/bptt.py`` (the stateless pre/post stages run
        outside the time loop, as one batched product each); anything else,
        and step mode with ``record_vars``, takes plain autograd through
        ``make_step``.  ``True`` raises where the chain trajectory does not
        apply; ``False`` always takes plain autograd.  (The JAX package's
        multi-population graph trajectory is not ported; plain autograd
        gives the same gradients.)

        ``RECTIPY_FUSED_ADAM`` picks the optimizer tail of a plain-adam
        epoch-mode fit of one trained dense ``int8_master`` coupling on a
        chain: ``off`` (default: the split optax-formula optimizer) or ``on``
        (one pass of adam + requantization through
        ``ops.fused_opt.adam_requant``, the CUDA kernel on the card).  Any
        other value raises ``ValueError``.  Step mode always takes the split
        optimizer, as the JAX package does.

        Not ported yet: ``remat_steps`` (ROADMAP Queue 1 item 7) and
        ``mesh=`` (item 14).
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
        if epoch_mode and len(inputs) != len(targets):
            raise ValueError(
                "Wrong dimensions of input and target output. Please make sure that "
                "`inputs` and `targets` agree in the first dimension (epochs)."
            )
        mode = fused_adam_mode() if epoch_mode else "off"
        obs = Observer(dt=self.dt, **obs_kwargs)
        paths = self.trainable_paths()
        if not paths:
            raise ValueError("No trainable parameters in the network; pass `train_params` "
                             "to add_diffeq_node or train='gd' to add_edge.")
        train, frozen = self._partition(self.parameters_pytree(), paths)
        train = tree_map(lambda t: t.detach(), train)
        opt_state = opt.init(train)
        state0 = self.init_state()

        if not epoch_mode:
            inputs, targets = self._to_device(inputs), self._to_device(targets)
            if inputs.shape[0] != targets.shape[0]:
                raise ValueError(
                    "Wrong dimensions of input and target output. Please make sure that "
                    "`inputs` and `targets` agree in the first dimension."
                )
            t0 = perf_counter()
            train, stateT, rec = self._bptt_steps(loss_fn, opt, train, frozen, opt_state,
                                                  state0, inputs, targets, update_steps,
                                                  sampling_steps, obs, fused_bptt)
            self._write_back(state=stateT)
            obs.record_batch(rec["steps"], outputs=rec["out"], losses=rec["loss"],
                             var_values=rec["vars"])
            self._write_back(params=self._combine(train, frozen))
            if verbose:
                print(f"Finished optimization after {perf_counter() - t0} s.")
            return obs

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

    def fit_bptt_batch(self, inputs, targets, n_epochs: int = 1, batch_size: int = None,
                       optimizer: str = "adam", optimizer_kwargs: dict = None, loss: str = "mse",
                       loss_kwargs: dict = None, lr: float = 1e-3, sampling_steps: int = 1,
                       shuffle: bool = True, seed: int = 0, verbose: bool = True,
                       **kwargs) -> Observer:
        """Minibatch BPTT over a batch of independent trials, as the JAX
        package's ``fit_bptt_batch``.

        ``inputs``: ``(B, T, m)``, every trial from the network's current
        state; ``targets``: ``(B, R, n_out)`` with ``R = T // sampling_steps``
        (``(B, R)`` integer classes for ``loss='nll'|'ce'``).  Each update
        takes the gradient of the mean over ``batch_size`` trials (default:
        all B) of each trial's loss; ``n_epochs`` passes over the trials,
        reshuffled each epoch when ``shuffle`` (the permutations of
        ``numpy.random.default_rng(seed)``, the JAX package's).
        ``accum_steps=k`` averages the gradients of ``k`` equal micro-batches
        of each minibatch (the same update, ``1/k`` of the trajectories in
        memory).  ``batch_vars`` (``{(node, var): (B,) or (B, n)}``, as
        :meth:`run_batch`'s) gives each trial its own FROZEN parameters;
        trained parameters stay shared, and a trainable path raises.

        Every step advances the minibatch's trials together: chain networks
        train through the deferred-gradient trajectory of ``ops/bptt.py``
        with ``(B, n)`` rows (``int8_mm``/``int8_mm_t`` for an
        ``int8_master`` coupling) and one dW product over trials and time;
        other networks through plain autograd over the batched step
        (``fused_bptt`` as in :meth:`fit_bptt`; ``net.last_fit`` says which).
        The optimizer is the split one, as in the JAX package's batch
        programs (``RECTIPY_FUSED_ADAM`` is not read).

        Returns an Observer with ``train_loss`` (one per update),
        ``epoch_loss`` (the mean over an epoch's minibatches) and
        ``epochs``.  The trained parameters are written back; the network's
        state is left unchanged.  Not ported yet: ``remat_steps`` (ROADMAP
        Queue 1 item 7) and ``mesh=`` (item 14).  A node with the generic
        fused step raises: its kernel has no backward, as the JAX package's
        has none.  ``int4_master`` couplings take ``int4_mm``/``int4_mm_t``
        on the card.
        """
        self.compile()
        loss_fn = get_loss_function(loss, loss_kwargs=loss_kwargs)
        opt = get_optimizer(optimizer, lr, optimizer_kwargs=optimizer_kwargs)
        obs = Observer(dt=self.dt, **retrieve_from_dict(["record_loss"], kwargs))
        paths = self.trainable_paths()
        if not paths:
            raise ValueError("No trainable parameters in the network; pass `train_params` "
                             "to add_diffeq_node or train='gd' to add_edge.")
        if kwargs.pop("mesh", None) is not None:
            raise _todo("fit_bptt_batch(mesh=)", "14")
        self._refuse_generic_fused()
        batch_vars = kwargs.pop("batch_vars", None)
        setup = self._batch_fit_setup("fit_bptt_batch", inputs, targets, batch_size, loss,
                                      shuffle, seed, n_epochs, kwargs)
        params = self.parameters_pytree()
        sweeps = self._resolve_batch_vars("fit_bptt_batch", batch_vars, setup.B, params)
        train, frozen = self._partition(params, paths)
        train = tree_map(lambda t: t.detach(), train)
        opt_state = opt.init(train)
        batch_loss, pack, self.last_fit = self._build_batch_programs(loss_fn, sampling_steps,
                                                                     setup.fused_bptt)
        state0 = self.init_state()
        xs_all, tgt_all, mb, accum = setup.inputs, setup.targets, setup.mb, setup.accum
        y0 = pack(state0, mb // accum)

        t0 = perf_counter()
        losses = []
        perms = torch.as_tensor(setup.perms, device=self.device)
        for epoch in range(setup.epochs):
            perm = perms[epoch]
            for u in range(setup.n_mb):
                ids = perm[u * mb:(u + 1) * mb]
                lsum, gsum = None, None
                for a in range(accum):  # equal micro-batches: the mean of their means
                    sub = ids[a * (mb // accum):(a + 1) * (mb // accum)]
                    full = sub.shape[0] == setup.B and not setup.shuffled
                    xs = xs_all if full else xs_all.index_select(1, sub)
                    tgt = tgt_all if full else tgt_all.index_select(0, sub)
                    fz = self._with_sweeps(frozen, {p: (v if full else v.index_select(0, sub))
                                                    for p, v in sweeps.items()})
                    lval, grads = _value_and_grad(batch_loss, train, fz, y0, xs, tgt)
                    lsum = lval if lsum is None else lsum + lval
                    gsum = grads if gsum is None else tree_map(torch.add, gsum, grads)
                if accum > 1:
                    lsum, gsum = lsum / accum, tree_map(lambda g: g / accum, gsum)
                train, opt_state = opt.update(gsum, opt_state, train)
                train = tree_map(lambda t: t.detach(), train)
                losses.append(lsum)  # stays on the device until the end
            if verbose:
                ep = torch.stack(losses[-setup.n_mb:]).mean()
                print(f"Progress: {epoch + 1}/{setup.epochs} training epochs finished.")
                print(f"Epoch loss: {float(ep)}.")
                print("")
        host = _host(torch.stack(losses)) if losses else np.zeros(0)
        obs.save("train_loss", list(host))
        obs.save("epoch_loss", list(host.reshape(setup.epochs, setup.n_mb).mean(axis=1))
                 if setup.epochs else [])
        obs.save("epochs", np.arange(setup.epochs))
        self._write_back(params=self._combine(train, frozen))
        if verbose:
            print(f"Finished optimization after {perf_counter() - t0} s.")
        return obs

    def _resolve_batch_vars(self, name: str, batch_vars, B: int, params: dict,
                            trainer: bool = True) -> dict:
        """``batch_vars`` as ``{path: (B, ...) device tensor}`` (``(B,)``
        values as ``(B, 1)``).  The trainers take per-trial overrides of
        FROZEN parameters, ``(B,)`` or ``(B,) + leaf.shape``; a trainable
        path raises (per-start trained values are ``fit_bptt_multistart``'s,
        ROADMAP Queue 1 item 11).  ``run_batch`` (``trainer=False``) sweeps
        any parameter and checks the leading dimension only: a scalar
        parameter may sweep with per-neuron ``(B, n)`` values, as in the JAX
        package."""
        trainable = set(self.trainable_paths()) if trainer else set()
        sweeps = {}
        for k, vals in (batch_vars or {}).items():
            path = self._sweep_path(name, k)
            if path in trainable:
                raise ValueError(
                    f"{name}: batch_vars path {path} is TRAINABLE; per-trial sweeps apply to "
                    f"frozen parameters (per-start trainable inits are fit_bptt_multistart's "
                    f"start_inits).")
            try:
                leaf = params[path[0]][path[1]][path[2]]
            except KeyError:
                raise KeyError(f"{name}: batch_vars path {path} not found.")
            shape = tuple(np.shape(vals))
            leaf_shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
            if not trainer and shape[:1] != (B,):
                raise ValueError(f"{name}: batch_vars[{k}]: leading dimension {shape[:1]} != "
                                 f"batch size {B}")
            if trainer and shape not in ((B,), (B,) + leaf_shape):
                raise ValueError(f"{name}: batch_vars[{k}] must have shape {(B,)} (scalar per "
                                 f"trial) or {(B,) + leaf_shape}, got {shape}")
            sweeps[path] = self._sweep_values(vals, leaf)
        return sweeps

    def _batch_fit_setup(self, name: str, inputs, targets, batch_size, loss: str, shuffle,
                         seed, n_epochs, kwargs: dict) -> SimpleNamespace:
        """Validation, staging and minibatch arithmetic of the batched-trial
        trainers (the JAX package's ``_batch_fit_setup``): the inputs on the
        device time-major ``(T, B, m)`` (a step reads ``(B, m)`` rows), the
        targets ``(B, R, ...)``, ``B``, ``T``, the minibatch size ``mb`` and
        count ``n_mb``, ``accum``, ``shuffled``, ``fused_bptt``, ``epochs``
        and the per-epoch trial permutations ``perms`` (host numpy).
        Consumes its keyword arguments from ``kwargs``; any other raises."""
        if int(kwargs.pop("remat_steps", 0)) > 1:
            raise _todo(f"{name}(remat_steps=)", "7")
        fused_bptt = kwargs.pop("fused_bptt", "auto")
        accum = int(kwargs.pop("accum_steps", 1))
        retrieve_from_dict(["closure", "retain_graph"], kwargs)  # torch.optim-only knobs
        if kwargs:
            raise TypeError(f"{name}() got unexpected keyword arguments {sorted(kwargs)}")
        ishape, tshape = tuple(np.shape(inputs)), tuple(np.shape(targets))
        if len(ishape) != 3:
            raise ValueError(f"{name} expects (B, T, m) inputs, got {ishape}")
        expect_nd = 2 if loss in self._CLASS_LOSSES else 3
        if len(tshape) != expect_nd:
            raise ValueError(
                f"{name} expects targets of shape "
                f"{'(B, R) integer class labels' if expect_nd == 2 else '(B, R, n_out)'} "
                f"for loss={loss!r} (R = T // sampling_steps), got {tshape}")
        if tshape[0] != ishape[0]:
            raise ValueError(
                "Wrong dimensions of input and target output. Please make sure that "
                "`inputs` and `targets` agree in the first dimension (trials).")
        B, T = ishape[0], ishape[1]
        mb = B if batch_size is None else int(batch_size)
        if mb < 1 or B % mb:
            raise ValueError(f"batch_size={mb} must divide the number of trials B={B}")
        if accum < 1 or mb % accum:
            raise ValueError(
                f"accum_steps={accum} must divide the minibatch size {mb} (micro-batches of "
                f"mb/accum_steps trials each).")
        n_mb = B // mb
        shuffled = bool(shuffle) and n_mb > 1  # full batch: the order is moot
        E = int(n_epochs)
        if shuffled:
            rng = np.random.default_rng(seed)
            perms = np.stack([rng.permutation(B) for _ in range(E)]) if E else np.zeros((0, B))
        else:
            perms = np.broadcast_to(np.arange(B), (E, B))
        return SimpleNamespace(
            inputs=self._to_device(inputs).transpose(0, 1).contiguous(),
            targets=self._to_device(targets), B=B, T=T, mb=mb, n_mb=n_mb, accum=accum,
            shuffled=shuffled, fused_bptt=fused_bptt, epochs=E,
            perms=np.array(perms, dtype=np.int64))

    def _build_batch_programs(self, loss_fn, sampling_steps: int, fused_bptt) -> tuple:
        """``(batch_loss, pack, info)`` of the batched-trial trainers:
        ``batch_loss(train, frozen, y0, xs, tgt)``, the mean over the
        minibatch's trials of each trial's loss, for time-major inputs ``xs
        (T, mb, m)`` and targets ``(mb, R, ...)``; ``pack(state0, mb)``, the
        initial state of ``mb`` trials; and which trajectory the fit takes
        (``{"trajectory": "chain"|"autograd", "fused_adam": False}``)."""
        combine = self._combine
        step = self.make_step()
        chain, traj, wkeys = self._chain_traj(fused_bptt)
        s = int(sampling_steps)

        def trial_mean(outs, tgt):
            """outs (mb, T, n): each trial's loss on its downsampled outputs,
            then the mean over trials (the JAX package's vmapped loss)."""
            if s > 1:
                n_keep = outs.shape[1] // s
                outs = outs[:, :n_keep * s].reshape(outs.shape[0], n_keep, s, -1).mean(dim=2)
            return torch.stack([loss_fn(o, t) for o, t in zip(outs, tgt)]).mean()

        if traj is not None:
            label, prefix, suffix = chain

            def pack(state0, mb):
                return self._batch_state(state0, mb)["nodes"][label]

            def batch_loss(train, frozen, y0, xs, tgt):
                params = combine(train, frozen)
                nargs = params["nodes"][label]
                W = {k: nargs[k] for k in wkeys}
                rest = {k: v for k, v in nargs.items() if k not in wkeys}
                xs = prefix(params, xs) if prefix is not None else xs
                _, outs = traj(W, rest, y0, xs)
                if suffix is not None:
                    outs = suffix(params, outs)
                return trial_mean(outs.transpose(0, 1), tgt)
        else:
            def pack(state0, mb):
                return self._batch_state(state0, mb)

            def batch_loss(train, frozen, state0, xs, tgt):
                params = self._prep_edge_params(combine(train, frozen))
                state, outs = state0, []
                for x in xs.unbind(0):
                    state, out, _ = step(state, params, x)
                    outs.append(out)
                return trial_mean(torch.stack(outs, dim=1), tgt)

        return batch_loss, pack, {"trajectory": "chain" if traj is not None else "autograd",
                                  "fused_adam": False}

    def _chain_decompose(self):
        """Decompose a chain network ``[instants...] -> population ->
        [instants...]`` (stateless ``Linear`` edges) into ``(label,
        apply_prefix, apply_suffix)``; ``None`` when the topology does not
        qualify (feedback edges never do).  The stateless pre/post stages
        move outside the time loop: each becomes one batched product over the
        ``(T, n)`` series."""
        order = self._compiled["order"]
        if self._fb_edge_list():
            return None
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

    def _chain_traj(self, fused_bptt) -> tuple:
        """``(chain, traj, wkeys)``: the chain decomposition and the
        deferred-gradient trajectory of its population with the coupling
        keys it takes (``ops/bptt.make_coupled_traj``), or ``traj=None``
        where the fit takes plain autograd.  ``fused_bptt=True`` raises
        where the trajectory does not apply."""
        if fused_bptt not in ("auto", True):
            return None, None, None
        chain = self._chain_decompose()
        if chain is None:
            if fused_bptt is True:
                raise ValueError("fused_bptt=True needs a chain network [instants] -> "
                                 "population -> [instants]; the graph trajectory is not "
                                 "ported yet (ROADMAP Queue 1 item 10).")
            return None, None, None
        from .ops.bptt import make_coupled_traj

        try:
            traj, wkeys = make_coupled_traj(self.get_node(chain[0]))
        except (ValueError, AttributeError, KeyError):
            if fused_bptt is True:
                raise
            return chain, None, None
        return chain, traj, wkeys

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
        chain, traj, traj_wkeys = self._chain_traj(fused_bptt)

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
                params = self._prep_edge_params(combine(train, frozen))
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
        stage = self._stager()
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

    def _to_device(self, x) -> torch.Tensor:
        """An array or tensor on the network's device, in its dtype."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=self.dtype)
        x = np.asarray(x)
        if not x.flags.writeable:  # a broadcast view: torch takes only writable arrays
            x = x.copy()
        return torch.as_tensor(x).to(device=self.device, dtype=self.dtype)

    def _stager(self) -> Callable:
        """``stage(x)``: each distinct input/target array moves to the device
        once; the cache holds the source object too, so an id() is never
        reused."""
        staged: Dict[int, tuple] = {}

        def stage(x):
            hit = staged.get(id(x))
            if hit is None:
                hit = staged[id(x)] = (x, self._to_device(x))
            return hit[1]

        return stage

    def _bptt_steps(self, loss_fn, opt, train, frozen, opt_state, state0, inputs, targets,
                    update_steps, sampling_steps, obs, fused_bptt):
        """Step mode of ``fit_bptt`` (truncated BPTT): ``(train', state_T,
        records)``.  The chunk losses and the records stay on the device
        until the end."""
        combine = self._combine
        step = self.make_step()
        T, u, s = int(inputs.shape[0]), int(update_steps), int(sampling_steps)
        n_upd = T // u
        rec_info = self._resolve_record_vars(obs)
        record_output = obs.record_output

        # records on the global grid step % s == 0: per-step outputs and
        # record_vars after the step
        rec_steps, rec_out, rec_vars = [], [], []

        def record(t, out, vals):
            rec_steps.append(t)
            if record_output:
                rec_out.append(out.detach())
            rec_vars.append([v.detach() for v in vals])

        def forward(state, params, t0, t1):  # no update (T < u, and the leftover)
            params = self._prep_edge_params(params)
            with torch.no_grad():
                for t in range(t0, t1):
                    state, out, _ = step(state, params, inputs[t])
                    if t % s == 0:
                        record(t, out, _read_vars(rec_info, state, params))
            return state

        # the chain trajectory emits outputs only: record_vars take autograd
        chain, traj, wkeys = self._chain_traj(fused_bptt if not rec_info else False)
        if traj is not None:
            label, prefix, suffix = chain

            def chunk_loss(train, frozen, state, t0):
                params = combine(train, frozen)
                nargs = params["nodes"][label]
                W = {k: nargs[k] for k in wkeys}
                rest = {k: v for k, v in nargs.items() if k not in wkeys}
                xs = inputs[t0:t0 + u]
                xs = prefix(params, xs) if prefix is not None else xs
                yT, outs = traj(W, rest, state["nodes"][label], xs)
                if suffix is not None:
                    outs = suffix(params, outs)
                new_state = {**state, "nodes": {**state["nodes"], label: yT}}
                return loss_fn(outs, targets[t0:t0 + u]), (new_state, outs, {})
        else:
            def chunk_loss(train, frozen, state, t0):
                params = self._prep_edge_params(combine(train, frozen))
                outs, vals = [], {}
                for t in range(t0, t0 + u):
                    state, out, _ = step(state, params, inputs[t])
                    outs.append(out)
                    if rec_info and t % s == 0:
                        vals[t] = _read_vars(rec_info, state, params)
                outs = torch.stack(outs)
                return loss_fn(outs, targets[t0:t0 + u]), (state, outs, vals)

        self.last_fit = {"trajectory": "chain" if traj is not None else "autograd",
                         "fused_adam": False}
        state, losses = state0, []
        for c in range(n_upd):
            t0 = c * u
            lval, grads, (state, outs, vals) = _value_and_grad(
                chunk_loss, train, frozen, state, t0, has_aux=True)
            train, opt_state = opt.update(grads, opt_state, train)
            train = tree_map(lambda t: t.detach(), train)
            state = _detach(state)  # the truncation
            losses.append(lval)
            for t in range(t0 + (-t0) % s, t0 + u, s):
                record(t, outs[t - t0], vals.get(t, ()))
        state = forward(state, combine(train, frozen), n_upd * u, T)

        steps = np.asarray(rec_steps, dtype=np.int64)
        # the loss recorded at step t is that of the last chunk completed by
        # then (chunks end at steps u-1, 2u-1, ...; 0 before the first)
        done = np.minimum((steps + 1) // u, n_upd)
        chunk_losses = _host(torch.stack(losses)) if losses else np.zeros(1)
        rec_loss = np.where(done >= 1, chunk_losses[np.maximum(done - 1, 0)], 0.0)
        vars_ = {key: _host(torch.stack([r[i] for r in rec_vars]))
                 for i, (key, _, _, _) in enumerate(rec_info)} if len(steps) else {}
        out = _host(torch.stack(rec_out)) if rec_out else None
        return train, state, {"steps": steps, "out": out, "loss": rec_loss, "vars": vars_}

    def fit_ridge(self, inputs, targets, sampling_steps: int = 100, alpha: float = 1e-4,
                  verbose: bool = True, add_readout_node: bool = True, **kwargs) -> Observer:
        """Closed-form ridge-regression readout of the network trajectory,
        ``w_out = (X^T X + alpha*I)^-1 X^T y``, with ``X`` the outputs
        ``run`` records (one row per ``sampling_steps`` window) and ``y`` the
        targets at the recorded steps.  The Gram matrix and the solve run on
        the network's device in its dtype.  ``add_readout_node=True`` adds an
        identity node ``readout`` wired from the output node with ``w_out``.
        The Observer also holds ``y`` (the fitted predictions ``X w_out``)
        and ``w_out``, as numpy arrays."""
        targets = self._to_device(targets)
        if len(inputs) != targets.shape[0]:
            raise ValueError(
                "Wrong dimensions of input and target output. Please make sure that `inputs` "
                "and `targets` agree in the first dimension."
            )
        self.compile()
        t0 = perf_counter()
        obs = self.run(inputs=inputs, sampling_steps=sampling_steps, verbose=verbose, **kwargs)
        if verbose:
            print(f"Finished network state collection after {perf_counter() - t0} s.")

        t0 = perf_counter()
        X = self._to_device(obs.to_numpy("out"))
        if X.shape[0] != targets.shape[0]:
            targets = targets[torch.as_tensor(np.asarray(obs["steps"]), device=self.device)]
        gram = X.T @ X + alpha * torch.eye(X.shape[1], dtype=self.dtype, device=self.device)
        w_out = torch.linalg.solve(gram, X.T @ targets)
        y = X @ w_out
        if verbose:
            print(f"Finished fitting of read-out weights after {perf_counter() - t0} s.")

        if add_readout_node:
            prev_out = self._out_node
            self.add_func_node("readout", n=int(w_out.shape[1]), activation_function="identity")
            self.add_edge(prev_out, target="readout", weights=w_out.T.contiguous())
        obs.save("y", _host(y))
        obs.save("w_out", _host(w_out))
        return obs

    def fit_rls(self, inputs, targets, update_steps: int = 1, sampling_steps: int = 100,
                verbose: bool = True, **kwargs) -> Observer:
        """Online recursive-least-squares (FORCE) training of the edge added
        with ``add_edge(..., train='rls')``.

        Every step runs the network; at ``step % update_steps == 0`` the RLS
        update adapts the edge's weights and ``P`` from the edge's source
        output, the target and the readout's output of that step.  Online
        mode (2-D inputs): the records fall on ``step % sampling_steps ==
        0`` (the step's output, the loss current at that step and
        ``record_vars`` snapshots).  Epoch mode (lists of inputs and
        targets): the network state is reset to the pre-training state
        after each epoch; the Observer holds ``epoch_loss`` (the last
        update's loss of each epoch) and ``epochs``."""
        if not self._train_edge:
            raise ValueError("No RLS-trainable edge in the network; add one with "
                             "add_edge(..., train='rls').")
        self.compile()
        if kwargs.pop("mesh", None) is not None:
            raise _todo("fit_rls(mesh=)", "14")
        obs_kwargs = retrieve_from_dict(["record_output", "record_loss", "record_vars"], kwargs)
        obs = Observer(dt=self.dt, **obs_kwargs)
        edge = self.get_edge(*self._train_edge)

        t0 = perf_counter()
        if isinstance(inputs, list):
            if len(inputs) != len(targets):
                raise ValueError(
                    "Wrong dimensions of input and target output. Please make sure that "
                    "`inputs` and `targets` agree in the first dimension (epochs)."
                )
            y0 = self.state
            stage = self._stager()
            losses = []
            for epoch in range(len(inputs)):
                loss = self._rls_loop(stage(inputs[epoch]), stage(targets[epoch]), update_steps,
                                      sampling_steps, obs, record=False)
                losses.append(loss)  # stays on the device until the end
                self.reset(y0)
                if verbose:
                    print(f"Progress: {epoch + 1}/{len(inputs)} training epochs finished.")
                    print(f"Epoch loss: {float(loss)}.")
                    print("")
            if losses:
                losses = [float(x) for x in torch.stack(losses).cpu().tolist()]
                edge.loss = losses[-1]
            obs.save("epoch_loss", losses)
            obs.save("epochs", np.arange(len(inputs)))
        else:
            inputs, targets = self._to_device(inputs), self._to_device(targets)
            if inputs.shape[0] != targets.shape[0]:
                raise ValueError(
                    "Wrong dimensions of input and target output. Please make sure that "
                    "`inputs` and `targets` agree in the first dimension."
                )
            edge.loss = float(self._rls_loop(inputs, targets, update_steps, sampling_steps, obs,
                                             record=True))
        if verbose:
            print(f"Finished optimization after {perf_counter() - t0} s.")
        return obs

    def _rls_loop(self, inputs, targets, update_steps, sampling_steps, obs, record: bool):
        """One pass of ``fit_rls`` over ``inputs``; returns the last update's
        loss as a 0-d device tensor.  The JAX package computes the update
        every step and selects it; this loop branches on the host step
        index, so steps without an update skip the O(N^2) work."""
        src, tgt = self._train_edge
        edge = self.get_edge(src, tgt)
        update = RLS.update_fn(edge.beta)
        step = self.make_step(taps=(src, tgt))
        state = self.init_state()
        params = self._prep_params(self.parameters_pytree())
        eparams = params["edges"][_ekey(src, tgt)] = dict(params["edges"][_ekey(src, tgt)])
        W, P = edge.params["weights"], edge.params["P"]
        w_dtype = W.dtype
        loss = torch.zeros((), dtype=w_dtype, device=self.device)
        var_info = self._resolve_record_vars(obs) if record else []
        u, s = int(update_steps), int(sampling_steps)
        rec_steps, rec_out, rec_loss, rec_vars = [], [], [], []
        with torch.no_grad():
            for t in range(int(inputs.shape[0])):
                eparams["weights"] = W
                state, out, taps = step(state, params, inputs[t])
                if t % u == 0:
                    W, P, loss = update(W, P, taps[src].to(w_dtype), targets[t].to(w_dtype),
                                        taps[tgt].to(w_dtype))
                if record and t % s == 0:
                    rec_steps.append(t)
                    rec_out.append(out)
                    rec_loss.append(loss)
                    rec_vars.append(_read_vars(var_info, state, params))
        edge.params["weights"] = W  # P was downdated in place
        self._write_back(state=state)
        if record and rec_steps:
            var_values = {key: _host(torch.stack([r[i] for r in rec_vars]))
                          for i, (key, _, _, _) in enumerate(var_info)}
            obs.record_batch(np.asarray(rec_steps), outputs=_host(torch.stack(rec_out)),
                             losses=_host(torch.stack(rec_loss)), var_values=var_values or None)
        return loss

    def test(self, inputs, targets, loss: str = "mse", loss_kwargs: dict = None,
             sampling_steps: int = 100, verbose: bool = True, **kwargs) -> tuple:
        """Run with frozen parameters and return ``(Observer, loss)``, the
        loss of the recorded outputs against the targets at the recorded
        steps (when ``sampling_steps > 1`` the targets are downsampled to
        them).  The loss is computed on the host, in the network's dtype."""
        loss_fn = get_loss_function(loss, loss_kwargs=loss_kwargs)
        obs = self.run(inputs=inputs, sampling_steps=sampling_steps, verbose=verbose, **kwargs)
        output = torch.as_tensor(obs.to_numpy("out")).to(self.dtype)
        targets = (targets.detach().cpu() if isinstance(targets, torch.Tensor)
                   else torch.as_tensor(np.asarray(targets))).to(self.dtype)
        if output.shape[0] != targets.shape[0]:
            targets = targets[torch.as_tensor(np.asarray(obs["steps"]))]
        return obs, float(loss_fn(output, targets))


def _value_and_grad(loss_fn, train, *args, has_aux: bool = False):
    """``(loss, grads)`` of ``loss_fn(train, *args)`` with respect to every
    leaf of ``train``; a leaf the loss does not reach gets a zero gradient.
    With ``has_aux`` the function returns ``(loss, aux)`` and so does this
    one, ``(loss, grads, aux)``."""
    paths, leaves = _flatten(train)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        res = loss_fn(_unflatten(paths, leaves), *args)
        lval, aux = res if has_aux else (res, None)
        grads = torch.autograd.grad(lval, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    out = (lval.detach(), _unflatten(paths, grads))
    return out + (aux,) if has_aux else out


class FeedbackNetwork(Network):
    """Network with feedback edges: an edge added with ``feedback=True``
    carries its source node's output of the previous step (a one-step
    delayed recurrence between nodes, RectiPy's ``FeedbackNetwork``).

    ``compile()`` moves the feedback edges out of ``graph`` into
    ``_fb_graph`` (so the feedforward graph keeps a topological order) and
    is re-entrant; ``get_edge``, ``get_node`` and ``pop_edge`` find them
    there."""

    def __init__(self, dt: float, device=None, dtype=torch.float32):
        super().__init__(dt, device=device, dtype=dtype)
        self._fb_graph: Optional[DiGraph] = None

    def compile(self):
        if self._fb_graph is not None:
            for u, v in self._fb_graph.edges:
                self.graph.add_edge(u, v, **self._fb_graph[u][v])
            self._fb_graph = None
        ffwd_edges, fb_edges = [], []
        for u, v in self.graph.edges:
            (fb_edges if self.graph[u][v].get("feedback") else ffwd_edges).append((u, v))
        fb = DiGraph()
        for u, v in fb_edges:
            fb.add_node(u, **self.graph.nodes[u])
            fb.add_node(v, **self.graph.nodes[v])
            fb.add_edge(u, v, **self.graph[u][v])
        g_fwd = DiGraph()
        for n, attrs in self.graph.nodes(data=True):
            g_fwd.add_node(n, **attrs)
        for u, v in ffwd_edges:
            g_fwd.add_edge(u, v, **self.graph[u][v])
        self._fb_graph = fb
        self.graph = g_fwd
        return super().compile()

    def add_edge(self, source: str, target: str, weights=None, train: Optional[str] = None,
                 feedback: bool = False, edge_attrs: dict = None, **kwargs) -> Linear:
        edge_attrs = dict(edge_attrs or {})
        edge_attrs["feedback"] = feedback
        return super().add_edge(source, target, weights=weights, train=train,
                                edge_attrs=edge_attrs, **kwargs)

    def get_edge(self, source: str, target: str) -> Linear:
        try:
            return super().get_edge(source, target)
        except KeyError:
            if self._fb_graph is None or not self._fb_graph.has_edge(source, target):
                raise
            return self._fb_graph[source][target]["edge"]

    def pop_edge(self, source: str, target: str):
        if (self._fb_graph is not None and not self.graph.has_edge(source, target)
                and self._fb_graph.has_edge(source, target)):
            edge = self._fb_graph[source][target]["edge"]
            self._fb_graph.remove_edge(source, target)
            self._invalidate()
            return edge
        return super().pop_edge(source, target)

    def get_node(self, node: str):
        try:
            return super().get_node(node)
        except KeyError:
            if self._fb_graph is None:
                raise
            return self._fb_graph.nodes[node]["node"]

    def _fb_edge_list(self) -> list:
        if self._fb_graph is None:
            return []
        return [(u, v, self._fb_graph[u][v]["edge"]) for u, v in self._fb_graph.edges]

    def parameters(self, recurse: bool = True) -> Iterator:
        yield from super().parameters(recurse=recurse)
        for u, v, e in self._fb_edge_list():
            yield from e.parameters()
