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
  trajectories: ``ops/bptt.py``'s on chain networks, ``ops/graph_bptt.py``'s
  on other graphs of populations and linear-family edges, and plain
  autograd otherwise;
- ``fit_ridge``: a closed-form ridge readout (Gram matrix and solve);
- ``fit_rls``: online FORCE learning of an ``RLS`` edge;
- ``test``: a frozen run scored by a loss;
- ``fit_bptt_multistart``: ``fit_bptt_batch``'s update for ``M``
  independently initialised starts, the best written back;
- ``fit_es``: evolution strategies over node and edge parameters, each
  generation one ``run_batch`` of the candidates;
- ``fit_stdp``: spike-timing-dependent plasticity of an ``STDP`` or
  ``BlockSparseSTDP`` edge (reward-modulated, homeostatic scaling), the
  update one launch of the fused ``stdp_update`` kernel a step on the card;
- ``fit_eprop``: online three-factor learning of a readout edge.

Batched trials: ``run_batch`` integrates ``B`` independent trials together
(``(B, T, m)`` inputs, or a shared ``(T, m)`` drive with per-trial
parameters, ``batch_vars``), and ``fit_bptt_batch`` trains on them in
minibatches.  Every node and edge step takes states with a leading trial
axis, so a step of ``B`` trials is one step whose products take ``(B, n)``
rows.  ``run`` and ``run_batch`` take input specs (``inputs.py``: drives
made on the device a chunk of steps at a time) and ``record_spikes`` (spike
counts per record window).

On the device: the inputs move to the device once, the records and losses
stay on the device, and nothing inside the loops synchronises with the host;
they cross to the host once, at the end.

Multi-device: ``run``, ``run_batch`` and the seven trainers take ``mesh=``
(a ``torch.distributed`` device mesh, ``parallel/``): the populations shard
over its ``model`` axis, trials, starts and candidates over its ``data``
axis; every rank calls the same function with the same arguments and ends
with the results of the call without a mesh.  Every coupling and edge the
trainers take unsharded trains on a model axis above one too: the
quantized ones (``int8_master``, ``int4_master``, ``int8_master`` blocks
and block edges) take each dynamic scale as a maximum over the model group
and add the ranks' integer sums before scaling (``ops/quant.py``).
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

from . import debugging
from .edges import (RLS, STDP, BlockSparseLinear, BlockSparseSTDP, Linear, LinearFilter,
                    LinearMasked, LinearMemory, LinearMemoryFilter, LinearMemoryMatrix, LinearSTP)
from .inputs import InputSpec
from .nodes import InstantNode, RateNet, SpikeNet, SpikeResetNet, resolve_device, resolve_dtype
from .observer import Observer
from .ops.stdp import clip
from .train import get_loss_function, get_optimizer
from .train.optimizers import tree_map
from .utility import add_op_name, retrieve_from_dict

__all__ = ["FeedbackNetwork", "Network"]


# the keyword arguments an STDP edge takes from add_edge (the JAX package's
# stdp_keys, less those add_edge fills in itself)
_STDP_KEYS = ("tau_plus", "tau_minus", "a_plus", "a_minus", "w_min", "w_max", "soft_bounds",
              "w_dtype", "rng")


def _ekey(u: str, v: str) -> str:
    return f"{u}->{v}"


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


def _best_start(losses) -> int:
    """Index of the lowest finite loss (0 when none is finite): a start that
    diverged (NaN or inf) never wins, where ``np.argmin`` would pick a NaN."""
    losses = np.asarray(losses, dtype=np.float64)
    finite = np.isfinite(losses)
    if not finite.any():
        return 0
    return int(np.argmin(np.where(finite, losses, np.inf)))


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


def _unreduced(rec_info: list) -> list:
    """``rec_info`` recording every variable per neuron: a population
    shard's ``reduce`` records are averaged after the gather."""
    return [(key, label, reader, False) for key, label, reader, _ in rec_info]


def _host(x: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 (which numpy lacks) as float32."""
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _shard_fns(net, shard) -> tuple:
    """``(cols, whole, reduce)`` of a trainer's programs: a drive cut to
    the input node's rows, the output node's rows made whole (the loss
    takes them), and a gradient tree reduced over the model group
    (``parallel/sharding.NetworkShard``); identities without a shard."""
    if shard is None:
        def same(x):
            return x
        return same, same, same
    return (shard.cols, lambda outs: shard.whole(net._out_node, outs), shard.reduce_grads)


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
        # the edge an online trainer adapts (RLS, eprop or STDP): (source, target)
        self._train_edge: Optional[Tuple[str, str]] = None
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
            # a circuit of mixed model equations cannot share one vector
            # field: one node per template group, wired by Linear edges
            return self._add_circuit_nodes(
                label, node, input_var=input_var, output_var=output_var,
                spike_var=spike_var, reset_var=reset_var, reset=reset, op=op,
                train_params=train_params, weights=weights, source_var=source_var,
                target_var=target_var, **kwargs)

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

    def _add_circuit_nodes(self, label: str, circuit, input_var: str, output_var: str,
                           spike_var=None, reset_var=None, reset: bool = True, op: str = None,
                           train_params: list = None, weights=None, source_var: str = None,
                           target_var: str = None, **kwargs) -> RateNet:
        """Expand a CircuitTemplate of mixed model equations into one node
        per structurally homogeneous group, ``"<label>.<group>"``, wired by
        ``Linear`` edges cut from the circuit's weight matrices (the JAX
        package's ``_add_circuit_nodes``).

        For each circuit edge ``(source_var, target_var, W)`` the block
        ``W[targets of group i, sources of group j]`` becomes group i's own
        coupling (``i == j``) or an edge ``<label>.<group j> -> <label>.<group
        i>`` into group i's ``target_var`` (the group's input variable).  The
        external input drives the group that owns ``input_var``; the output
        is the group that owns ``output_var``.  Returns the output group's
        node."""
        from .dsl.parser import TemplateError, _strip_node_prefix

        if op is not None:
            raise TemplateError(
                "The `op` shorthand is not supported for heterogeneous circuits (each group "
                "has its own operators); qualify variables as 'op/var'.")
        if weights is not None or source_var is not None or target_var is not None:
            raise TemplateError(
                "weights/source_var/target_var are not supported together with a "
                "heterogeneous CircuitTemplate; declare every coupling on the circuit via "
                "add_edges_from_matrix.")
        if "record_vars" in kwargs:
            raise TemplateError(
                "record_vars on add_diffeq_node is not supported for heterogeneous circuits; "
                "record at run() time with record_vars=[('<label>.<group>', '<var>', "
                "reduce)] on the expanded node labels.")
        node_vars = kwargs.pop("node_vars", kwargs.pop("node_values", None)) or {}
        groups = list(circuit.groups)
        gid = {id(g): k for k, g in enumerate(groups)}
        n_total = circuit.n

        # intra-group couplings and inter-group edges; a full matrix may
        # populate only its (target group x source group) block
        intra = {k: [] for k in range(len(groups))}
        inter = []  # (source group, target group, source var, target var, block)
        for sv_raw, tv_raw, W in circuit.edges:
            gs, sv = circuit.resolve_group(sv_raw)
            gt, tv = circuit.resolve_group(tv_raw)
            W = np.asarray(W)
            if W.shape != (n_total, n_total):
                raise TemplateError(
                    f"Circuit edge {sv!r}->{tv!r} weight matrix has shape {W.shape}; expected "
                    f"({n_total}, {n_total}) over the full circuit index space.")
            block = W[np.ix_(gt.indices, gs.indices)]
            outside = W.copy()
            outside[np.ix_(gt.indices, gs.indices)] = 0.0
            if np.any(outside != 0.0):
                raise TemplateError(
                    f"Circuit edge {sv!r}->{tv!r}: weight entries outside the [{gt.name} "
                    f"targets x {gs.name} sources] block are nonzero but {sv!r}/{tv!r} only "
                    f"exist on those groups.")
            if gs is gt:
                intra[gid[id(gs)]].append((sv, tv, block))
            else:
                inter.append((gid[id(gs)], gid[id(gt)], sv, tv, block))

        gi, input_var = circuit.resolve_group(input_var)
        go, output_var = circuit.resolve_group(output_var)
        g_in, g_out = gid[id(gi)], gid[id(go)]
        in_chan = {g_in: input_var}
        for _, ti, _, tv, _ in inter:
            if in_chan.setdefault(ti, tv) != tv:
                raise TemplateError(
                    f"Group {groups[ti].name!r} receives input at both {in_chan[ti]!r} and "
                    f"{tv!r}; a Network node has one input channel -- give the group a single "
                    f"target variable (or build the nodes by hand).")
        out_chan = {g_out: output_var}
        for si, _, sv, _, _ in inter:
            if out_chan.setdefault(si, sv) != sv:
                raise TemplateError(
                    f"Group {groups[si].name!r} feeds edges from both {out_chan[si]!r} and "
                    f"{sv!r}; a Network node has one output channel.")
        for k, g in enumerate(groups):
            if k not in in_chan:
                raise TemplateError(
                    f"Group {g.name!r} receives neither the external input ({input_var!r}) "
                    f"nor any inter-group edge; the expanded Network would have two input "
                    f"nodes. Drive it or couple into it.")
            if k not in out_chan:
                raise TemplateError(
                    f"Group {g.name!r} neither provides the circuit output ({output_var!r}) "
                    f"nor feeds any inter-group edge; the expanded Network would have two "
                    f"output nodes.")
        if g_in in {ti for _, ti, _, _, _ in inter}:
            raise TemplateError(
                f"The externally-driven group {groups[g_in].name!r} also receives inter-group "
                f"coupling; that needs two input channels on one node. Re-root the circuit or "
                f"build the nodes by hand (FeedbackNetwork covers cyclic topologies).")
        gg = DiGraph()
        gg.add_nodes_from(range(len(groups)))
        gg.add_edges_from((si, ti) for si, ti, _, _, _ in inter)
        if not nx.is_directed_acyclic_graph(gg):
            raise TemplateError(
                "The circuit's inter-group coupling is cyclic; express the cycle with "
                "FeedbackNetwork.add_edge(..., feedback=True) between hand-built nodes "
                "(one-step-delayed recurrence).")

        def slice_overrides(g, src: dict) -> dict:
            out = {}
            for key, val in src.items():
                qkey = _strip_node_prefix(key)
                if not g.owns(qkey):
                    continue
                arr = np.asarray(val)
                if arr.ndim >= 1 and arr.shape[0] == n_total and g.n != n_total:
                    out[f"all/{qkey}"] = arr[g.indices]
                else:
                    out[f"all/{qkey}"] = val
            return out

        labels, built = {}, {}
        for k, g in enumerate(groups):
            labels[k] = f"{label}.{g.name}"
            gvars = slice_overrides(g, g.node_vars)
            gvars.update(slice_overrides(g, circuit.node_vars))  # update_var()
            gvars.update(slice_overrides(g, node_vars))
            couplings = intra[k]
            gw = gsv = gtv = None
            gkwargs = dict(kwargs)
            if couplings:
                gsv, gtv, gw = couplings[0]
                if couplings[1:]:
                    gkwargs["edges"] = list(gkwargs.get("edges") or []) + couplings[1:]
            gkwargs["N"] = g.n
            gtrain = None
            if train_params:
                gtrain = [p for p in train_params
                          if (p == "weights" and couplings)
                          or (p != "weights" and g.owns(_strip_node_prefix(p)))] or None
            spike_kw = {}
            if spike_var and g.owns(_strip_node_prefix(spike_var)):
                spike_kw = {"spike_var": spike_var, "reset_var": reset_var, "reset": reset}
            built[k] = self.add_diffeq_node(
                labels[k], g.template, input_var=in_chan[k], output_var=out_chan[k],
                weights=gw, source_var=gsv, target_var=gtv, train_params=gtrain,
                node_vars=gvars or None, **spike_kw, **gkwargs)
        for si, ti, _, _, block in inter:
            self.add_edge(labels[si], labels[ti], weights=block)
        self._invalidate()
        return built[g_out]

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
          float64 (the JAX package takes float64 only with x64 on);
        - ``'eprop'``: the class above built from the weights alone, frozen
          to autograd, which ``fit_eprop`` trains online;
        - ``'stdp'``: an ``STDP`` edge (``tau_plus``, ``tau_minus``,
          ``a_plus``, ``a_minus``, ``w_min``, ``w_max``, ``soft_bounds``,
          ``w_dtype``, ``rng``), or a ``BlockSparseSTDP`` for a
          ``BlockSparseCoupling`` (the same, ``block_dtype`` for ``rng``),
          which ``fit_stdp`` trains.  Delays, masks, filters and short-term
          plasticity raise ``ValueError`` on a plastic edge, and so does
          ``rng`` on a block one (the JAX package ignores it there).

        Other keywords an STDP edge does not take are ignored, as in the
        JAX package."""
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
        if train not in (None, "gd", "rls", "eprop", "stdp"):
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
        elif train == "eprop":
            # the delta rule updates the weights outside autograd, like RLS
            edge = EdgeClass(n_in=n_in, n_out=n_out, weights=weights, dtype=self.dtype,
                             device=self.device, detach=True)
            self._train_edge = (source, target)
        elif train == "stdp":
            structural = sorted({"delays", "mask", "filter_weights", "tau_facil",
                                 "tau_depress"} & set(kwargs))
            if structural:
                # a plastic edge is a plain projection: the pair rule would
                # need per-synapse delayed/masked/filtered pre-spike trains
                raise ValueError(
                    f"{'/'.join(structural)} are not supported on a plastic "
                    "(train='stdp') edge; chain a separate delayed/masked/"
                    "filtered edge for the transmission structure and keep "
                    "the STDP edge a plain projection.")
            rule = {k: v for k, v in kwargs.items() if k in _STDP_KEYS}
            common = dict(n_in=n_in, n_out=n_out, weights=weights, dtype=self.dtype,
                          device=self.device)
            if hasattr(weights, "blocks"):
                # plasticity on the fan-in blocks; a stray rng raises
                if "block_dtype" in kwargs:
                    rule["block_dtype"] = kwargs["block_dtype"]
                edge = BlockSparseSTDP(**common, **rule)
            else:
                edge = STDP(**common, **rule)
            self._train_edge = (source, target)
        else:
            kwargs.update({"n_in": n_in, "n_out": n_out, "weights": weights,
                           "dtype": self.dtype, "device": self.device})
            edge = EdgeClass(**kwargs, detach=train is None)
        self.graph.add_edge(source, target, edge=edge, trainable=train == "gd",
                            n_in=edge.n_in, n_out=edge.n_out, **edge_attrs)
        self._invalidate()
        return edge

    def pop_node(self, node: str):
        """Remove a node (and its edges) from the graph and return it."""
        node_data = self.get_node(node)
        self.graph.remove_node(node)
        self._invalidate()
        return node_data

    def pop_edge(self, source: str, target: str):
        edge = self.get_edge(source, target)
        self.graph.remove_edge(source, target)
        self._invalidate()
        return edge

    def clear(self):
        """Remove every node and edge."""
        for node in list(self.nodes):
            self.pop_node(node)

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
        :meth:`parameters_pytree`.  Inside ``debugging.enable_nan_checks()``
        the step returned checks each new state for NaN and infinity.
        """
        step = self._cached_step(taps)
        return debugging.checked_step(step) if debugging.nan_checks_enabled() else step

    def _cached_step(self, taps: Tuple[str, ...]) -> Callable:
        if self._compiled is None:
            self.compile()
        order = self._compiled["order"]
        key = (tuple(taps), self._step_versions())
        if key in self._step_cache:
            return self._step_cache[key]

        step = self._compose_step(taps, self.get_node, self.get_edge, self._fb_edge_list())
        self._step_cache[key] = step
        return step

    def _compose_step(self, taps: Tuple[str, ...], node_of: Callable, edge_of: Callable,
                      fb_edges: list, source: Callable = None, tap: Callable = None) -> Callable:
        """The network step composed from the steps of ``node_of(label)``,
        ``edge_of(u, v)`` and the feedback edges ``[(u, v, edge)]``.
        ``source(u, v, out, cache)`` (a population shard's, ``parallel/``)
        gives what edge ``u -> v`` takes of its source's output; ``cache`` is
        fresh each step (and separate for the carried feedback outputs);
        ``tap(u, out, cache)`` makes a tap of the shard whole."""
        order = self._compiled["order"]
        node_steps = {n: node_of(n).make_step() for n in order}
        preds = {n: sorted(self.graph.predecessors(n)) for n in order}
        edge_steps = {(u, n): edge_of(u, n).make_step() for n in order for u in preds[n]}
        out_node = self._out_node
        fb_steps = {(u, v): e.make_step() for u, v, e in fb_edges}
        fb_by_target: Dict[str, list] = {}
        for u, v, _ in fb_edges:
            fb_by_target.setdefault(v, []).append(u)
        fb_sources = sorted({u for u, _, _ in fb_edges})
        # a feedback edge carries its source's out-slice after the update (the
        # next step's pre-update output, RectiPy's semantics); an instant
        # source passes this step's output
        fb_readers = {u: getattr(node_of(u), "_make_out_reader", lambda: None)()
                      for u in fb_sources}

        def step(state, params, x):
            nodes_st = dict(state["nodes"])
            edges_st = dict(state["edges"])
            fb_prev = state.get("fb", {})
            outs = {}
            cache, fb_cache = {}, {}
            for n in order:
                if preds[n]:
                    inp = None
                    for u in preds[n]:
                        k = _ekey(u, n)
                        src = outs[u] if source is None else source(u, n, outs[u], cache)
                        es, val = edge_steps[(u, n)](edges_st[k], params["edges"][k], src)
                        edges_st[k] = es
                        inp = val if inp is None else inp + val  # fan-in sum
                else:
                    inp = x
                for u in fb_by_target.get(n, ()):
                    k = _ekey(u, n)
                    src = fb_prev[u] if source is None else source(u, n, fb_prev[u], fb_cache)
                    es, val = fb_steps[(u, n)](edges_st[k], params["edges"][k], src)
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
            return new_state, outs[out_node], {t: outs[t] if tap is None else tap(t, outs[t], cache)
                                               for t in taps}

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

    def _prep_params(self, params: dict, shard=None) -> dict:
        """Once-per-run parameter prep of each node (the quantization of a
        master coupling, the packing of a frozen int4 one, ``nodes.py``
        ``prep_params``) and each edge (the delay matrix's selectors,
        ``edges.py`` ``LinearMemoryMatrix.prep_params``), applied before the
        time loop of ``run``, so it costs one pass per run, not per step.
        The training paths take the edge prep alone (``_prep_edge_params``):
        the trajectories prep their nodes inside, and plain autograd needs
        the per-step STE matvec."""
        nodes, changed = {}, False
        get_node = self.get_node if shard is None else shard.node
        for n, sub in params["nodes"].items():
            prep = getattr(get_node(n), "prep_params", None)
            nodes[n] = prep(sub) if prep is not None else sub
            changed = changed or nodes[n] is not sub
        params = self._prep_edge_params(params, shard)
        return {**params, "nodes": nodes} if changed else params

    def _prep_edge_params(self, params: dict, shard=None) -> dict:
        """The edges' prep alone, safe inside a differentiated loss: the
        selectors of an ``interp`` delay matrix derive from its trainable
        delays, so the prep must run inside the autograd graph for the
        delays to get their gradient; once per epoch, chunk or minibatch,
        never per step.  A swept ``delays`` (``(B, n_out, n_in)``) is
        prepped per trial.  ``shard`` (``parallel/``): a population
        shard's edges, whose selectors are built from their own rows."""
        edges, changed = {}, False
        get_edge = self.get_edge if shard is None else shard.edge
        for k, sub in params["edges"].items():
            prep = getattr(get_edge(*k.split("->")), "prep_params", None)
            edges[k] = prep(sub) if prep is not None else sub
            changed = changed or edges[k] is not sub
        return {**params, "edges": edges} if changed else params

    def _mesh_shard(self, mesh):
        """The network as this rank runs it on ``mesh`` (a
        ``torch.distributed`` ``DeviceMesh``): ``parallel.sharding.
        NetworkShard``."""
        from .parallel.sharding import NetworkShard

        return NetworkShard(self, mesh)

    def _fit_shard(self, mesh, data: bool = False):
        """A trainer's shard of the network on ``mesh``, or None where the
        mesh cuts nothing the trainer uses (no population on a model axis of
        one rank, and no data axis, or a trainer that puts nothing on it):
        the fit without a mesh is then the mesh fit, bit for bit."""
        if mesh is None:
            return None
        shard = self._mesh_shard(mesh)
        return shard if shard.rows or (data and shard.n_data > 1) else None

    def _mesh_place(self, tree: dict, mesh, model_axis: str = "model") -> dict:
        """This rank's part of a state/params tree on ``mesh``: node leaves
        sharded on the node's own size (each variable's rows of its flat
        state), the row parameters of an edge by its target's rows, the
        carried feedback outputs by their source's rows; an edge's state
        (source side), and every leaf of a node that runs whole, whole."""
        from .parallel.sharding import NetworkShard

        return NetworkShard(self, mesh, model_axis).place(tree)

    @staticmethod
    def _mesh_replicate(x, mesh):
        """``x`` as every rank holds it: the same tensor (SPMD)."""
        del mesh
        return x

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

    def _resolve_record_vars(self, obs: Observer, shard=None) -> list:
        """[(record key, node label, reader fn, reduce flag)] for recording;
        ``shard`` (``parallel/``): read from the shard's local nodes."""
        resolved = []
        get_node = self.get_node if shard is None else shard.node
        for (node_label, var), reduce in zip(obs.recorded_state_variables, obs.reduce_flags):
            node = get_node(node_label)
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

    def _resolve_record_spikes(self, labels, shard=None) -> tuple:
        """``record_spikes=[node, ...]`` as ``((label, reader), ...)``: the
        spiking nodes' spike readers (``SpikeNet``, ``SpikeResetNet``,
        ``MultiSpikeResetNet``); any other node raises ``ValueError``."""
        info = []
        get_node = self.get_node if shard is None else shard.node
        for label in labels or ():
            node = get_node(label)
            if not hasattr(node, "_make_spike_reader"):
                raise ValueError(
                    f"record_spikes: node {label!r} ({type(node).__name__}) is not "
                    "a spiking node; spike rasters exist for SpikeNet / "
                    "SpikeResetNet / MultiSpikeResetNet populations.")
            info.append((label, node._make_spike_reader()))
        return tuple(info)

    def run(self, inputs, sampling_steps: int = 1, cutoff: int = 0, verbose: bool = True,
            enable_grad: bool = True, **kwargs) -> Observer:
        """Integrate the input-driven network equations.

        ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``,
        ``parallel.make_mesh``): every rank of the mesh calls ``run`` with the
        same inputs; the populations shard over the mesh's ``model`` axis
        (``parallel/``: each rank steps its rows after a gather of each
        coupling's source).  The records, identical on every rank, and the
        state written back are those of the run without a mesh.

        Recording semantics are those of the JAX package's ``run``: step 0
        is a record of its own; then come full windows of ``sampling_steps``
        steps, each recording the mean output over its steps with
        ``step >= cutoff`` and ``record_vars`` read from the state after the
        window's last step (``reduce=True`` records the population mean);
        the steps after the last full window are integrated but not
        recorded.  ``inputs`` is a ``(T, m)`` array with ``m`` the input
        width or 1 (broadcast), or an unbatched input spec
        (``rectipy_tpu_torch.inputs``), evaluated on the network's device a
        chunk of steps at a time.

        ``record_spikes=[node, ...]`` records each spiking node's spike
        counts per window, ``(node, "spikes")``: the spike decision of every
        step with ``step >= cutoff``, read from the state before the step,
        summed in float32 over the window's steps (step 0 is a window of its
        own) and returned as int32.

        The loop runs without autograd (``enable_grad`` is accepted and
        ignored, as in the JAX package: gradients belong to the trainers).
        So ``truncate_steps`` (the JAX package cuts the gradient of its
        generic scan every ``truncate_steps`` steps) has no gradient to cut:
        it is checked and the records are those of the run without it, as
        in the JAX package.
        """
        del enable_grad
        mesh = kwargs.pop("mesh", None)
        spike_labels = kwargs.pop("record_spikes", None)
        if isinstance(inputs, InputSpec):
            if inputs.batch is not None:
                raise ValueError(
                    "run() takes an unbatched input spec; a spec with per-trial "
                    "parameters (e.g. Noise with (B,) seeds) goes to run_batch().")
            xs = inputs.drive(self.dt, self.dtype, self.device)
            steps, n_chan = int(inputs.steps), int(inputs.channels)
        else:
            inputs = self._to_device(inputs)
            if inputs.ndim != 2:
                raise ValueError(
                    f"`inputs` must be a (T, m) array; got shape {tuple(inputs.shape)}")
            xs = inputs.unbind(0)
            steps, n_chan = int(inputs.shape[0]), int(inputs.shape[1])
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
        shard = None if mesh is None else self._mesh_shard(mesh)
        spike_info = self._resolve_record_spikes(spike_labels, shard)
        rec_info = self._resolve_record_vars(obs, shard)
        with torch.no_grad():
            if shard is None:
                state, rec0, recs = self._run_windowed(
                    *self.step_args(), xs, s, cutoff, rec_info, obs.record_output,
                    spike_info=spike_info)
            else:
                state, rec0, recs = self._run_windowed(
                    *shard.step_args(), shard.inputs(xs), s, cutoff, _unreduced(rec_info),
                    obs.record_output, spike_info=spike_info)
                state = shard.gather_state(state)
                rec0, recs = shard.records(rec0, recs, rec_info, spike_info, obs.record_output)
        self._write_back(state)

        rec_steps_all = [t for t in range(steps) if t % s == 0]
        outs, rec_vars = self._assemble_windowed_records(
            rec0, recs, rec_info, obs.record_output, rec_steps_all, cutoff,
            spike_info=spike_info)
        rec_steps = np.asarray([t for t in rec_steps_all if t >= cutoff], dtype=np.int64)
        obs.record_batch(rec_steps, outputs=None if outs is None else _host(outs),
                         losses=np.zeros(len(rec_steps)) if obs.record_loss else None,
                         var_values={k: _host(v) for k, v in rec_vars.items()})
        if verbose:
            print(f"Progress: {steps}/{steps} integration steps finished.")
        return obs

    def step_args(self, B: int = None, batch_vars: dict = None) -> tuple:
        """``(step, state, params)``: the step function, the start states and
        the prepped parameters that :meth:`run` (``B`` None: one trial) or
        :meth:`run_batch` (``B`` trials under ``batch_vars``: ``(B, ...)``
        states, each trial's swept values spliced in) advances, from the
        network's current state.  The runs call it under ``torch.no_grad()``;
        anything that times their step takes its arguments from here."""
        params = self.parameters_pytree()
        if B is None:
            return self.make_step(), self.init_state(), self._prep_params(params)
        sweeps = self._resolve_batch_vars("run_batch", batch_vars, B, params, trainer=False)
        return (self.make_step(), self._batch_state(self.init_state(), B),
                self._prep_params(self._with_sweeps(params, sweeps)))

    def _run_windowed(self, step, state, params, xs, s, cutoff, rec_info, record_output,
                      batched: bool = False, spike_info: tuple = ()):
        """The run loop of ``step`` over the per-step inputs ``xs`` (a
        sequence: ``len(xs)`` steps, ``xs[t]`` step ``t``'s input).  Returns
        the final state, the step-0 record and the window records, on the
        device; nothing in the loop synchronises with the host.
        ``batched``: the states carry a leading trial axis; a reduced record
        is each trial's population mean and the window records stack along
        axis 1, ``(B, R, ...)``.  ``spike_info`` (``_resolve_record_spikes``):
        each node's spike indicators, read before each step, masked by
        ``step >= cutoff`` and summed in float32 over the window (a bfloat16
        sum stops counting at 256)."""
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

        def read_spikes(state):
            return [reader(state["nodes"][label]).to(torch.float32)
                    for (label, reader) in spike_info]

        # step 0: its own record window
        spk0 = read_spikes(state)
        state, out, _ = step(state, params, xs[0])
        if 0 < cutoff:
            spk0 = [torch.zeros_like(v) for v in spk0]
        out0 = (out if 0 >= cutoff else torch.zeros_like(out)) if record_output else None
        vars0 = read_vars(state)

        win_outs, win_vars, win_spk = [], [], []
        t = 1
        for _ in range(n_win):
            acc, cnt, spk = None, 0, None
            for _ in range(s):
                if spike_info and t >= cutoff:
                    ind = read_spikes(state)
                    spk = ind if spk is None else [a + v for a, v in zip(spk, ind)]
                state, out, _ = step(state, params, xs[t])
                if record_output and t >= cutoff:
                    acc = out if acc is None else acc + out
                    cnt += 1
                t += 1
            if record_output:
                win_outs.append(torch.zeros_like(out) if acc is None else acc / cnt)
            win_vars.append(read_vars(state))
            win_spk.append([torch.zeros_like(v) for v in spk0] if spk is None else spk)
        while t < steps:  # tail: integrated, not recorded
            state, _, _ = step(state, params, xs[t])
            t += 1

        rec0 = (out0, vars0, spk0)
        recs = None
        if n_win:
            recs = (torch.stack(win_outs, dim=axis) if record_output else None,
                    {k: torch.stack([w[k] for w in win_vars], dim=axis) for k in vars0},
                    [torch.stack([w[i] for w in win_spk], dim=axis)
                     for i in range(len(spike_info))])
        return state, rec0, recs

    @staticmethod
    def _assemble_windowed_records(rec0, recs, rec_info, record_output, rec_steps_all,
                                   cutoff, axis: int = 0, spike_info: tuple = ()):
        """Record assembly on the device: step 0 + window ends, those at
        ``step >= cutoff``, along record axis ``axis`` (0 single-trial, 1
        batched; the JAX package's ``_assemble_windowed_records``).  Spike
        counts come out as int32 under ``(label, "spikes")``."""
        first = sum(t < cutoff for t in rec_steps_all)  # the kept records are a suffix

        def series(r0, rs):
            parts = [r0.unsqueeze(axis)] + ([rs] if rs is not None else [])
            return torch.cat(parts, dim=axis).narrow(axis, first, len(rec_steps_all) - first)

        outs = series(rec0[0], recs[0] if recs else None) if record_output else None
        rec_vars = {}
        for (key, _, _, _) in rec_info:
            k = "var::" + "::".join(key)
            rec_vars[key] = series(rec0[1][k], recs[1][k] if recs else None)
        for i, (label, _) in enumerate(spike_info):
            counts = series(rec0[2][i], recs[2][i] if recs else None)
            rec_vars[(label, "spikes")] = torch.round(counts).to(torch.int32)
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
                extra = ("" if param != "delays" else
                         " -- integer-delay edges hold their delays as static gather "
                         "structure; build the edge with mode='interp' to expose a "
                         "sweepable/evolvable float delay matrix")
                raise KeyError(f"{name}: {param!r} is not a parameter of edge {src!r} -> "
                               f"{tgt!r} (available: {sorted(edge.params)}){extra}.")
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
        ``batch_vars`` (staged once; no ``(B, T, m)`` copy), or an input spec
        (``rectipy_tpu_torch.inputs``): one with per-trial seeds (``(B,)``,
        each trial its own stream), or an unbatched one shared by the trials
        of ``batch_vars``.  Returns ``{"steps": (R,), "out": (B, R, n_out),
        (node, var): (B, R, ...)}`` with the recording semantics of
        :meth:`run`, ``record_spikes`` included (``(node, "spikes")``: ``(B,
        R, n)`` int32 counts).

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

        ``mesh=``: the trials shard over the mesh's ``data`` axis where it
        divides ``B`` (else they run replicated, with a warning), the
        populations over ``model`` as in :meth:`run`; swept leaves go with
        their trials (and rows), a shared drive and the shared parameters are
        whole on every rank, and every rank returns the whole records.

        A fused node refuses a sweep of a parameter its kernel bakes in or
        shares (the JAX package's fused QIF kernel ignores a swept eta,
        which the port applies).
        """
        results = self._run_batch(inputs, sampling_steps, cutoff, verbose, kwargs)
        return {k: v if k == "steps" else _host(v) for k, v in results.items()}

    def _run_batch(self, inputs, sampling_steps: int, cutoff: int, verbose: bool,
                   kwargs: dict) -> dict:
        """:meth:`run_batch` with its records left on the device."""
        mesh = kwargs.pop("mesh", None)
        batch_vars = kwargs.pop("batch_vars", None)
        spike_labels = kwargs.pop("record_spikes", None)
        if isinstance(inputs, InputSpec):
            T, B = int(inputs.steps), inputs.batch
            if B is None:
                if not batch_vars:
                    raise ValueError(
                        "run_batch with an unbatched input spec needs batch_vars "
                        "(or make the spec per-trial, e.g. Noise with (B,) seeds).")
                B = int(np.shape(next(iter(batch_vars.values())))[0])
                xs = inputs.drive(self.dt, self.dtype, self.device, rows=B)
            else:
                xs = inputs.drive(self.dt, self.dtype, self.device)
            n_chan = int(inputs.channels)
        else:
            inputs = self._to_device(inputs)
            if inputs.ndim == 2 and batch_vars:
                B, T = int(np.shape(next(iter(batch_vars.values())))[0]), int(inputs.shape[0])
            elif inputs.ndim != 3:
                raise ValueError(f"run_batch expects (B, T, m) inputs -- or shared (T, m) "
                                 f"inputs with batch_vars -- got {tuple(inputs.shape)}")
            else:
                B, T = int(inputs.shape[0]), int(inputs.shape[1])
            n_chan = int(inputs.shape[-1])
            xs = ([x.expand(B, n_chan) for x in inputs.unbind(0)] if inputs.ndim == 2
                  else inputs.unbind(1))
        self.compile()
        if self.n_in and n_chan not in (1, self.n_in):
            raise ValueError(f"`inputs` has {n_chan} channels but the network input node "
                             f"{self._in_node!r} expects {self.n_in} (or 1, broadcast).")
        s = int(sampling_steps)
        if s < 1:
            raise ValueError(f"sampling_steps must be >= 1; got {sampling_steps}")
        obs = Observer(dt=self.dt, record_loss=kwargs.pop("record_loss", False), **kwargs)
        shard = None if mesh is None else self._mesh_shard(mesh)
        spike_info = self._resolve_record_spikes(spike_labels, shard)
        rec_info = self._resolve_record_vars(obs, shard)
        rec_steps_all = [t for t in range(T) if t % s == 0]
        results = {"steps": np.asarray([t for t in rec_steps_all if t >= cutoff],
                                       dtype=np.int64)}
        with torch.no_grad():
            if shard is None:
                _, rec0, recs = self._run_windowed(*self.step_args(B, batch_vars), xs, s,
                                                   cutoff, rec_info, obs.record_output,
                                                   batched=True, spike_info=spike_info)
            else:
                _, rec0, recs = self._run_windowed(
                    *shard.step_args(B, batch_vars), shard.inputs(xs, B), s, cutoff,
                    _unreduced(rec_info), obs.record_output, batched=True,
                    spike_info=spike_info)
                rec0, recs = shard.records(rec0, recs, rec_info, spike_info,
                                           obs.record_output, B)
        outs, rec_vars = self._assemble_windowed_records(
            rec0, recs, rec_info, obs.record_output, rec_steps_all, cutoff, axis=1,
            spike_info=spike_info)
        if outs is not None:
            results["out"] = outs
        results.update(rec_vars)
        if verbose:
            print(f"Progress: {B} trials x {T} steps finished.")
        return results

    def detach(self, requires_grad: bool = True, detach_params: bool = False) -> None:
        """Cut every node state out of any autograd graph it belongs to."""
        for node in self.nodes:
            n = self.get_node(node)
            if hasattr(n, "y"):
                n.detach(requires_grad=requires_grad, detach_params=detach_params)

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

        ``fused_bptt`` (default ``'auto'``) picks the trajectory as the JAX
        package does: chain networks ``[instants] -> population ->
        [instants]`` train through the deferred-gradient trajectory of
        ``ops/bptt.py`` (the stateless pre/post stages run outside the time
        loop, as one batched product each); other networks of DSL-built
        populations and linear-family edges (feedback networks,
        multi-population circuits, stateful and block-sparse edges) through
        the graph trajectory of ``ops/graph_bptt.py``; anything else, and
        step mode with ``record_vars``, takes plain autograd through
        ``make_step``.  ``True`` raises where neither trajectory applies;
        ``False`` always takes plain autograd.  ``net.last_fit`` says which
        (``"chain"``, ``"graph"`` or ``"autograd"``).

        ``remat_steps=k`` (epoch mode) checkpoints the trajectory in k-step
        chunks: the forward keeps the carry at each chunk's start only, and
        the backward recomputes one chunk at a time (the population
        trajectory is Euler-only here; a Heun node takes the graph
        trajectory).  A ``k`` that does not divide ``T`` sends ``'auto'`` to
        plain autograd, which checkpoints ``k``-step segments with
        ``torch.utils.checkpoint`` where they divide ``T``, as the JAX
        package does with ``jax.checkpoint``.  Step mode ignores it, as the
        JAX package's does.

        ``RECTIPY_FUSED_ADAM`` picks the optimizer tail of a plain-adam
        epoch-mode fit of one trained dense ``int8_master`` coupling on a
        chain: ``off`` (default: the split optax-formula optimizer) or ``on``
        (one pass of adam + requantization through
        ``ops.fused_opt.adam_requant``, the CUDA kernel on the card).  Any
        other value raises ``ValueError``.  Step mode always takes the split
        optimizer, as the JAX package does.

        ``mesh=`` (``parallel.make_mesh``; every rank calls the fit with the
        same arguments): the populations shard over the mesh's ``model``
        axis and train through the same trajectory (``net.last_fit``) on
        their rows.  A trajectory step gathers each sharded source once and
        its backward all-reduces the source's cotangent once; each ``dW``
        contracts the shard's cotangent rows with the saved gathered
        sources; the loss takes the gathered outputs.  A quantized coupling
        or block edge takes each dynamic scale over the model group (an
        all-reduce of the maximum) and its transposed product adds the
        ranks' integer sums (one all-reduce), the unsharded product's
        numbers; diagonal gains into a shard hold their rows.  A leaf that a
        sharded node holds whole sums its gradient over ``model``.  The optimizer is
        the split one (``RECTIPY_FUSED_ADAM`` is read and not used), as the
        JAX package's mesh fits.  The trained leaves are gathered and written
        back.  A ``data`` axis replicates the one trial.
        """
        self.compile()
        loss_fn = get_loss_function(loss, loss_kwargs=loss_kwargs)
        opt = get_optimizer(optimizer, lr, optimizer_kwargs=optimizer_kwargs)
        retrieve_from_dict(["closure", "retain_graph"], kwargs)  # torch.optim-only knobs
        obs_kwargs = retrieve_from_dict(["record_output", "record_loss", "record_vars"], kwargs)
        mesh = kwargs.pop("mesh", None)
        remat_steps = int(kwargs.pop("remat_steps", 0))
        fused_bptt = kwargs.pop("fused_bptt", "auto")
        if kwargs:
            raise TypeError(f"fit_bptt() got unexpected keyword arguments {sorted(kwargs)}")
        epoch_mode = isinstance(inputs, list) or getattr(inputs, "ndim", 0) == 3
        # remat composes with the trajectories when it divides T; else 'auto'
        # takes plain autograd, which checkpoints where it can (JAX's rule)
        T0 = int(np.shape(inputs[0])[0]) if epoch_mode and len(inputs) else 0
        rk = remat_steps if (remat_steps > 1 and T0 and T0 % remat_steps == 0) else 0
        if remat_steps > 1 and rk == 0 and fused_bptt == "auto":
            fused_bptt = False
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
        shard = self._fit_shard(mesh)
        if mesh is not None:
            mode = "off"  # a mesh fit takes the split optimizer (the JAX package's rule)
        train, frozen = self._partition(self.parameters_pytree(), paths)
        train = tree_map(lambda t: t.detach(), train)
        state0 = self.init_state()
        # this rank's parts (the trees themselves without a mesh)
        place = (lambda tree: tree) if shard is None else shard.place
        whole = (lambda tree: tree) if shard is None else shard.gather_params
        train, frozen_p, state0_p = place(train), place(frozen), place(state0)
        opt_state = opt.init(train)

        if not epoch_mode:
            inputs, targets = self._to_device(inputs), self._to_device(targets)
            if inputs.shape[0] != targets.shape[0]:
                raise ValueError(
                    "Wrong dimensions of input and target output. Please make sure that "
                    "`inputs` and `targets` agree in the first dimension."
                )
            t0 = perf_counter()
            train, stateT, rec = self._bptt_steps(loss_fn, opt, train, frozen_p, opt_state,
                                                  state0_p, inputs, targets, update_steps,
                                                  sampling_steps, obs, fused_bptt, shard)
            self._write_back(state=stateT)
            obs.record_batch(rec["steps"], outputs=rec["out"], losses=rec["loss"],
                             var_values=rec["vars"])
            self._write_back(params=self._combine(whole(train), frozen))
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
            loss_fn, opt, fused_bptt, sampling_steps, fused_cfg, paths, rk, remat_steps, shard)

        def epochs(tr, os_, ins, tgts):
            return self._bptt_epochs(programs, tr, frozen_p, os_, state0_p, ins, tgts, verbose)

        # the returned Observer records the LAST epoch's run (the weights
        # after K-1 updates, from the initial state), as in the reference;
        # that extra forward runs only when recording is asked for
        if obs_kwargs.get("record_vars") or obs_kwargs.get("record_output", False):
            losses = []
            if len(inputs) > 1:
                train, opt_state, losses = epochs(train, opt_state, list(inputs[:-1]),
                                                  list(targets[:-1]))
            self._write_back(params=self._combine(whole(train), frozen))
            run_kw = {k: v for k, v in obs_kwargs.items() if k in ("record_output", "record_vars")}
            obs = self.run(inputs[-1], sampling_steps=sampling_steps, verbose=False, mesh=mesh,
                           **run_kw)
            self._write_back(state=state0)  # the reference resets per epoch
            train, opt_state, last = epochs(train, opt_state, [inputs[-1]], [targets[-1]])
            losses = list(losses) + list(last)
        else:
            train, opt_state, losses = epochs(train, opt_state, list(inputs), list(targets))
        obs.save("epoch_loss", losses)
        obs.save("epochs", np.arange(len(losses)))
        self._write_back(params=self._combine(whole(train), frozen))
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
        ``int8_master`` coupling) and one dW product over trials and time,
        other graphs through the graph trajectory with ``(B, ...)`` carries,
        and the rest through plain autograd over the batched step
        (``fused_bptt`` and ``remat_steps`` as in :meth:`fit_bptt`;
        ``net.last_fit`` says which).
        The optimizer is the split one, as in the JAX package's batch
        programs (``RECTIPY_FUSED_ADAM`` is not read).

        Returns an Observer with ``train_loss`` (one per update),
        ``epoch_loss`` (the mean over an epoch's minibatches) and
        ``epochs``.  The trained parameters are written back; the network's
        state is left unchanged.  ``mesh=``: the population shards over the
        mesh's ``model`` axis (as in :meth:`fit_bptt`) and each micro-batch's
        trials over its ``data`` axis, the losses and gradients averaged over
        the data groups; a micro-batch the axis does not divide runs
        REPLICATED, with the JAX package's warning.  A node with the generic
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
        shard = self._fit_shard(kwargs.pop("mesh", None), data=True)
        self._refuse_generic_fused()
        batch_vars = kwargs.pop("batch_vars", None)
        setup = self._batch_fit_setup("fit_bptt_batch", inputs, targets, batch_size, loss,
                                      shuffle, seed, n_epochs, kwargs)
        params = self.parameters_pytree()
        sweeps = self._resolve_batch_vars("fit_bptt_batch", batch_vars, setup.B, params)
        train, frozen = self._partition(params, paths)
        train = tree_map(lambda t: t.detach(), train)
        state0, frozen_p, share, reduce = self.init_state(), frozen, None, None
        q = setup.mb // setup.accum
        if shard is not None:
            train, frozen_p, state0 = shard.place(train), shard.place(frozen), shard.place(state0)
            sweeps = shard.sweep_rows(sweeps)
            share = shard.data_share(q, "fit_bptt_batch: the trials of a micro-batch")
            split = share != (0, q)

            def reduce(lval, grads):
                grads = shard.reduce_grads(grads)
                if split:  # each group's mean over its equal share of the trials
                    lval, grads = shard.data_mean(lval), tree_map(shard.data_mean, grads)
                return lval, grads
            q = share[1] - share[0]
        opt_state = opt.init(train)
        batch_loss, pack, self.last_fit = self._build_batch_programs(
            loss_fn, sampling_steps, setup.fused_bptt, setup.rk, setup.remat_steps, shard)
        y0 = pack(state0, q)

        t0 = perf_counter()
        losses = []
        perms = torch.as_tensor(setup.perms, device=self.device)
        for epoch in range(setup.epochs):
            for u in range(setup.n_mb):
                micro = self._micro_batches(setup, frozen_p, sweeps, perms[epoch], u, share)
                train, opt_state, lval = _minibatch_update(batch_loss, opt, train, opt_state,
                                                           y0, micro, reduce)
                losses.append(lval)  # stays on the device until the end
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
        if shard is not None:
            train = shard.gather_params(train)
        self._write_back(params=self._combine(train, frozen))
        if verbose:
            print(f"Finished optimization after {perf_counter() - t0} s.")
        return obs

    def fit_bptt_multistart(self, inputs, targets, n_starts: int = 8, start_inits: dict = None,
                            init_scale: float = 0.1, n_epochs: int = 1, batch_size: int = None,
                            optimizer: str = "adam", optimizer_kwargs: dict = None,
                            loss: str = "mse", loss_kwargs: dict = None, lr: float = 1e-3,
                            sampling_steps: int = 1, shuffle: bool = True, seed: int = 0,
                            verbose: bool = True, **kwargs) -> Observer:
        """Multi-start BPTT: train ``n_starts`` independently initialised
        copies of the network's trained parameters on the same trials, then
        keep the best (the JAX package's ``fit_bptt_multistart``).

        ``inputs``/``targets``/``batch_size``/``shuffle``/``accum_steps``/
        ``batch_vars`` as in :meth:`fit_bptt_batch`; the per-trial frozen
        values are shared by every start.  ``start_inits`` maps ``(node,
        param)`` (or an exact trainable path ``(kind, label, key)``) to an
        ``(n_starts, ...)`` array of initial values; a trainable leaf not
        listed starts at its current value for start 0 and at ``leaf +
        init_scale * std(leaf) * eps`` for the others, ``eps`` the standard
        normal draws of ``numpy.random.default_rng(seed + 1)`` (the JAX
        package's draws, in its order of the leaves).

        Every start has its own trained parameters and optimizer state.  The
        loop runs epoch, then minibatch, then start: each start takes
        exactly the update of :meth:`fit_bptt_batch` on the minibatch, so an
        ``int8_master`` coupling launches ``int8_mm``/``int8_mm_t`` once per
        start per step on the card.  ``verbose`` reads the starts' epoch
        losses once per epoch; otherwise nothing crosses to the host before
        the end.

        Returns an Observer with ``epoch_loss`` (the best start's),
        ``start_epoch_loss`` (``(epochs, n_starts)``), ``start_final_loss``,
        ``best_start`` and ``epochs``.  The best start with a finite final
        loss is written back.  ``mesh=``: the population shards over the
        mesh's ``model`` axis and the starts over its ``data`` axis (each
        data group updates its share of the starts on every trial; the
        losses are gathered once at the end, and the best start's trees
        reach every group with one all-reduce a leaf); starts the axis does
        not divide run REPLICATED, with the JAX package's warning.  A node
        with the generic fused step raises, as in :meth:`fit_bptt_batch`.
        """
        self.compile()
        loss_fn = get_loss_function(loss, loss_kwargs=loss_kwargs)
        opt = get_optimizer(optimizer, lr, optimizer_kwargs=optimizer_kwargs)
        obs = Observer(dt=self.dt, **retrieve_from_dict(["record_loss"], kwargs))
        mesh = kwargs.pop("mesh", None)
        paths = self.trainable_paths()
        if not paths:
            raise ValueError("No trainable parameters in the network; pass `train_params` "
                             "to add_diffeq_node or train='gd' to add_edge.")
        M = int(n_starts)
        if M < 1:
            raise ValueError(f"n_starts={M} must be >= 1")
        self._refuse_generic_fused()
        batch_vars = kwargs.pop("batch_vars", None)
        setup = self._batch_fit_setup("fit_bptt_multistart", inputs, targets, batch_size, loss,
                                      shuffle, seed, n_epochs, kwargs)
        params = self.parameters_pytree()
        sweeps = self._resolve_batch_vars("fit_bptt_multistart", batch_vars, setup.B, params)
        train, frozen = self._partition(params, paths)
        starts = self._start_trees(train, paths, M, start_inits, init_scale, seed)
        shard = self._fit_shard(mesh, data=True)
        state0, frozen_p, m0, m1, reduce = self.init_state(), frozen, 0, M, None
        if shard is not None:
            m0, m1 = shard.data_share(M, "fit_bptt_multistart: the starts")
            starts = [shard.place(t) for t in starts[m0:m1]]
            frozen_p, state0 = shard.place(frozen), shard.place(state0)
            sweeps = shard.sweep_rows(sweeps)

            def reduce(lval, grads):
                return lval, shard.reduce_grads(grads)
        split = (m0, m1) != (0, M)

        def all_starts(x):  # (local starts, ...) -> (M, ...)
            return shard.data_gather(x) if split else x

        opt_states = [opt.init(t) for t in starts]
        batch_loss, pack, self.last_fit = self._build_batch_programs(
            loss_fn, sampling_steps, setup.fused_bptt, setup.rk, setup.remat_steps, shard)
        y0 = pack(state0, setup.mb // setup.accum)

        t0 = perf_counter()
        E, n_mb = setup.epochs, setup.n_mb
        losses = [[] for _ in starts]
        perms = torch.as_tensor(setup.perms, device=self.device)
        for epoch in range(E):
            for u in range(n_mb):
                micro = self._micro_batches(setup, frozen_p, sweeps, perms[epoch], u)
                for m in range(len(starts)):  # independent starts: any order is the same
                    starts[m], opt_states[m], lval = _minibatch_update(
                        batch_loss, opt, starts[m], opt_states[m], y0, micro, reduce)
                    losses[m].append(lval)  # stays on the device until the end
            if verbose:
                ep = _host(all_starts(torch.stack([torch.stack(lm[-n_mb:]).mean()
                                                   for lm in losses])))
                b = _best_start(ep)
                print(f"Progress: {epoch + 1}/{E} training epochs finished.")
                print(f"Best-start epoch loss: {float(ep[b])} (start {b}).")
                print("")
        host = (_host(all_starts(torch.stack([torch.stack(lm) for lm in losses]))) if E
                else np.zeros((M, 0)))
        per_epoch = host.reshape(M, E, n_mb).mean(axis=2).T  # (E, M)
        final = per_epoch[-1] if E else np.zeros(M)
        best = _best_start(final) if E else 0
        obs.save("epoch_loss", list(per_epoch[:, best]))
        obs.save("start_epoch_loss", [per_epoch[ep] for ep in range(E)])
        obs.save("start_final_loss", list(final))
        obs.save("best_start", [best])
        obs.save("epochs", np.arange(E))
        # the data group that holds the best start hands it to the others
        won = (shard.data_pick(starts[best % (m1 - m0)], best // (m1 - m0)) if split
               else starts[best])
        if shard is not None:
            won = shard.gather_params(won)
        self._write_back(params=self._combine(won, frozen))
        if verbose:
            print(f"Finished optimization after {perf_counter() - t0} s (best start: {best}).")
        return obs

    def _start_trees(self, train: dict, paths: list, M: int, start_inits, init_scale: float,
                     seed: int) -> list:
        """The ``M`` starts' trained trees of :meth:`fit_bptt_multistart`:
        ``start_inits`` resolved to trainable paths, the other leaves
        perturbed as the JAX package perturbs them (one numpy stream over
        the leaves in the train tree's order; float32 ``eps``, scaled by
        ``float32(init_scale * std)``, added in the leaf's dtype)."""
        inits = {}
        for k, vals in (start_inits or {}).items():
            if len(k) == 3 and k[0] in ("nodes", "edges"):
                path = tuple(k)
            else:
                nlabel, var = k
                node = self.get_node(nlabel)
                try:
                    path = ("nodes", nlabel, node._param_map[self._relabel_var(var)])
                except (AttributeError, KeyError):
                    raise KeyError(f"start_inits: {var!r} is not a parameter of node "
                                   f"{nlabel!r}.")
            if path not in paths:
                raise KeyError(f"start_inits: {path} is not a trainable path "
                               f"(trainable: {paths}).")
            inits[path] = vals
        rng = np.random.default_rng(seed + 1)
        leaves = {}
        for kind, by_label in train.items():
            for label, sub in by_label.items():
                for key, leaf in sub.items():
                    leaf, path = leaf.detach(), (kind, label, key)
                    shape = tuple(leaf.shape)
                    given = inits.get(path)
                    if given is not None:
                        given = (given if isinstance(given, torch.Tensor)
                                 else torch.as_tensor(np.asarray(given)))
                        given = given.to(device=leaf.device, dtype=leaf.dtype)
                        if tuple(given.shape) != (M,) + shape:
                            raise ValueError(f"start_inits[{path}]: expected shape "
                                             f"{(M,) + shape}, got {tuple(given.shape)}")
                        leaves[path] = list(given.unbind(0))
                        continue
                    std = float(np.std(leaf.to(torch.float64).cpu().numpy())) or 1.0
                    eps = np.empty((M,) + shape, dtype=np.float32)
                    eps[0] = 0.0  # start 0 is the current network
                    for m in range(1, M):
                        eps[m] = rng.standard_normal(shape)
                    eps *= np.float32(init_scale * std)
                    leaves[path] = [leaf + torch.as_tensor(e).to(device=leaf.device,
                                                                 dtype=leaf.dtype) for e in eps]
        return [_unflatten(list(leaves), [v[m] for v in leaves.values()]) for m in range(M)]

    def fit_es(self, inputs, targets, fit_vars, n_generations: int = 50, pop_size: int = 16,
               sigma: float = 0.1, lr: float = 0.05, loss="mse", loss_kwargs: dict = None,
               sampling_steps: int = 1, cutoff: int = 0, antithetic: bool = True,
               rank_shaping: bool = True, sigma_decay: float = 1.0, bounds: dict = None,
               record_spikes=None, objective_key="out", seed: int = 0, verbose: bool = True,
               **kwargs) -> Observer:
        """Gradient-free parameter fitting by evolution strategies (the JAX
        package's ``fit_es``: OpenAI-ES / NES).

        Each generation simulates the candidates ``theta + sigma * eps_b``
        (``pop_size`` of them, in antithetic +/- pairs when ``antithetic``;
        ``eps`` from ``numpy.random.default_rng(seed)``, clipped to
        ``bounds``) as one :meth:`run_batch` from the network's current state,
        scores each on the recorded ``objective_key`` series (``"out"``, or
        ``(node, "spikes")`` with ``record_spikes=[node]``), and moves
        ``theta`` by ``lr / (pop_size * sigma) * sum_b u_b eps_b``, ``u`` the
        centred ranks of the negated losses (``rank_shaping``) or their
        z-scores.  ``sigma`` is multiplied by ``sigma_decay`` each
        generation; a generation without a finite loss is skipped.

        ``fit_vars``: ``(node, var)`` node parameters (scalar or per-neuron)
        and ``("edge", source, target, param)`` edge parameters (a coupling,
        the float delay matrix of a ``mode='interp'`` edge, a mask), the keys
        :meth:`run_batch` sweeps.  ``inputs``: a shared ``(T, m)`` array
        (staged once) or an unbatched input spec.  ``loss``: a registry name,
        whose candidates are scored on the device with one transfer of the
        losses a generation, or a callable ``(out_b, targets) -> scalar`` on
        host numpy arrays.

        Returns an Observer with per-generation ``es_mean_loss``,
        ``es_best_loss`` and ``es_sigma``, ``es_best_ever_loss``,
        ``es_best_candidate``, ``es_search_point_loss`` (one more ``B=1``
        run of the final search point) and ``es_final_loss``, the score of
        what is written back: the better of the search point and the best
        candidate (``es_returned``).  The write-back refreshes a fused
        kernel's copies; the network state is left unchanged.  On a fused QIF
        node a swept ``eta`` reaches the kernel (the JAX package's fused
        kernel ignores it and scores identical candidates).  ``mesh=``: each
        generation is one ``run_batch(mesh=)`` (the candidates over the
        mesh's ``data`` axis, the population over its ``model`` axis); every
        rank draws the same ``eps`` and makes the same update, and the final
        ``B=1`` run of the search point runs unsharded on every rank, as the
        JAX package's does.
        """
        mesh = kwargs.pop("mesh", None)
        if self._fit_shard(mesh, data=True) is None:  # a mesh that cuts nothing: no mesh
            mesh = None
        if kwargs:
            raise TypeError(f"fit_es() got unexpected keyword arguments {sorted(kwargs)}")
        B = int(pop_size)
        if B < 2:
            raise ValueError("fit_es needs pop_size >= 2.")
        if antithetic and B % 2:
            raise ValueError("antithetic sampling needs an even pop_size.")
        if not fit_vars:
            raise ValueError("fit_vars must name at least one (node, var) parameter to evolve.")
        fit_vars = [tuple(v) for v in fit_vars]
        paths = {key: self._sweep_path("fit_es", key) for key in fit_vars}  # fail early
        if isinstance(objective_key, (list, tuple)):
            objective_key = tuple(objective_key)
        if callable(loss):
            loss_fn = (loss if not loss_kwargs
                       else (lambda p, t, f=loss: f(p, t, **loss_kwargs)))
        else:
            loss_fn = get_loss_function(loss, loss_kwargs=loss_kwargs)
        self.compile()
        targets = np.asarray(targets)
        es_losses = self._es_losses(loss_fn, not callable(loss), targets)
        rng = np.random.default_rng(seed)
        theta = {key: self._fit_var(paths[key]).to(torch.float64).cpu().numpy()
                 for key in fit_vars}
        bounds = {tuple(k): (float(lo), float(hi)) for k, (lo, hi) in (bounds or {}).items()}
        for key in bounds:
            if key not in theta:
                raise ValueError(f"bounds key {key} is not in fit_vars.")

        def clip(key, val):
            if key in bounds:
                lo, hi = bounds[key]
                return np.clip(val, lo, hi)
            return val

        theta = {k: clip(k, v) for k, v in theta.items()}
        if isinstance(inputs, InputSpec):
            if inputs.batch is not None:
                raise ValueError(
                    "fit_es needs an UNBATCHED input spec shared across candidates "
                    "(per-trial streams would randomize the objective per candidate and "
                    "break the final B=1 evaluation).")
        else:
            if np.ndim(inputs) != 2:
                raise ValueError(f"fit_es expects shared (T, m) inputs; got {np.shape(inputs)}")
            inputs = self._to_device(inputs)  # staged once for every generation

        def run(cands: dict, mesh=None) -> torch.Tensor:
            results = self._run_batch(inputs, sampling_steps, cutoff, False, dict(
                batch_vars=cands, record_spikes=record_spikes,
                record_output=objective_key == "out", mesh=mesh))
            if objective_key not in results:
                raise KeyError(
                    f"objective_key {objective_key!r} is not a recorded series (available: "
                    f"{sorted(repr(k) for k in results if k != 'steps')}); spike objectives "
                    "need record_spikes=[node] and objective_key=(node, 'spikes').")
            return results[objective_key]

        obs = Observer(dt=self.dt, record_output=False, record_loss=False)
        t0 = perf_counter()
        half = B // 2
        best_ever = (np.inf, None)
        mean_hist, best_hist, sigma_hist = [], [], []
        sig = float(sigma)
        for gen in range(int(n_generations)):
            eps, cands = {}, {}
            for key, val in theta.items():
                if antithetic:
                    e = rng.standard_normal((half,) + val.shape)
                    e = np.concatenate([e, -e], axis=0)
                else:
                    e = rng.standard_normal((B,) + val.shape)
                eps[key] = e
                cands[key] = clip(key, val[None] + sig * e)
            out = run(cands, mesh)  # (B, R, ...) on the device
            if gen == 0 and targets.shape not in ((out.shape[1],), tuple(out.shape[1:])):
                try:
                    np.broadcast_shapes(targets.shape, tuple(out.shape[1:]))
                except ValueError:
                    raise ValueError(
                        f"targets of shape {targets.shape} do not broadcast against the "
                        f"recorded output {tuple(out.shape[1:])} (records x n_out).")
            losses = es_losses(out)
            finite = np.isfinite(losses)
            if not finite.any():
                # a whole diverged generation: skip the update; the best
                # candidate so far survives
                mean_hist.append(float("nan"))
                best_hist.append(float("nan"))
                sigma_hist.append(sig)
                sig *= float(sigma_decay)
                if verbose:
                    print(f"ES generation {gen}: all {B} candidates non-finite; update skipped")
                continue
            gen_best = int(np.argmin(np.where(finite, losses, np.inf)))
            if losses[gen_best] < best_ever[0]:
                best_ever = (float(losses[gen_best]),
                             {k: np.array(c[gen_best]) for k, c in cands.items()})
            scores = np.where(finite, -losses, -np.inf)
            if rank_shaping:
                order = np.argsort(np.argsort(scores))  # rank 0 = worst
                u = order / (B - 1) - 0.5
            else:
                s_f = scores[finite]
                std = s_f.std() + 1e-12
                u = np.where(finite, (scores - s_f.mean()) / std, 0.0)
                u = np.where(np.isfinite(u), u, 0.0)
            for key in theta:
                g = np.tensordot(u, eps[key], axes=(0, 0)) / (B * sig)
                theta[key] = clip(key, theta[key] + lr * g)
            mean_hist.append(float(np.nanmean(np.where(finite, losses, np.nan))))
            best_hist.append(float(losses[gen_best]))
            sigma_hist.append(sig)
            sig *= float(sigma_decay)
            if verbose and (gen % max(1, n_generations // 10) == 0
                            or gen == n_generations - 1):
                print(f"ES generation {gen}: best {best_hist[-1]:.6g}, "
                      f"mean {mean_hist[-1]:.6g}, sigma {sig:.4g}")

        # the final search point's own score: one more run of one trial (the
        # network state stays untouched, so no plain run())
        search_loss = float(es_losses(run({k: np.asarray(v)[None]
                                           for k, v in theta.items()}))[0])
        if best_ever[1] is not None and best_ever[0] < search_loss:
            fitted, final_loss, returned = best_ever[1], best_ever[0], "best_candidate"
        else:
            fitted, final_loss, returned = theta, search_loss, "search_point"
        for key, val in fitted.items():
            self._set_fit_var(paths[key], val)
        obs.save("es_returned", returned)
        obs.save("es_search_point_loss", search_loss)
        obs.save("generations", np.arange(len(mean_hist)))
        obs.save("es_mean_loss", np.asarray(mean_hist))
        obs.save("es_best_loss", np.asarray(best_hist))
        obs.save("es_sigma", np.asarray(sigma_hist))
        obs.save("es_best_ever_loss", best_ever[0])
        obs.save("es_best_candidate", best_ever[1])
        obs.save("es_final_loss", final_loss)
        if verbose:
            print(f"Finished evolution-strategies optimization after {perf_counter() - t0} s.")
        return obs

    def _es_losses(self, loss_fn, registry_loss: bool, targets: np.ndarray) -> Callable:
        """``losses(out)``: the per-candidate losses of :meth:`fit_es`'s
        ``(B, R, ...)`` device records as float64 numpy.  A registry loss
        scores every candidate on the device (integer spike counts and the
        targets promoted to a common float type) and crosses to the host once;
        a callable runs on host numpy, candidate by candidate."""
        if not registry_loss:
            def losses(out):
                out = _host(out)
                return np.asarray([float(loss_fn(out[b], targets)) for b in range(out.shape[0])])
            return losses
        tgt = torch.as_tensor(np.ascontiguousarray(targets))

        def losses(out):
            dtype = torch.promote_types(out.dtype, tgt.dtype)
            dtype = dtype if dtype.is_floating_point else self.dtype
            x, t = out.to(dtype), tgt.to(device=out.device, dtype=dtype)
            vals = torch.stack([loss_fn(x[b], t) for b in range(x.shape[0])])
            return _host(vals).astype(np.float64)
        return losses

    def _fit_var(self, path: tuple) -> torch.Tensor:
        """The parameter at a params-tree path (``_sweep_path``'s)."""
        sec, label, key = path
        if sec == "nodes":
            return self.get_node(label)._args[key]
        return self.get_edge(*label.split("->")).params[key]

    def _set_fit_var(self, path: tuple, val):
        """Write ``val`` to the parameter at ``path``, in its shape, dtype and
        device; a node with a fused kernel refreshes the kernel's copy."""
        sec, label, key = path
        cur = self._fit_var(path)
        new = torch.as_tensor(np.asarray(val)).to(device=cur.device, dtype=cur.dtype)
        new = new.reshape(cur.shape)
        if sec == "nodes":
            node = self.get_node(label)
            node._args[key] = new
            if getattr(node, "_fused_attached", False):
                node._refresh_fused_param(key)
        else:
            self.get_edge(*label.split("->")).params[key] = new

    def _micro_batches(self, setup: SimpleNamespace, frozen: dict, sweeps: dict, perm,
                       u: int, share: tuple = None) -> list:
        """The ``accum`` equal micro-batches of minibatch ``u`` of the trial
        permutation ``perm``: ``[(frozen, xs, targets)]``, the frozen
        parameters with the micro-batch's swept values, its time-major
        inputs and its targets (the whole staged arrays, uncopied, when the
        micro-batch is every trial in order).  ``share``: this data group's
        trials ``[q0, q1)`` of each micro-batch."""
        mb, accum = setup.mb, setup.accum
        ids = perm[u * mb:(u + 1) * mb]
        micro = []
        for a in range(accum):
            sub = ids[a * (mb // accum):(a + 1) * (mb // accum)]
            if share is not None:
                sub = sub[share[0]:share[1]]
            full = sub.shape[0] == setup.B and not setup.shuffled
            xs = setup.inputs if full else setup.inputs.index_select(1, sub)
            tgt = setup.targets if full else setup.targets.index_select(0, sub)
            fz = self._with_sweeps(frozen, {p: (v if full else v.index_select(0, sub))
                                            for p, v in sweeps.items()})
            micro.append((fz, xs, tgt))
        return micro

    def _resolve_batch_vars(self, name: str, batch_vars, B: int, params: dict,
                            trainer: bool = True) -> dict:
        """``batch_vars`` as ``{path: (B, ...) device tensor}`` (``(B,)``
        values as ``(B, 1)``).  The trainers take per-trial overrides of
        FROZEN parameters, ``(B,)`` or ``(B,) + leaf.shape``; a trainable
        path raises (per-start trained values are ``fit_bptt_multistart``'s
        ``start_inits``).  ``run_batch`` (``trainer=False``) sweeps
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
        remat_steps = int(kwargs.pop("remat_steps", 0))
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
        rk = remat_steps if (remat_steps > 1 and T % remat_steps == 0) else 0
        if remat_steps > 1 and rk == 0 and fused_bptt == "auto":
            fused_bptt = False  # T not divisible: plain autograd takes the remat request
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
            shuffled=shuffled, fused_bptt=fused_bptt, rk=rk, remat_steps=remat_steps, epochs=E,
            perms=np.array(perms, dtype=np.int64))

    def _build_batch_programs(self, loss_fn, sampling_steps: int, fused_bptt, rk: int = 0,
                              remat_steps: int = 0, shard=None) -> tuple:
        """``(batch_loss, pack, info)`` of the batched-trial trainers:
        ``batch_loss(train, frozen, y0, xs, tgt)``, the mean over the
        minibatch's trials of each trial's loss, for time-major inputs ``xs
        (T, mb, m)`` and targets ``(mb, R, ...)``; ``pack(state0, mb)``, the
        initial state of ``mb`` trials; and which trajectory the fit takes
        (``{"trajectory": "chain"|"graph"|"autograd", "fused_adam":
        False}``).  ``rk``/``remat_steps`` as in :meth:`fit_bptt`.  ``shard``:
        the programs of this rank's rows on placed trees (the loss of the
        gathered outputs)."""
        combine = self._combine
        step = self.make_step() if shard is None else shard.step()
        tr = self._trajectory(fused_bptt, rk, shard)
        cols, whole, _ = _shard_fns(self, shard)
        s = int(sampling_steps)

        def trial_mean(outs, tgt):
            """outs (mb, T, n): each trial's loss on its downsampled outputs,
            then the mean over trials (the JAX package's vmapped loss)."""
            if s > 1:
                n_keep = outs.shape[1] // s
                outs = outs[:, :n_keep * s].reshape(outs.shape[0], n_keep, s, -1).mean(dim=2)
            return torch.stack([loss_fn(o, t) for o, t in zip(outs, tgt)]).mean()

        if tr.kind == "chain":
            label, prefix, suffix = tr.chain

            def pack(state0, mb):
                return self._batch_state(state0, mb)["nodes"][label]

            def batch_loss(train, frozen, y0, xs, tgt):
                params = combine(train, frozen)
                nargs = params["nodes"][label]
                W = {k: nargs[k] for k in tr.wkeys}
                rest = {k: v for k, v in nargs.items() if k not in tr.wkeys}
                xs = cols(xs)
                xs = prefix(params, xs) if prefix is not None else xs
                _, outs = tr.traj(W, rest, y0, xs)
                if suffix is not None:
                    outs = suffix(params, outs)
                return trial_mean(whole(outs).transpose(0, 1), tgt)
        elif tr.kind == "graph":
            from .ops.graph_bptt import graph_weights_args

            def pack(state0, mb):
                return self._graph_pack(tr.spec, self._batch_state(state0, mb))

            def batch_loss(train, frozen, Y0, xs, tgt):
                weights, args = graph_weights_args(tr.spec, combine(train, frozen))
                _, outs = tr.traj(weights, args, Y0, cols(xs))
                return trial_mean(whole(outs).transpose(0, 1), tgt)
        else:
            def pack(state0, mb):
                return self._batch_state(state0, mb)

            def batch_loss(train, frozen, state0, xs, tgt):
                params = self._prep_edge_params(combine(train, frozen), shard)
                _, outs = self._plain_outs(step, params, state0, cols(xs), remat_steps)
                return trial_mean(whole(outs).transpose(0, 1), tgt)

        return batch_loss, pack, {"trajectory": tr.kind, "fused_adam": False}

    def _chain_decompose(self, shard=None):
        """Decompose a chain network ``[instants...] -> population ->
        [instants...]`` (stateless ``Linear`` edges) into ``(label,
        apply_prefix, apply_suffix)``; ``None`` when the topology does not
        qualify (feedback edges never do).  The stateless pre/post stages
        move outside the time loop: each becomes one batched product over the
        ``(T, n)`` series.  ``shard``: the stages of this rank's rows, each
        edge taking its source as the shard's step takes it (gathered once
        over the series)."""
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
        node_of = self.get_node if shard is None else shard.node
        edge_of = self.get_edge if shard is None else shard.edge
        pre_ops, post_ops = [], []
        side_ops = pre_ops
        for i, nname in enumerate(order):
            if nname == label:
                side_ops = post_ops
            else:
                side_ops.append(("node", None, node_of(nname).make_step()))
            if i + 1 < len(order):
                edge = self.get_edge(nname, order[i + 1])
                if edge.init_state() is not None:
                    return None  # stateful edge: no chain trajectory
                side_ops.append(("edge", (nname, order[i + 1]),
                                 edge_of(nname, order[i + 1]).make_step()))

        def apply(ops, params, H):
            for kind, key, fn in ops:
                p = {}
                if kind == "edge":
                    p = params["edges"][_ekey(*key)]
                    H = H if shard is None else shard._source(*key, H, {})
                H = torch.func.vmap(lambda h, p=p, fn=fn: fn(None, p, h)[1])(H)
            return H

        return (label, lambda params, xs: apply(pre_ops, params, xs),
                lambda params, outs: apply(post_ops, params, outs))

    def _trajectory(self, fused_bptt, rk: int = 0, shard=None) -> SimpleNamespace:
        """The trajectory a fit takes, as the JAX package's
        ``_build_epoch_loss`` picks it: a chain network's population
        trajectory (``ops/bptt.make_coupled_traj``; ``kind="chain"``, with
        ``chain``, ``traj`` and ``wkeys``), else the graph trajectory
        (``ops/graph_bptt.make_graph_traj``; ``kind="graph"``, with ``traj``
        and ``spec``), else plain autograd (``kind="autograd"``).
        ``fused_bptt=True`` raises where neither trajectory applies; an
        unsupported topology (``ValueError``, ``AttributeError``,
        ``KeyError``) sends ``'auto'`` to plain autograd.  ``rk > 1``: the
        trajectories checkpoint ``rk``-step chunks.  ``shard``: the
        trajectories of this rank's rows (``parallel/``)."""
        if fused_bptt in ("auto", True):
            chain = self._chain_decompose(shard)
            if chain is not None:
                from .ops.bptt import make_coupled_traj

                node = self.get_node(chain[0]) if shard is None else shard.node(chain[0])
                comm = (shard.traj_comm() if shard is not None and chain[0] in shard.rows
                        else None)
                try:
                    traj, wkeys = make_coupled_traj(node, remat_steps=rk, comm=comm)
                    return SimpleNamespace(kind="chain", chain=chain, traj=traj, wkeys=wkeys)
                except (ValueError, AttributeError, KeyError):
                    pass
            from .ops.graph_bptt import make_graph_traj

            try:
                traj, spec = make_graph_traj(self, remat_steps=rk, shard=shard)
                return SimpleNamespace(kind="graph", traj=traj, spec=spec)
            except (ValueError, AttributeError, KeyError):
                if fused_bptt is True:
                    raise
        return SimpleNamespace(kind="autograd")

    @staticmethod
    def _graph_pack(spec, state0: dict):
        """The graph trajectory's start: the population states, and with
        feedback or stateful edges the whole carry (the block edges' states
        packed)."""
        Y0 = {lbl: state0["nodes"][lbl] for lbl in spec.pop_labels}
        if not spec.needs_carry:
            return Y0
        return {"Y": Y0, "fb": state0.get("fb", {}),
                "E": {ek: spec.estate_pack[ek](state0["edges"][ek])
                      for ek in spec.stateful_edges}}

    def _plain_outs(self, step, params, state0, xs, remat_steps: int = 0):
        """Plain autograd's loop of ``step`` over the per-step inputs ``xs``:
        ``(state_T, outs)``.  ``remat_steps=k`` dividing ``T`` runs each
        k-step segment under ``torch.utils.checkpoint``, which recomputes
        the segment in the backward instead of keeping its activations (the
        JAX package's ``jax.checkpoint``)."""
        def segment(state, seg):
            outs = []
            for x in seg.unbind(0):
                state, out, _ = step(state, params, x)
                outs.append(out)
            return state, torch.stack(outs)

        R, T = int(remat_steps), int(xs.shape[0])
        if R <= 1 or T % R:
            return segment(state0, xs)
        from torch.utils.checkpoint import checkpoint

        state, parts = state0, []
        for c in range(T // R):
            state, outs = checkpoint(segment, state, xs[c * R:(c + 1) * R], use_reentrant=False)
            parts.append(outs)
        return state, torch.cat(parts)

    def _build_epoch_programs(self, loss_fn, opt, fused_bptt, sampling_steps, fused_cfg,
                              paths, rk: int = 0, remat_steps: int = 0, shard=None):
        """``(update, init_opt, pack, info)``: the per-epoch update
        ``update(train, frozen, opt_state, y0, inp, tgt) -> (train',
        opt_state', loss)``, the optimizer-state initializer of the fused
        adam path (else ``None``), the initial-state packer, and which paths
        the fit takes (``{"trajectory": "chain"|"graph"|"autograd",
        "fused_adam": bool}``).  ``rk > 1`` checkpoints the trajectories;
        plain autograd checkpoints ``remat_steps``-step segments.
        ``shard``: the programs of this rank's rows on placed trees (the
        loss of the gathered outputs, the gradients reduced over the model
        group)."""
        combine = self._combine
        step = self.make_step() if shard is None else shard.step()
        tr = self._trajectory(fused_bptt, rk, shard)
        cols, whole, reduce = _shard_fns(self, shard)

        def downsample(outs):
            if sampling_steps > 1:
                n_keep = outs.shape[0] // sampling_steps
                outs = outs[: n_keep * sampling_steps]
                outs = outs.reshape(n_keep, sampling_steps, -1).mean(dim=1)
            return outs

        if tr.kind == "chain":
            label, apply_prefix, apply_suffix = tr.chain
            traj_wkeys = tr.wkeys

            def pack(state0):
                return state0["nodes"][label]

            def epoch_loss(train, frozen, y0, inp, tgt, traj_fn=None, wp=None):
                params = combine(train, frozen)
                nargs = params["nodes"][label]
                W = {k: nargs[k] for k in traj_wkeys}
                rest = {k: v for k, v in nargs.items() if k not in traj_wkeys}
                xs = cols(inp)
                xs = apply_prefix(params, xs) if apply_prefix is not None else xs
                if traj_fn is None:
                    _, outs = tr.traj(W, rest, y0, xs)
                else:
                    _, outs = traj_fn((wp,), W, rest, y0, xs)
                if apply_suffix is not None:
                    outs = apply_suffix(params, outs)
                return loss_fn(downsample(whole(outs)), tgt)

            fused = (self._build_fused_adam(label, traj_wkeys, epoch_loss, fused_cfg, paths)
                     if rk == 0 and shard is None else None)
            if fused is not None:
                return fused + (pack, {"trajectory": "chain", "fused_adam": True})
        elif tr.kind == "graph":
            from .ops.graph_bptt import graph_weights_args

            def pack(state0):
                return self._graph_pack(tr.spec, state0)

            def epoch_loss(train, frozen, Y0, inp, tgt):
                weights, args = graph_weights_args(tr.spec, combine(train, frozen))
                _, outs = tr.traj(weights, args, Y0, cols(inp))
                return loss_fn(downsample(whole(outs)), tgt)
        else:
            def pack(state0):
                return state0

            def epoch_loss(train, frozen, state0, inp, tgt):
                params = self._prep_edge_params(combine(train, frozen), shard)
                _, outs = self._plain_outs(step, params, state0, cols(inp), remat_steps)
                return loss_fn(downsample(whole(outs)), tgt)

        def update(train, frozen, opt_state, y0, inp, tgt):
            lval, grads = _value_and_grad(epoch_loss, train, frozen, y0, inp, tgt)
            train, opt_state = opt.update(reduce(grads), opt_state, train)
            return tree_map(lambda t: t.detach(), train), opt_state, lval

        return update, None, pack, {"trajectory": tr.kind, "fused_adam": False}

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
                    update_steps, sampling_steps, obs, fused_bptt, shard=None):
        """Step mode of ``fit_bptt`` (truncated BPTT): ``(train', state_T,
        records)``.  The chunk losses and the records stay on the device
        until the end.  ``shard``: this rank's rows, on placed trees (the
        state returned whole, the records gathered once, at the end)."""
        combine = self._combine
        step = self.make_step() if shard is None else shard.step()
        cols, whole, reduce = _shard_fns(self, shard)
        T, u, s = int(inputs.shape[0]), int(update_steps), int(sampling_steps)
        n_upd = T // u
        rec_whole = self._resolve_record_vars(obs, shard)
        rec_info = rec_whole if shard is None else _unreduced(rec_whole)
        record_output = obs.record_output
        xs_all = cols(inputs)

        # records on the global grid step % s == 0: per-step outputs and
        # record_vars after the step
        rec_steps, rec_out, rec_vars = [], [], []

        def record(t, out, vals):
            rec_steps.append(t)
            if record_output:
                rec_out.append(out.detach())
            rec_vars.append([v.detach() for v in vals])

        def forward(state, params, t0, t1):  # no update (T < u, and the leftover)
            params = self._prep_edge_params(params, shard)
            with torch.no_grad():
                for t in range(t0, t1):
                    state, out, _ = step(state, params, xs_all[t])
                    if t % s == 0:
                        record(t, whole(out), _read_vars(rec_info, state, params))
            return state

        # the trajectories emit outputs only: record_vars take autograd
        tr = self._trajectory(fused_bptt if not rec_info else False, shard=shard)
        if tr.kind == "chain":
            label, prefix, suffix = tr.chain

            def chunk_loss(train, frozen, state, t0):
                params = combine(train, frozen)
                nargs = params["nodes"][label]
                W = {k: nargs[k] for k in tr.wkeys}
                rest = {k: v for k, v in nargs.items() if k not in tr.wkeys}
                xs = xs_all[t0:t0 + u]
                xs = prefix(params, xs) if prefix is not None else xs
                yT, outs = tr.traj(W, rest, state["nodes"][label], xs)
                if suffix is not None:
                    outs = suffix(params, outs)
                outs = whole(outs)
                new_state = {**state, "nodes": {**state["nodes"], label: yT}}
                return loss_fn(outs, targets[t0:t0 + u]), (new_state, outs, {})
        elif tr.kind == "graph":
            from .ops.graph_bptt import graph_weights_args

            spec = tr.spec

            def chunk_loss(train, frozen, state, t0):
                # the carried feedback outputs and edge states cross the
                # chunks (packed and unpacked at each boundary)
                weights, args = graph_weights_args(spec, combine(train, frozen))
                C0 = self._graph_pack(spec, state)
                CT, outs = tr.traj(weights, args, C0, xs_all[t0:t0 + u])
                outs = whole(outs)
                if spec.needs_carry:
                    new_E = {ek: spec.estate_unpack[ek](CT["E"][ek], state["edges"][ek], u)
                             for ek in spec.stateful_edges}
                    new_state = {**state, "nodes": {**state["nodes"], **CT["Y"]},
                                 "edges": {**state["edges"], **new_E}}
                    if "fb" in state:
                        new_state["fb"] = CT["fb"]
                else:
                    new_state = {**state, "nodes": {**state["nodes"], **CT}}
                return loss_fn(outs, targets[t0:t0 + u]), (new_state, outs, {})
        else:
            def chunk_loss(train, frozen, state, t0):
                params = self._prep_edge_params(combine(train, frozen), shard)
                outs, vals = [], {}
                for t in range(t0, t0 + u):
                    state, out, _ = step(state, params, xs_all[t])
                    outs.append(out)
                    if rec_info and t % s == 0:
                        vals[t] = _read_vars(rec_info, state, params)
                outs = whole(torch.stack(outs))
                return loss_fn(outs, targets[t0:t0 + u]), (state, outs, vals)

        self.last_fit = {"trajectory": tr.kind, "fused_adam": False}
        state, losses = state0, []
        for c in range(n_upd):
            t0 = c * u
            lval, grads, (state, outs, vals) = _value_and_grad(
                chunk_loss, train, frozen, state, t0, has_aux=True)
            train, opt_state = opt.update(reduce(grads), opt_state, train)
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
        vars_ = {}
        for i, (key, label, _, reduce_) in enumerate(rec_whole):
            if len(steps):
                val = torch.stack([r[i] for r in rec_vars])
                if shard is not None:
                    val = shard.whole(label, val)
                    val = val.mean(dim=-1) if reduce_ else val
                vars_[key] = _host(val)
        out = _host(torch.stack(rec_out)) if rec_out else None
        if shard is not None:
            state = shard.gather_state(state)
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
        update's loss of each epoch) and ``epochs``.

        ``mesh=``: each step is the population shard's (``run(mesh=)``'s),
        the update reads the whole tap of the edge's source (the step's own
        gather of it) and, where the readout is sharded, updates its rows of
        the weights (``P`` stays whole: every rank downdates it alike); the
        losses sum over the model group once, at the end.  The weights,
        state and records are those of the fit without a mesh."""
        if not self._train_edge:
            raise ValueError("No RLS-trainable edge in the network; add one with "
                             "add_edge(..., train='rls').")
        self.compile()
        shard = self._fit_shard(kwargs.pop("mesh", None))
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
                                      sampling_steps, obs, record=False, shard=shard)
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
                                             record=True, shard=shard))
        if verbose:
            print(f"Finished optimization after {perf_counter() - t0} s.")
        return obs

    def _online_setup(self, shard, obs, record: bool = True) -> SimpleNamespace:
        """What the online trainers' host loops (``fit_rls``, ``fit_eprop``,
        ``fit_stdp``) run: the step (the shard's, with whole taps), the start
        state and the prepped parameters (this rank's parts), the edge's
        params in that tree (the loop writes its weights there each step)
        and the ``record_vars`` readers; ``finish(state, outs, vars)``
        writes the state back and makes the recorded series whole."""
        src, tgt = self._train_edge
        ekey = _ekey(src, tgt)
        rec_info = self._resolve_record_vars(obs, shard) if record else []
        if shard is None:
            step, state = self.make_step(taps=(src, tgt)), self.init_state()
            params = self._prep_params(self.parameters_pytree())
            read_info = rec_info
        else:
            step, state = shard.step(taps=(src, tgt)), shard.place(self.init_state())
            params = self._prep_params(shard.place(self.parameters_pytree()), shard)
            read_info = _unreduced(rec_info)
        eparams = params["edges"][ekey] = dict(params["edges"][ekey])

        def finish(state, outs: list, vals: list):
            """``(outputs, {key: series})`` of the recorded steps, whole."""
            self._write_back(state=state if shard is None else shard.gather_state(state))
            out = torch.stack(outs) if outs else None
            series = {}
            for i, (key, label, _, reduce) in enumerate(rec_info):
                if vals:
                    val = torch.stack([r[i] for r in vals])
                    if shard is not None:
                        val = shard.whole(label, val)
                        val = val.mean(dim=-1) if reduce else val
                    series[key] = val
            if shard is not None and out is not None:
                out = shard.whole(self._out_node, out)
            return out, series

        return SimpleNamespace(step=step, state=state, params=params, eparams=eparams,
                               read_info=read_info, finish=finish)

    def _rls_loop(self, inputs, targets, update_steps, sampling_steps, obs, record: bool,
                  shard=None):
        """One pass of ``fit_rls`` over ``inputs``; returns the last update's
        loss as a 0-d device tensor.  The JAX package computes the update
        every step and selects it; this loop branches on the host step
        index, so steps without an update skip the O(N^2) work.  ``shard``:
        this rank's rows (``fit_rls(mesh=)``)."""
        src, tgt = self._train_edge
        edge = self.get_edge(src, tgt)
        update = RLS.update_fn(edge.beta)
        run = self._online_setup(shard, obs, record)
        state, params, eparams = run.state, run.params, run.eparams
        W, P = eparams["weights"], edge.params["P"]
        xs = inputs if shard is None else shard.cols(inputs)
        if shard is not None:
            targets = shard.target_rows(tgt, targets)
        w_dtype = W.dtype
        loss = torch.zeros((), dtype=w_dtype, device=self.device)
        u, s = int(update_steps), int(sampling_steps)
        rec_steps, rec_out, rec_loss, rec_vars = [], [], [], []
        with torch.no_grad():
            for t in range(int(inputs.shape[0])):
                eparams["weights"] = W
                state, out, taps = run.step(state, params, xs[t])
                if t % u == 0:
                    y_hat = taps[tgt] if shard is None else shard.target_rows(tgt, taps[tgt])
                    W, P, loss = update(W, P, taps[src].to(w_dtype), targets[t].to(w_dtype),
                                        y_hat.to(w_dtype))
                if record and t % s == 0:
                    rec_steps.append(t)
                    rec_out.append(out)
                    rec_loss.append(loss)
                    rec_vars.append(_read_vars(run.read_info, state, params))
        edge.params["weights"] = W if shard is None else shard.edge_whole(src, tgt, "weights", W)
        out, series = run.finish(state, rec_out, rec_vars)
        if shard is not None and tgt in shard.rows:  # each rank's rows' squared errors
            rows_sum = shard.model_sum
        else:
            def rows_sum(x):
                return x
        if record and rec_steps:
            obs.record_batch(np.asarray(rec_steps), outputs=_host(out),
                             losses=_host(rows_sum(torch.stack(rec_loss))),
                             var_values={k: _host(v) for k, v in series.items()} or None)
        return rows_sum(loss)

    def fit_stdp(self, inputs, sampling_steps: int = 100, reward=None, tau_e: float = None,
                 homeostasis_steps: int = None, homeostasis_target=None, verbose: bool = True,
                 **kwargs) -> Observer:
        """Online spike-timing-dependent plasticity of the edge added with
        ``add_edge(..., train='stdp')`` (an ``STDP`` edge, or a
        ``BlockSparseSTDP`` one on a ``BlockSparseCoupling``).

        Unsupervised: both endpoint nodes must be spiking populations, and
        the pair rule takes each step's own spike decisions, read from the
        state before the step by the nodes' spike readers (what
        ``record_spikes`` counts).  Each step runs the network with the
        current weights, then updates the weights and both traces; on the
        card the update of dense or block weights is one launch of the
        ``stdp_update`` kernel (``ops/stdp.py``).  The traces persist on the
        edge, so chunked calls continue plasticity seamlessly.

        ``inputs``: a ``(T, m)`` array or an unbatched input spec
        (``rectipy_tpu_torch.inputs``), made on the device.

        ``reward``: a ``(T,)`` per-step reward switches to reward-modulated
        STDP (Izhikevich 2007): the pair increments charge an eligibility
        trace ``E`` (decay ``tau_e``, default ``10 * max(tau_plus,
        tau_minus)``) and the weights move by ``r_t * E`` (hard bounds).
        ``E`` persists on the edge as ``params['elig']``.

        ``homeostasis_steps``: every period each post-synaptic row's
        above-floor mass is rescaled to ``homeostasis_target``,

            W_i <- clip(w_min + (W_i - w_min) * target_i / sum(W_i - w_min))

        (by default each row's above-floor mass at the first scaled fit; on a
        block edge neuron ``r*bs + i``'s row is the entries ``[r, :, i, :]``).
        The target (``edge._homeo_target``) and the schedule's phase
        (``edge._homeo_phase``) persist on the edge, so chunks of any length
        reproduce one long call.  Where a call starts on a scaling boundary
        and covers whole periods, the weights recorded at a scaling step are
        those before the scaling, as on the JAX package's segmented path;
        otherwise those after it.  Needs 2-D or block weights.

        Records at ``step % sampling_steps == 0``: the step's output,
        ``record_vars`` after the step, and the weights' ``"w_mean"``,
        ``"w_min"`` and ``"w_max"`` (with ``"w_steps"``).
        ``record_spikes=[node, ...]`` adds each node's spike counts over the
        window that ends at each record step, that step included, under
        ``(node, "spikes")`` (int32).

        ``mesh=``: each step is the population shard's; the rule updates
        this rank's rows of the weights and of ``x_post`` (block rows of a
        block edge; ``stdp_update`` on the rank's rows), from the gathered
        pre-synaptic spikes and the whole ``x_pre``; homeostasis rescales
        the rank's rows toward their targets; the ``w_mean``/``w_min``/
        ``w_max`` records reduce over the whole weights with one all-gather
        at each record; a reward stays whole.  The weights, traces, state and
        records are those of the fit without a mesh.
        """
        if not self._train_edge:
            raise ValueError("No STDP-trainable edge in the network; add one with "
                             "add_edge(..., train='stdp').")
        self.compile()
        shard = self._fit_shard(kwargs.pop("mesh", None))
        spike_labels = kwargs.pop("record_spikes", None)
        spike_info = self._resolve_record_spikes(spike_labels)
        src, tgt = self._train_edge
        edge = self.get_edge(src, tgt)
        if not isinstance(edge, (STDP, BlockSparseSTDP)):
            raise ValueError(
                f"fit_stdp: the registered train edge {src!r} -> {tgt!r} is a "
                f"{type(edge).__name__}, not an STDP edge; add it with "
                "add_edge(..., train='stdp').")
        blocky = isinstance(edge, BlockSparseSTDP)
        for label, want in ((src, edge.n_in), (tgt, edge.n_out)):
            node = self.get_node(label)
            if not hasattr(node, "_make_spike_reader"):
                raise ValueError(
                    f"fit_stdp: node {label!r} ({type(node).__name__}) is not a "
                    "spiking node; STDP needs pre- and post-synaptic spike trains "
                    "(SpikeNet / SpikeResetNet / MultiSpikeResetNet populations).")
            got = int(node._make_spike_reader()(node.y).shape[-1])
            if got != want:
                raise ValueError(
                    f"fit_stdp: node {label!r} emits a {got}-wide spike vector but "
                    f"the STDP edge {src!r} -> {tgt!r} expects {want}.")
        obs_kwargs = retrieve_from_dict(["record_output", "record_loss", "record_vars"], kwargs)
        obs = Observer(dt=self.dt, **obs_kwargs)
        t0 = perf_counter()
        # the rule of this rank's rows (a block edge's columns of its block rows)
        rule = edge if shard is None else shard.edge(src, tgt)

        W = edge.params["weights"]
        w_dtype = W.dtype
        reward_mode = reward is not None
        E = None
        if reward_mode:
            if edge.soft_bounds:
                raise ValueError(
                    "reward-modulated STDP uses hard bounds (the reward changes "
                    "sign); construct the edge with soft_bounds=False.")
            if tau_e is None:
                tau_e = 10.0 * max(edge.tau_plus, edge.tau_minus)
            update = rule.reward_update_fn(self.dt, float(tau_e))
            reward = (reward.detach() if isinstance(reward, torch.Tensor)
                      else torch.as_tensor(np.asarray(reward, dtype=np.float64)))
            reward = reward.to(device=self.device, dtype=w_dtype).reshape(-1)
            E = edge.params.get("elig")
            E = torch.zeros_like(W) if E is None else E
        else:
            if tau_e is not None:
                raise ValueError(
                    "tau_e only applies to reward-modulated STDP; pass the "
                    "per-step reward= signal as well (or drop tau_e).")
            update = rule.update_fn(self.dt)
        consts = edge._consts()
        h_steps, h_target = 0, None
        if homeostasis_steps is not None:
            h_steps = int(homeostasis_steps)
            if h_steps <= 0:
                raise ValueError("homeostasis_steps must be a positive integer.")
            if not blocky and W.dim() != 2:
                raise ValueError(
                    "homeostatic synaptic scaling needs 2-D edge weights (rows "
                    "= postsynaptic neurons); 1-D diagonal edges have no row "
                    "mass to normalize.")
            if homeostasis_target is None:
                homeostasis_target = getattr(edge, "_homeo_target", None)
            if homeostasis_target is None:
                above = W - consts.w_min
                homeostasis_target = (above.sum(dim=(1, 3)).reshape(-1) if blocky
                                      else above.sum(dim=1))
            h_target = (homeostasis_target.detach() if isinstance(homeostasis_target,
                                                                  torch.Tensor)
                        else torch.as_tensor(np.asarray(homeostasis_target, dtype=np.float64)))
            h_target = h_target.to(device=self.device, dtype=w_dtype)
            if h_target.dim() == 0:
                h_target = h_target.expand(edge.n_out).clone()
            if tuple(h_target.shape) != (edge.n_out,):
                raise ValueError(
                    f"homeostasis_target must be a scalar or ({edge.n_out},) "
                    f"per-row array; got shape {tuple(h_target.shape)}.")
            edge._homeo_target = h_target  # one target across chunked calls
        elif homeostasis_target is not None:
            raise ValueError("homeostasis_target only applies with homeostasis_steps set.")
        # the scaling schedule's global phase: chunked calls continue one
        # long call's schedule
        h_phase = int(getattr(edge, "_homeo_phase", 0)) if h_steps else 0

        if isinstance(inputs, InputSpec):
            if inputs.batch is not None:
                raise ValueError("fit_stdp takes an unbatched input spec; per-trial "
                                 "parameters have no meaning for a single scan.")
            xs = inputs.drive(self.dt, self.dtype, self.device)
            steps, n_chan = int(inputs.steps), int(inputs.channels)
        else:
            inputs = self._to_device(inputs)
            if inputs.ndim != 2:
                raise ValueError(
                    f"`inputs` must be a (T, m) array; got shape {tuple(inputs.shape)}")
            xs = inputs.unbind(0)
            steps, n_chan = int(inputs.shape[0]), int(inputs.shape[1])
        if self.n_in and n_chan not in (1, self.n_in):
            raise ValueError(
                f"`inputs` has {n_chan} channels but the network input node "
                f"{self._in_node!r} expects {self.n_in} (or 1, broadcast).")
        if reward_mode and reward.shape[0] != steps:
            raise ValueError(
                f"`reward` must hold one value per step: got {reward.shape[0]} "
                f"rewards for {steps} steps.")
        # the JAX package's segmented path: a call that starts on a scaling
        # boundary and covers whole periods records the weights of a scaling
        # step before the scaling (the dynamics are the same either way)
        segmented = bool(h_steps) and h_phase % h_steps == 0 and steps % h_steps == 0 \
            and steps >= h_steps
        scale_rows = _homeo_scaler(consts, h_target, blocky) if h_steps else None

        s = int(sampling_steps)
        ekey = _ekey(src, tgt)
        # the step reads the plastic weights of the loop, never a prepped copy
        run = self._online_setup(shard, obs)
        step, state, params, eparams = run.step, run.state, run.params, run.eparams
        x_pre, x_post = edge.params["x_pre"], edge.params["x_post"]
        node_of, pre_whole = self.get_node, None
        if shard is not None:
            spike_info = self._resolve_record_spikes(spike_labels, shard)
            node_of, pre_whole = shard.node, (lambda spk: shard.whole(src, spk))
            xs = shard.inputs(xs)
            W, x_post, E = (shard.edge_part(src, tgt, key, v)
                            for key, v in (("weights", W), ("x_post", x_post), ("elig", E)))
            if h_steps:
                scale_rows = _homeo_scaler(consts, shard.target_rows(tgt, h_target), blocky)
        pre_read = node_of(src)._make_spike_reader()
        post_read = node_of(tgt)._make_spike_reader()
        rec_out, rec_w, rec_spk, rec_vars, acc = [], [], [], [], None

        def w_stats(W):
            if shard is None or tgt not in shard.rows:
                return torch.stack([W.mean(), W.min(), W.max()])
            part = shard.model_parts(torch.stack([W.sum(), W.min(), W.max()]))
            return torch.stack([part[:, 0].sum() / (W.numel() * shard.n_model),
                                part[:, 1].min(), part[:, 2].max()])

        with torch.no_grad():
            for t in range(steps):
                spk_pre = pre_read(state["nodes"][src]).to(w_dtype)
                if pre_whole is not None:
                    spk_pre = pre_whole(spk_pre)
                spk_post = post_read(state["nodes"][tgt]).to(w_dtype)
                if spike_info:
                    ind = [reader(state["nodes"][label]).to(torch.float32)
                           for label, reader in spike_info]
                    acc = ind if acc is None else [a + v for a, v in zip(acc, ind)]
                eparams["weights"] = W
                state, out, _ = step(state, params, xs[t])
                if reward_mode:
                    W, E, x_pre, x_post = update(W, E, x_pre, x_post, spk_pre, spk_post,
                                                 reward[t])
                else:
                    W, x_pre, x_post = update(W, x_pre, x_post, spk_pre, spk_post)
                scale_now = h_steps and (t + h_phase) % h_steps == h_steps - 1
                if scale_now and not segmented:
                    W = scale_rows(W)
                if t % s == 0:
                    rec_out.append(out)
                    rec_w.append(w_stats(W).to(w_dtype))
                    if spike_info:
                        rec_spk.append(acc)
                        acc = None
                    rec_vars.append(_read_vars(run.read_info, state, params))
                if scale_now and segmented:
                    W = scale_rows(W)
        if h_steps:
            edge._homeo_phase = (h_phase + steps) % h_steps
        if shard is not None:
            W, x_post, E = (shard.edge_whole(src, tgt, key, v)
                            for key, v in (("weights", W), ("x_post", x_post), ("elig", E)))
        edge.params["weights"] = W
        edge.params["x_pre"] = x_pre
        edge.params["x_post"] = x_post
        if reward_mode:
            edge.params["elig"] = E
        out, var_values = run.finish(state, rec_out, rec_vars)

        rec_steps = np.arange(0, steps, s)
        var_values = {k: _host(v) for k, v in var_values.items()}
        for i, (label, _) in enumerate(spike_info):
            counts = [r[i] for r in rec_spk]
            if counts and shard is not None:
                counts = list(shard.whole(label, torch.stack(counts)))
            var_values[(label, "spikes")] = (
                _host(torch.round(torch.stack(counts)).to(torch.int32)) if counts
                else np.zeros((0, 0), dtype=np.int32))
        obs.record_batch(rec_steps, outputs=_host(out) if rec_out else None,
                         losses=np.zeros(len(rec_steps)) if obs.record_loss else None,
                         var_values=var_values or None)
        w_stats = _host(torch.stack(rec_w)) if rec_w else np.zeros((0, 3))
        obs.save("w_steps", rec_steps)
        obs.save("w_mean", w_stats[:, 0])
        obs.save("w_min", w_stats[:, 1])
        obs.save("w_max", w_stats[:, 2])
        if verbose:
            print(f"Finished STDP optimization after {perf_counter() - t0} s.")
        return obs

    def fit_eprop(self, inputs, targets, feedback_weights: np.ndarray = None,
                  epsilon: float = 0.99, delta: float = 0.9, update_steps: int = 1,
                  sampling_steps: int = 100, lr: float = 1e-2, decay: float = 0.0,
                  normalize: bool = False, verbose: bool = True, **kwargs) -> Observer:
        """Online three-factor (e-prop-style) learning of the readout edge
        added with ``add_edge(..., train='eprop')`` (or an ``'rls'`` edge).
        Per step, a running average of the residual (rate ``epsilon``) and an
        eligibility trace of the pre-synaptic activity (rate ``delta``) make
        a local delta-rule update:

            err_bar <- epsilon * err_bar + (1 - epsilon) * (y* - y)
            elig    <- delta * elig + (1 - delta) * r_pre
            W       <- W * (1 - lr*decay) + lr * outer(err_bar, elig)   every update_steps

        ``normalize=True`` divides the outer product by ``1e-8 + elig @
        elig`` (NLMS: ``lr`` a relaxation factor in (0, 2)); ``decay``
        L2-regularizes the rule.  ``feedback_weights`` ``(n_in, n_out)``
        feeds ``err_bar`` back into the network input each step (``x_t +
        feedback_weights @ err_bar``).  The traces and the update run in
        ``promote_types(weights' dtype, float32)``; the hyperparameters are
        0-dim tensors of that type.  Steps without an update skip it (the
        JAX package computes it and gates it to zero).  Records at ``step %
        sampling_steps == 0``: the output, the loss ``|err|^2`` and
        ``record_vars``.

        ``mesh=``: as in :meth:`fit_rls`, the shard's step, the whole
        source tap, the readout's rows of the weights and of the residual
        trace where the readout is sharded (the loss summed over the model
        group at the end, the fed-back residual gathered each step)."""
        if not self._train_edge:
            raise ValueError("No online-trainable edge; add one with "
                             "add_edge(..., train='eprop') or train='rls'.")
        self.compile()
        obs_kwargs = retrieve_from_dict(["record_output", "record_loss", "record_vars"], kwargs)
        obs = Observer(dt=self.dt, **obs_kwargs)
        shard = self._fit_shard(kwargs.pop("mesh", None))
        src, tgt = self._train_edge
        edge = self.get_edge(src, tgt)
        run = self._online_setup(shard, obs)
        state, params, eparams = run.state, run.params, run.eparams
        inputs, targets = self._to_device(inputs), self._to_device(targets)
        if inputs.shape[0] != targets.shape[0]:
            raise ValueError(
                "Wrong dimensions of input and target output. Please make sure that "
                "`inputs` and `targets` agree in the first dimension."
            )
        steps = int(inputs.shape[0])
        W = edge.params["weights"]
        w_dtype = W.dtype
        fb = None
        if feedback_weights is not None:
            fb = self._to_device(feedback_weights)
            if tuple(fb.shape) != (self.n_in, int(W.shape[0])):
                raise ValueError(
                    f"feedback_weights must have shape (n_in, n_out) = "
                    f"({self.n_in}, {int(W.shape[0])}); got {tuple(fb.shape)}.")
        W = eparams["weights"]  # this rank's rows where the readout is sharded
        rows = shard is not None and tgt in shard.rows

        def whole_err(e):
            return shard.whole(tgt, e) if rows else e
        if shard is not None:
            targets = shard.target_rows(tgt, targets)
        # the traces never drop below float32: epsilon = 0.99 loses ~17% of
        # (1 - epsilon) in bfloat16; a float64 readout keeps float64
        acc = torch.promote_types(w_dtype, torch.float32)
        lr_t, eps_t, delta_t, decay_t = (torch.tensor(float(v), dtype=acc, device=self.device)
                                         for v in (lr, epsilon, delta, decay))
        err_bar = torch.zeros(W.shape[0], dtype=acc, device=self.device)
        elig = torch.zeros(W.shape[1], dtype=acc, device=self.device)
        u, s = int(update_steps), int(sampling_steps)
        t0 = perf_counter()
        rec_steps, rec_out, rec_loss, rec_vars = [], [], [], []
        with torch.no_grad():
            for t in range(steps):
                eparams["weights"] = W
                x_t = inputs[t]
                if fb is not None:
                    x_t = x_t + fb @ whole_err(err_bar).to(self.dtype)
                x_t = x_t if shard is None else shard.cols(x_t)
                state, out, taps = run.step(state, params, x_t)
                y_hat = taps[tgt] if shard is None else shard.target_rows(tgt, taps[tgt])
                err = targets[t].to(acc) - y_hat.to(acc)
                err_bar = eps_t * err_bar + (1.0 - eps_t) * err
                elig = delta_t * elig + (1.0 - delta_t) * taps[src].to(acc)
                if t % u == 0:
                    upd = torch.outer(err_bar, elig)
                    if normalize:  # NLMS: the step relative to the eligibility energy
                        upd = upd / (1e-8 + elig @ elig)
                    W = (W.to(acc) * (1.0 - lr_t * decay_t) + lr_t * upd).to(w_dtype)
                if t % s == 0:
                    rec_steps.append(t)
                    rec_out.append(out.to(w_dtype))
                    rec_loss.append(err @ err)
                    rec_vars.append(_read_vars(run.read_info, state, params))
        edge.params["weights"] = W if shard is None else shard.edge_whole(src, tgt, "weights", W)
        out, series = run.finish(state, rec_out, rec_vars)
        if rec_steps:
            losses = torch.stack(rec_loss)
            obs.record_batch(np.asarray(rec_steps), outputs=_host(out),
                             losses=_host(shard.model_sum(losses) if rows else losses),
                             var_values={k: _host(v) for k, v in series.items()} or None)
        if verbose:
            print(f"Finished optimization after {perf_counter() - t0} s.")
        return obs

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


def _homeo_scaler(c, h_target: torch.Tensor, blocky: bool) -> Callable:
    """``fit_stdp``'s multiplicative synaptic scaling: each post-synaptic
    row's above-floor mass rescaled to ``h_target`` (a block edge's row of
    neuron ``r*bs + i`` is the entries ``[r, :, i, :]``), then clipped to the
    bounds ``c`` (``ops/stdp.stdp_consts``)."""
    eps = torch.tensor(1e-12, dtype=h_target.dtype, device=h_target.device)

    def scale_rows(W):
        above = W - c.w_min
        if blocky:
            mass = above.sum(dim=(1, 3))  # (n_br, bs)
            scale = h_target.reshape(mass.shape) / (mass + eps)
            return clip(c.w_min + above * scale[:, None, :, None], c)
        scale = h_target / (above.sum(dim=1) + eps)
        return clip(c.w_min + above * scale[:, None], c)

    return scale_rows


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


def _minibatch_update(batch_loss, opt, train, opt_state, y0, micro: list,
                      reduce: Callable = None) -> tuple:
    """One optimizer update of the batched-trial trainers on one minibatch:
    the mean of the micro-batches' losses and gradients (each the mean over
    its trials), then ``opt.update``.  Returns ``(train', opt_state', loss)``
    with the loss a 0-d device tensor.  ``reduce(loss, grads)``: a mesh
    fit's reduction of each micro-batch's over the ranks."""
    lsum, gsum = None, None
    for fz, xs, tgt in micro:  # equal micro-batches: the mean of their means
        lval, grads = _value_and_grad(batch_loss, train, fz, y0, xs, tgt)
        if reduce is not None:
            lval, grads = reduce(lval, grads)
        lsum = lval if lsum is None else lsum + lval
        gsum = grads if gsum is None else tree_map(torch.add, gsum, grads)
    if len(micro) > 1:
        lsum, gsum = lsum / len(micro), tree_map(lambda g: g / len(micro), gsum)
    train, opt_state = opt.update(gsum, opt_state, train)
    return tree_map(lambda t: t.detach(), train), opt_state, lsum


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
