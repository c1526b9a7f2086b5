"""Device meshes, population placement, and the sharded run and train step.

Counterpart of ``rectipy_tpu/parallel/sharding.py``.  The port runs SPMD,
one process per device, on ``torch.distributed``: every rank builds the same
network and calls the same function with the same inputs.  A rank of the
mesh's ``model`` axis owns neurons ``[r0, r1)`` of every population it
shards (a node whose size the axis divides): their state rows, their rows of
every coupling, per-neuron parameter and edge into the population.  Each
step it all-gathers the source vector of every coupling and edge whose
source is sharded (``comm.gather_last``; once per source a step for the
edges), then computes its own rows with the unchanged per-row arithmetic
(the hand-written kernels take plain local tensors).  The records are formed
on the local rows and gathered once, at the end of the run.  Trials of
``run_batch`` and of the train step ride the ``data`` axis.

What runs whole on every rank of a model group, with no collective of its
own: a node the axis does not divide (or whose block edges' block rows it
does not divide), a node with a fused kernel attached (the kernel's step is
the whole population's), a softmax-family function node, and every edge's
state (the delay histories, filters and STP variables belong to the source
side: each rank advances them from the gathered source; the traces and
``P`` of the online rules follow their edge's row parameters).  A model
axis of one rank is the unsharded run: the same step, bit for bit, with no
collective.  The trainers (``Network.fit_*(mesh=)``) run on the same
shard: the deferred-gradient trajectories of ``ops/bptt.py`` and
``ops/graph_bptt.py`` take its local nodes and edges and
``comm.TrajectoryComm``'s gathers.

Placement, by what each leaf is: a coupling's rows (dense, or the block
rows of a block stack and of its ``cols``), a per-neuron parameter's rows,
an edge's row parameters (its weights' rows, a block edge's block rows and
per-block delays, diagonal gains' rows) by target rows.  An edge's
per-source delays and its ring buffer or history (the source side) stay
whole: the run step of diagonal gains projects the rows ``[r0, r1)`` of
the gathered source's vector.  The graph trajectory's stage of diagonal
gains reads the rank's own rows of the source, and carries a delayed
edge's buffer rows (gathered whole at the end of a chunk), so it issues no
collective a step; its gradient is the rank's rows, a sharded leaf's.
(Masked diagonal gains scale the mask's columns: they stay whole, and a
shard slices their step's output.)  The quantized couplings and block edges of a shard take the model
group (``self.group``, a ``comm.Group``) for their dynamic scales and
integer partial sums (``ops/quant.py``).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import comm

__all__ = ["make_mesh", "shard_network_arrays", "sharded_run", "sharded_train_step",
           "NetworkShard"]


def make_mesh(n_devices: Optional[int] = None, data: int = 1,
              axis_names: Tuple[str, str] = ("data", "model"), device_type: str = "cuda"):
    """A 2-D ``(data, model)`` :class:`~torch.distributed.device_mesh.DeviceMesh`
    over ranks ``0 .. n_devices - 1`` of the initialized default process
    group (every rank calls it); ``model = n_devices / data``.  The default
    is the card (NCCL); the CPU ranks (gloo) pass ``device_type="cpu"``.
    Raises ``ValueError`` where ``n_devices`` exceeds the world size or
    ``data`` does not divide it, and ``RuntimeError`` for ``"cuda"`` without
    a card: there is no fall-back to the CPU."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(torch.distributed.init_process_group).")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"Requested {n_devices} devices, only {world} available")
    if n_devices % data != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by data={data}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda') needs a CUDA device; CPU ranks "
                           "pass device_type='cpu'.")
    ranks = torch.arange(n_devices).reshape(data, n_devices // data)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def _axis(mesh, name: str) -> Tuple[int, int, object]:
    """``(size, this rank's index, process group)`` of a mesh axis; ``(1,
    0, None)`` for an axis the mesh lacks or of one rank."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        return 1, 0, None
    size = mesh.size(names.index(name))
    if size == 1:
        return 1, 0, None
    return size, mesh.get_local_rank(name), mesh.get_group(name)


def _leaf_spec(leaf, n: int, model_axis: str) -> tuple:
    """The JAX package's population-sharding rule, as the partition spec's
    tuple: ``(N, N)`` -> row-sharded; ``(N,)`` -> sharded; a block stack
    ``(n_br, cb, bs, bs)`` on its block rows and its integer ``cols`` table
    with it; a flattened multi-variable state ``(V*N,)`` sharded (in the
    port: each variable's rows); everything else replicated, ``()``."""
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) == 4 and shape[0] * shape[2] == n and shape[2] == shape[3]:
        return (model_axis, None, None, None)
    integer = isinstance(leaf, torch.Tensor) and not leaf.is_floating_point()
    if len(shape) == 2 and integer and shape[0] and n % shape[0] == 0:
        return (model_axis, None)
    if len(shape) == 2 and shape[0] == n:
        return (model_axis, None)
    if len(shape) == 1 and shape[0] > 0 and shape[0] % n == 0:
        return (model_axis,)
    return ()


def _take_rows(leaf, n: int, r0: int, r1: int, n_model: int):
    """This rank's part of ``leaf`` under :func:`_leaf_spec` for neurons
    ``[r0, r1)`` of ``n``: the rows (block rows of a block stack and its
    table), each variable's rows of a flat state, or the whole leaf where
    the rule replicates it or the sharded dimension does not divide."""
    if not isinstance(leaf, torch.Tensor) or not _leaf_spec(leaf, n, "model"):
        return leaf
    if leaf.dim() == 1:
        return leaf.reshape(-1, n)[:, r0:r1].reshape(-1)
    if leaf.shape[0] % n_model:
        return leaf
    per = n // leaf.shape[0]  # neurons a row: 1, or the block size
    return leaf[r0 // per:r1 // per]


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def shard_network_arrays(tree, n: int, mesh, model_axis: str = "model"):
    """This rank's part of a params/state tree under population sharding
    (:func:`_leaf_spec`): per-neuron leaves give their rows of ``n``
    (``n / model`` of them, in the order of the ranks), scalars and
    non-population leaves stay whole; a leaf whose sharded dimension does
    not divide stays whole, not an error.  For a network of one node this is
    the placement ``Network.run(mesh=)`` makes; a network of several takes
    ``Network._mesh_place`` (each node's own size, edge rows by target)."""
    n_model, rank, _ = _axis(mesh, model_axis)
    if n_model == 1 or n % n_model:
        return tree
    rows = n // n_model
    r0 = rank * rows
    return _map_tree(lambda leaf: _take_rows(leaf, n, r0, r0 + rows, n_model), tree)


class _Rows(Sequence):
    """The per-step inputs ``xs[t]`` cut to this rank: trials ``[t0, t1)``
    of a batched drive, and neurons ``[c0, c1)`` of a drive as wide as
    ``width`` (a one-channel drive broadcasts as it is)."""

    def __init__(self, xs, trials: Optional[tuple], cols: Optional[tuple], width: int):
        self.xs, self.trials, self.cols, self.width = xs, trials, cols, width

    def __len__(self):
        return len(self.xs)

    def __getitem__(self, t):
        x = self.xs[t]
        if self.trials is not None:
            x = x[self.trials[0]:self.trials[1]]
        if self.cols is not None and x.shape[-1] == self.width:
            x = x[..., self.cols[0]:self.cols[1]]
        return x


class NetworkShard:
    """A compiled network as this rank runs it on ``mesh``: which nodes it
    shards and its rows of each (``rows``), the local node and edge copies
    (``node``, ``edge``), the local step, the placement of trees, inputs and
    sweeps, and the gathers at the end of a run."""

    def __init__(self, net, mesh, model_axis: str = "model", data_axis: str = "data"):
        if not hasattr(mesh, "get_coordinate"):
            raise TypeError(f"mesh= takes a torch.distributed DeviceMesh "
                            f"(parallel.make_mesh); got {type(mesh).__name__}.")
        if mesh.get_coordinate() is None:
            raise ValueError("This rank is not in the mesh: every rank that calls a run "
                             "with mesh= must belong to it.")
        net.compile()
        self.net = net
        self.n_model, self.m_rank, self.m_group = _axis(mesh, model_axis)
        self.n_data, self.d_rank, self.d_group = _axis(mesh, data_axis)
        # the quantized products' scales and partial sums (ops/quant.py)
        self.group = comm.Group(self.m_group, self.n_model, self.m_rank)
        self._trials: Dict[int, Tuple[int, int]] = {}
        order = net._compiled["order"]
        fb = net._fb_edge_list()
        into = {v: [net.get_edge(u, v) for u in net.graph.predecessors(v)] for v in order}
        for _, v, e in fb:
            into[v].append(e)
        self.rows: Dict[str, Tuple[int, int]] = {}
        self.width: Dict[str, int] = {}
        self._nodes = {}
        for label in order:
            node = net.get_node(label)
            n = node._vf.n if getattr(node, "_vf", None) is not None else node.n_out
            self.width[label] = n
            local = self._cut(label, node, n, into[label])
            self._nodes[label] = node if local is None else local
        self._edges = {(u, v): self._edge(u, v, net.get_edge(u, v))
                       for v in order for u in net.graph.predecessors(v)}
        self.fb_edges = [(u, v, self._edge(u, v, e)) for u, v, e in fb]
        self._edges.update({(u, v): e for u, v, e in self.fb_edges})

    # ---------------------------------------------------------- the layout
    def _cut(self, label: str, node, n: int, edges_in: list):
        """The node's local copy on this rank's rows, or None: it runs
        whole (see the module docstring)."""
        k = self.n_model
        if k == 1 or n % k:
            return None
        for e in edges_in:
            if hasattr(e, "bs") and (e.n_out // e.bs) % k:
                return None
        args = getattr(node, "_args", {})
        if any(key.endswith("__cols") and args[key].shape[0] % k for key in args):
            return None
        r0 = self.m_rank * (n // k)
        local = node._shard(r0, r0 + n // k, self._gather, self.group)
        if local is not None:
            self.rows[label] = (r0, r0 + n // k)
            if isinstance(getattr(node, "_args", None), dict):  # the trajectories read them
                local._args = _map_tree(lambda leaf: _take_rows(leaf, n, r0, r0 + n // k, k),
                                        node._args)
        return local

    def _edge(self, u: str, v: str, edge):
        if v not in self.rows:
            return edge
        return edge._shard(*self.rows[v], self.group)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return comm.gather_last(x, self.m_group, self.n_model, self.m_rank)

    def node(self, label: str):
        return self._nodes[label]

    def edge(self, u: str, v: str):
        return self._edges[(u, v)]

    # ------------------------------------------------------------ the step
    def _source(self, u: str, v: str, val, cache: dict):
        """What edge ``u -> v`` takes of its source's output ``val``: the
        whole vector, gathered once a step per source (and per kind of
        consumer, for the gradient: a shard's rows, or a node every rank
        runs whole); a whole source into a shard is marked as consumed by
        each rank's rows."""
        if u in self.rows:
            part = v in self.rows
            if (u, part) not in cache:
                gather = comm.gather_last if part else comm.gather_whole
                cache[(u, part)] = gather(val, self.m_group, self.n_model, self.m_rank)
            return cache[(u, part)]
        if v in self.rows:
            return comm.to_partial(val, self.m_group, self.n_model)
        return val

    def _tap(self, u: str, val, cache: dict):
        """A tap of the step made whole: the step's own gather of ``u``
        where it made one, else a gather."""
        if u not in self.rows:
            return val
        for part in (True, False):
            if (u, part) in cache:
                return cache[(u, part)]
        return comm.gather_whole(val, self.m_group, self.n_model, self.m_rank)

    def step(self, taps: Tuple[str, ...] = ()) -> Callable:
        """This rank's network step, ``step(state, params, x) -> (state',
        out, taps)`` on placed trees (:meth:`place`) and local inputs; the
        network's own step where nothing is sharded.  The taps are whole
        vectors (the online trainers' updates read them)."""
        if not self.rows:
            return self.net.make_step(taps)
        return self.net._compose_step(taps, self.node, self.edge, self.fb_edges,
                                      source=self._source, tap=self._tap)

    # ------------------------------------------------------- the trainers
    def traj_comm(self) -> "comm.TrajectoryComm":
        """The collectives of a deferred-gradient trajectory on this rank's
        rows (``ops/bptt.py``, ``ops/graph_bptt.py``)."""
        return comm.TrajectoryComm(self.m_group, self.n_model, self.m_rank)

    def whole(self, label: str, x: torch.Tensor) -> torch.Tensor:
        """Node ``label``'s rows ``(..., rows)`` made whole on every rank (a
        consumer every rank computes alike, as the loss: the gradient is
        the own rows)."""
        if label not in self.rows:
            return x
        return comm.gather_whole(x, self.m_group, self.n_model, self.m_rank)

    def cols(self, x: torch.Tensor) -> torch.Tensor:
        """A drive ``(..., m)`` cut to the input node's rows where the node
        is sharded and ``m`` is its width (a one-channel drive broadcasts)."""
        inp = self.net._in_node
        return self.target_rows(inp, x) if x.shape[-1] == self.width[inp] else x

    def target_rows(self, label: str, x: torch.Tensor) -> torch.Tensor:
        """The rows of node ``label`` of a whole ``(..., n)`` value (a
        readout's targets)."""
        if label not in self.rows:
            return x
        r0, r1 = self.rows[label]
        return x[..., r0:r1]

    def _owner(self, kind: str, label: str) -> str:
        return label if kind == "nodes" else label.split("->")[1]

    def gather_params(self, tree: dict) -> dict:
        """The whole params tree from this rank's placed part (the inverse
        of :meth:`place` for the node and edge leaves): each leaf cut to a
        sharded node's rows gathered (each variable's rows of a flat leaf,
        the first axis of a matrix or block stack)."""
        if not self.rows:
            return tree
        whole = self.net.parameters_pytree()
        out = {}
        for kind in ("nodes", "edges"):
            out[kind] = {}
            for label, sub in tree.get(kind, {}).items():
                owner = self._owner(kind, label)
                out[kind][label] = {
                    key: self._unplace(leaf, whole[kind][label][key], owner)
                    for key, leaf in sub.items()}
        return out

    def _unplace(self, leaf, full, owner: str):
        if (owner not in self.rows or not isinstance(leaf, torch.Tensor)
                or tuple(leaf.shape) == tuple(full.shape)):
            return leaf
        if leaf.dim() == 1:
            rows = self.rows[owner][1] - self.rows[owner][0]
            return self._gather(leaf.reshape(-1, rows)).reshape(-1)
        return comm.gather_first(leaf, self.m_group, self.n_model)

    def reduce_grads(self, grads: dict) -> dict:
        """``sharded_train_step``'s model rule on a gradient tree: a leaf
        that a sharded node (or an edge into one) holds whole sums its
        ranks' gradients over the model group (one all-reduce each); the
        rows of a sharded leaf are this rank's already."""
        if not self.rows:
            return grads
        whole = self.net.parameters_pytree()
        out = {}
        for kind, by_label in grads.items():
            out[kind] = {}
            for label, sub in by_label.items():
                owner = self._owner(kind, label)
                out[kind][label] = {}
                for key, g in sub.items():
                    if owner in self.rows and tuple(g.shape) == \
                            tuple(whole[kind][label][key].shape):
                        g = comm.all_reduce(g, self.m_group, self.n_model)
                    out[kind][label][key] = g
        return out

    def data_share(self, n: int, what: str) -> Tuple[int, int]:
        """This data group's share ``[i0, i1)`` of ``n`` independent items
        (trials of a minibatch, starts): an equal share where the ``data``
        axis divides ``n``, else all of them, REPLICATED, with the JAX
        package's warning."""
        if self.n_data == 1:
            return 0, n
        if n % self.n_data:
            warnings.warn(
                f"{what}: {n} does not divide the mesh's 'data' axis ({self.n_data}); they "
                f"run REPLICATED (no data parallelism). Pad to a multiple of {self.n_data} "
                f"to shard them.", stacklevel=3)
            return 0, n
        per = n // self.n_data
        return self.d_rank * per, (self.d_rank + 1) * per

    def edge_part(self, u: str, v: str, key: str, leaf):
        """This rank's part of parameter ``key`` of edge ``u -> v`` (its
        target's rows of a row parameter), as :meth:`place` cuts it."""
        if v not in self.rows or leaf is None or key not in self.net.get_edge(u, v)._row_keys():
            return leaf
        return _take_rows(leaf, self.width[v], *self.rows[v], self.n_model)

    def edge_whole(self, u: str, v: str, key: str, leaf):
        """The inverse of :meth:`edge_part`: the whole parameter."""
        if v not in self.rows or leaf is None or key not in self.net.get_edge(u, v)._row_keys():
            return leaf
        if leaf.dim() == 1:
            return self._gather(leaf)
        return comm.gather_first(leaf, self.m_group, self.n_model)

    def model_parts(self, x: torch.Tensor) -> torch.Tensor:
        """``(model, *x.shape)``: every model rank's ``x``, in rank order."""
        return comm.gather_first(x[None], self.m_group, self.n_model)

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model group of each rank's ``x`` (its rows'
        part of a sum)."""
        return comm.all_reduce(x, self.m_group, self.n_model)

    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data groups of each group's ``x``."""
        if self.n_data == 1:
            return x
        return comm.all_reduce(x, self.d_group, self.n_data) / self.n_data

    def data_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every data group's ``x`` concatenated on the first axis."""
        return comm.gather_first(x, self.d_group, self.n_data)

    def data_pick(self, tree, owner: int):
        """Data group ``owner``'s ``tree`` on every rank (one all-reduce a
        leaf, the other groups adding zeros)."""
        if self.n_data == 1:
            return tree
        mine = self.d_rank == owner
        return _map_tree(lambda leaf: comm.all_reduce(leaf if mine else torch.zeros_like(leaf),
                                                      self.d_group, self.n_data), tree)

    # ------------------------------------------------------- the placement
    def place(self, tree: dict) -> dict:
        """This rank's part of a params or state tree (``Network.
        _mesh_place``): a sharded node's leaves by :func:`_take_rows` on its
        own size, the row parameters of an edge into a sharded node by
        target rows (its state stays whole), the carried feedback outputs
        by their source's rows."""
        if not self.rows:
            return tree
        k = self.n_model
        out = dict(tree)
        nodes = {}
        for label, sub in tree["nodes"].items():
            if label not in self.rows:
                nodes[label] = sub
                continue
            n, (r0, r1) = self.width[label], self.rows[label]
            nodes[label] = _map_tree(lambda leaf: _take_rows(leaf, n, r0, r1, k), sub)
        out["nodes"] = nodes
        if "edges" in tree:
            edges = {}
            for key, sub in tree["edges"].items():
                u, v = key.split("->")
                edges[key] = ({p: self.edge_part(u, v, p, leaf) for p, leaf in sub.items()}
                              if isinstance(sub, dict) else sub)
            out["edges"] = edges
        if "fb" in tree:
            out["fb"] = {u: (val if u not in self.rows else
                             _take_rows(val, self.width[u], *self.rows[u], k))
                         for u, val in tree["fb"].items()}
        return out

    def trials(self, B: int) -> Tuple[int, int]:
        """This rank's trials of ``B``: a ``data`` group's share where the
        axis divides ``B``, else all of them (replicated, with the JAX
        package's warning, once)."""
        if B not in self._trials:
            if self.n_data > 1 and B % self.n_data == 0:
                per = B // self.n_data
                self._trials[B] = (self.d_rank * per, (self.d_rank + 1) * per)
            else:
                if self.n_data > 1:
                    warnings.warn(
                        f"run_batch: batch size {B} does not divide the mesh's 'data' axis "
                        f"({self.n_data}); trials run REPLICATED (no data parallelism). Pad "
                        f"the batch to a multiple of {self.n_data} to shard it.", stacklevel=4)
                self._trials[B] = (0, B)
        return self._trials[B]

    def inputs(self, xs, B: int = None) -> Sequence:
        """The per-step inputs ``xs`` (a sequence) cut to this rank: its
        trials of a batched drive and, where the input node is sharded, its
        neurons of a drive of the node's width."""
        inp = self.net._in_node
        trials = None
        if B is not None:
            t0, t1 = self.trials(B)
            trials = None if (t0, t1) == (0, B) else (t0, t1)
        cols = self.rows.get(inp)
        if trials is None and cols is None:
            return xs
        return _Rows(xs, trials, cols, self.width[inp])

    def sweeps(self, sweeps: dict, B: int) -> dict:
        """``run_batch``'s per-trial values ``{path: (B, ...)}`` cut to this
        rank's trials and, for a sharded node (or an edge's row parameter
        into one), each trial's rows."""
        t0, t1 = self.trials(B)
        return self.sweep_rows({p: vals[t0:t1] for p, vals in sweeps.items()})

    def sweep_rows(self, sweeps: dict) -> dict:
        """Per-trial values ``{path: (B, ...)}`` with each trial's rows of a
        sharded node (or of an edge's row parameter into one)."""
        out = {}
        k = self.n_model
        for (sec, label, key), vals in sweeps.items():
            owner = label if sec == "nodes" else label.split("->")[1]
            rows = owner in self.rows and (
                sec == "nodes" or key in self.net.get_edge(*label.split("->"))._row_keys())
            if rows:
                n, (r0, r1) = self.width[owner], self.rows[owner]
                vals = torch.stack([_take_rows(v, n, r0, r1, k) for v in vals])
            out[(sec, label, key)] = vals
        return out

    def step_args(self, B: int = None, batch_vars: dict = None) -> tuple:
        """``Network.step_args`` on this rank: the local step, the placed
        start state (``B``: this rank's trials of it) and the placed,
        prepped parameters (each trial's swept values spliced in)."""
        net = self.net
        params = net.parameters_pytree()
        state = self.place(net.init_state())
        if B is None:
            return self.step(), state, net._prep_params(self.place(params), self)
        sweeps = net._resolve_batch_vars("run_batch", batch_vars, B, params, trainer=False)
        t0, t1 = self.trials(B)
        placed = net._with_sweeps(self.place(params), self.sweeps(sweeps, B))
        return self.step(), net._batch_state(state, t1 - t0), net._prep_params(placed, self)

    # ----------------------------------------------------------- the gathers
    def gather_state(self, state: dict) -> dict:
        """The whole state from every rank's part (after a run, to write
        back): each sharded node's variable rows and its carried feedback
        output; edge states are whole already."""
        if not self.rows:
            return state
        out = dict(state)
        out["nodes"] = {
            label: (st if label not in self.rows or st is None else
                    self._gather(st.reshape(-1, self.rows[label][1] - self.rows[label][0]))
                    .reshape(-1))
            for label, st in state["nodes"].items()}
        if "fb" in state:
            out["fb"] = {u: val if u not in self.rows else self._gather(val)
                         for u, val in state["fb"].items()}
        return out

    def records(self, rec0, recs, rec_info, spike_info, record_output: bool,
                B: int = None):
        """The records of :meth:`Network._run_windowed` on this rank made
        whole: each sharded node's rows gathered (once a record, at the end
        of the run), then the trials of the data groups; ``reduce`` records
        (which the loop kept per neuron) are averaged over the population
        here."""
        t0, t1 = self.trials(B) if B is not None else (0, 0)
        split = B is not None and (t0, t1) != (0, B)

        def whole(x, label):
            if x is None:
                return None
            if label in self.rows:
                x = self._gather(x)
            return comm.gather_first(x, self.d_group, self.n_data) if split else x

        def finish(out_x, var_d, spk_l):
            out_x = whole(out_x, self.net._out_node) if record_output else None
            var_d = dict(var_d)
            for (key, label, _, reduce) in rec_info:
                k = "var::" + "::".join(key)
                var_d[k] = whole(var_d[k], label)
                if reduce:
                    var_d[k] = var_d[k].mean(dim=-1)
            spk_l = [whole(x, label) for x, (label, _) in zip(spk_l, spike_info)]
            return out_x, var_d, spk_l

        return finish(*rec0), (None if recs is None else finish(*recs))


def sharded_run(net, mesh, model_axis: str = "model") -> Callable:
    """The multi-device trajectory runner of a compiled network:
    ``run(state, params, inputs) -> (state', outputs)``, where ``state`` and
    ``params`` are this rank's placed parts (``net._mesh_place``, or
    :func:`shard_network_arrays` for a network of one node), ``inputs`` the
    whole ``(T, m)`` drive (the same on every rank).  ``state'`` is this
    rank's part of the final state; ``outputs``, ``(T, n_out)``, is whole on
    every rank (one gather at the end).  As in the JAX package the
    parameters are not prepped: the step quantizes a master coupling in each
    step."""
    shard = NetworkShard(net, mesh, model_axis)
    step = shard.step()

    def run(state, params, inputs):
        inputs = net._to_device(inputs)
        outs = []
        with torch.no_grad():
            for x in shard.inputs(inputs.unbind(0)):
                state, out, _ = step(state, params, x)
                outs.append(out)
            outs = torch.stack(outs)
            if net._out_node in shard.rows:
                outs = shard._gather(outs)
        return state, outs

    return run


def sharded_train_step(net, loss_fn: Callable, optimizer, mesh, model_axis: str = "model",
                       data_axis: str = "data") -> Callable:
    """One BPTT step of a batch over the mesh:

    ``train_step(train, frozen, opt_state, state0, inputs, targets) ->
    (train', opt_state', loss)``.  ``train``/``frozen``/``state0`` are this
    rank's placed parts (``opt_state`` from ``optimizer.init(train)``);
    ``inputs`` ``(B, T, m)`` and ``targets`` ``(B, T, n_out)`` are the whole
    batch on every rank, of which each ``data`` group takes its ``B / data``
    trials.  The loss is the mean over the trials of ``loss_fn(outs,
    targets)`` on the whole outputs; the gradients are averaged over the
    ``data`` axis (one all-reduce per trainable leaf), and a leaf that a
    sharded node or edge holds whole sums its ranks' parts over ``model``
    first.  The trained leaves keep their placement.  ``optimizer`` is one
    of the port's (``train.get_optimizer``)."""
    shard = NetworkShard(net, mesh, model_axis, data_axis)
    step = shard.step()

    def train_step(train, frozen, opt_state, state0, inputs, targets):
        inputs, targets = net._to_device(inputs), net._to_device(targets)
        B = int(inputs.shape[0])
        t0, t1 = shard.trials(B)
        ins, tgts = inputs[t0:t1], targets[t0:t1]
        paths = [(kind, label, key) for kind in ("nodes", "edges")
                 for label in sorted(train.get(kind, {})) for key in sorted(train[kind][label])]
        with torch.enable_grad():
            leaves = {p: train[p[0]][p[1]][p[2]].detach().requires_grad_(True) for p in paths}
            live = {"nodes": {}, "edges": {}}
            for (kind, label, key), leaf in leaves.items():
                live[kind].setdefault(label, {})[key] = leaf
            params = net._combine(live, frozen)
            state = net._batch_state(state0, t1 - t0)
            xs = shard.inputs(ins.transpose(0, 1).unbind(0))
            outs = []
            for x in xs:
                state, out, _ = step(state, params, x)
                outs.append(out)
            outs = shard.whole(net._out_node, torch.stack(outs, dim=1))  # (trials, T, n_out)
            loss = torch.stack([loss_fn(outs[b], tgts[b]) for b in range(t1 - t0)]).mean()
            grads = torch.autograd.grad(loss, [leaves[p] for p in paths], allow_unused=True)
        split = (t0, t1) != (0, B)
        gtree = {"nodes": {}, "edges": {}}
        for (kind, label, key), g in zip(paths, grads):
            gtree[kind].setdefault(label, {})[key] = (
                torch.zeros_like(leaves[(kind, label, key)]) if g is None else g)
        gtree, loss = shard.reduce_grads(gtree), loss.detach()
        if split:  # each data group's mean over its equal share of the trials
            gtree, loss = _map_tree(shard.data_mean, gtree), shard.data_mean(loss)
        with torch.no_grad():
            new_train, opt_state = optimizer.update(gtree, opt_state, train)
        return new_train, opt_state, loss

    return train_step
