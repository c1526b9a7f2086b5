"""Networks built the same way in the JAX package and the port, from the
same seeded numpy arrays, for the graph-trajectory tests
(``test_torch_graph_bptt.py``, ``test_torch_graph_train.py``): every
topology of ``tests/test_graph_bptt.py``, and helpers that read trained
leaves and gradients."""

import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

import rectipy_tpu as J
import rectipy_tpu_torch as P
from rectipy_tpu.network import _graph_weights_args as j_weights_args
from rectipy_tpu.ops.graph_bptt import make_graph_traj as j_make_graph_traj
from rectipy_tpu.ops.sparse import block_random_connectivity
from rectipy_tpu_torch.ops.graph_bptt import graph_weights_args, make_graph_traj

# the topologies of the trajectory tests
TRAJ_TOPOS = ["two_pop", "two_pop_masked", "trainable_mask", "diag_masked", "feedback",
              "fb_delay", "delay", "filter", "memory_filter", "heun", "block_fb",
              "block_fb_delay", "block_coupling_free"]
PREFIX = {"jax": "neuron_model_templates.", "torch": "rectipy_tpu_torch.models."}
TANH = "rate_neurons.leaky_integrator.tanh"
QIF = "spiking_neurons.qif.qif"


def _cls(pkg, feedback=False):
    mod = J if pkg == "jax" else P
    return mod.FeedbackNetwork if feedback else mod.Network


def _new(pkg, feedback=False, dtype="float64", dt=1e-2):
    if pkg == "jax":
        return _cls(pkg, feedback)(dt, dtype=jnp.dtype(dtype))
    return _cls(pkg, feedback)(dt, dtype=getattr(torch, dtype), device="cpu")


def _tanh(net, pkg, label, W, train=True, **kw):
    net.add_diffeq_node(label, PREFIX[pkg] + TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r", target_var="li_op/r_in",
                        train_params=["weights"] if train else None, **kw)


def _block_qif(pkg, bdtype=None, dtype="float64", train=True):
    """The N=100,352 showcase topology at N=128 (test_graph_bptt.py:1030):
    an input node into a QIF population without a coupling, all of whose
    recurrence rides a delayed block-sparse feedback self-edge."""
    N, BS, dmax = 128, 32, 5
    nb = N // BS
    A = block_random_connectivity(N, N, 16, block_size=BS, seed=0)
    ring = np.abs(A.cols - np.arange(nb)[:, None])
    ring = np.minimum(ring, nb - ring).astype(float)
    d_blk = np.rint(ring / max(ring.max(), 1.0) * dmax).astype(int)
    etas = 1000.0 + 200.0 * np.random.default_rng(1).standard_normal(N)
    net = _new(pkg, True, dtype, dt=1e-3)
    net.add_func_node("inp", 1, activation_function="identity")
    net.add_diffeq_node("qif", PREFIX[pkg] + QIF, n=N, input_var="I_ext", output_var="s",
                        spike_var="spike", spike_def="v", op="qif_op", spike_threshold=1e2,
                        spike_reset=-1e2, node_vars={"all/qif_op/eta": etas})
    net.add_edge("inp", "qif", weights=np.random.default_rng(7).normal(size=(N, 1)))
    kw = {"block_dtype": bdtype} if bdtype else {}
    net.add_edge("qif", "qif", weights=A, delays=d_blk, feedback=True,
                 train="gd" if train else None, **kw)
    net.compile()
    return net


def build(pkg, topo):
    """One network of each topology, built the same way in both packages
    from the same seeded numpy arrays; ``(net, T, n_in)``."""
    rng = np.random.default_rng(zlib.crc32(topo.encode()))
    if topo in ("two_pop", "two_pop_masked"):
        n1, n2 = 8, 6
        net = _new(pkg)
        net.add_func_node("inp", 3, activation_function="identity")
        net.add_diffeq_node("pop1", PREFIX[pkg] + QIF,
                            weights=np.abs(rng.normal(size=(n1, n1))) * 0.4, input_var="I_ext",
                            output_var="s", source_var="s", target_var="s_in", op="qif_op",
                            spike_var="spike", spike_def="v", spike_threshold=100.0,
                            spike_reset=-100.0, node_vars={"all/qif_op/eta": 6.0 + rng.random(n1)},
                            train_params=["weights", "eta"])
        _tanh(net, pkg, "pop2", rng.normal(size=(n2, n2)) * 0.3)
        net.add_func_node("out", 2, activation_function="tanh")
        net.add_edge("inp", "pop1", weights=rng.normal(size=(n1, 3)))
        kw = ({"mask": (rng.random((n2, n1)) < 0.5).astype(float)}
              if topo == "two_pop_masked" else {})
        net.add_edge("pop1", "pop2", weights=rng.normal(size=(n2, n1)) * 0.5, train="gd", **kw)
        net.add_edge("pop2", "out", weights=rng.normal(size=(2, n2)), train="gd")
        return net.compile(), 200, 3
    n = 6
    if topo == "trainable_mask":
        net = _new(pkg)
        _tanh(net, pkg, "pop1", rng.normal(size=(7, 7)) * 0.2)
        _tanh(net, pkg, "pop2", rng.normal(size=(5, 5)) * 0.2, train=False)
        net.add_edge("pop1", "pop2", weights=rng.normal(size=(5, 7)) * 0.5, train="gd",
                     mask=rng.random((5, 7)), train_params=["weights", "mask"])
        return net.compile(), 80, 7
    if topo == "diag_masked":
        net = _new(pkg)
        W0 = rng.normal(size=(n, n)) * 0.3
        _tanh(net, pkg, "a", W0)
        _tanh(net, pkg, "b", W0 * 0.5, train=False)
        net.add_edge("a", "b", weights=rng.uniform(0.5, 1.5, n),
                     mask=(rng.random((n, n)) < 0.6).astype(float), train="gd")
        return net.compile(), 80, n
    if topo in ("feedback", "fb_delay"):
        net = _new(pkg, feedback=True)
        _tanh(net, pkg, "p1", rng.normal(size=(n, n)) * 0.2)
        _tanh(net, pkg, "p2", rng.normal(size=(n, n)) * 0.2)
        if topo == "feedback":
            net.add_edge("p1", "p2", weights=np.eye(n))
        else:
            net.add_edge("p1", "p2", weights=rng.normal(size=(n, n)) * 0.4, train="gd",
                         delays=(np.arange(n) % 3) + 1)
        net.add_edge("p2", "p1", weights=rng.normal(size=(n, n)) * 0.1, feedback=True,
                     train="gd")
        return net.compile(), 80, n
    if topo in ("delay", "filter", "memory_filter"):
        net = _new(pkg)
        W1 = rng.normal(size=(n, n)) * 0.2
        _tanh(net, pkg, "pop1", W1)
        _tanh(net, pkg, "pop2", W1 * 0.5, train=False)
        F0 = np.eye(n) * 0.8 + rng.normal(size=(n, n)) * 0.05
        kw = {"delay": {"delays": (np.arange(n) % 3) + 1},
              "filter": {"filter_weights": F0},
              # max_delay 86: the one ring-buffer filter stage at any depth
              "memory_filter": {"delays": (np.arange(n) * 17) % 100 + 1,
                                "filter_weights": F0}}[topo]
        net.add_edge("pop1", "pop2", weights=rng.normal(size=(n, n)) * 0.4, train="gd", **kw)
        return net.compile(), 120 if topo == "memory_filter" else 80, n
    if topo == "heun":
        net = _new(pkg)
        _tanh(net, pkg, "p1", rng.normal(size=(8, 8)) * 0.3, integrator="heun")
        _tanh(net, pkg, "p2", rng.normal(size=(8, 8)) * 0.3)
        net.add_edge("p1", "p2", weights=rng.normal(size=(8, 8)) * 0.4, train="gd")
        return net.compile(), 120, 8
    if topo in ("block_fb", "block_fb_delay"):
        # a block-sparse feedback self-edge (stateless and delayed) on a
        # population with a zero coupling (test_graph_bptt.py:894)
        W = SimpleNamespace(blocks=0.1 * rng.standard_normal((2, 2, 4, 4)),
                            cols=np.stack([rng.permutation(2)[:2] for _ in range(2)]))
        delays = rng.integers(0, 6, size=(2, 2)) if topo == "block_fb_delay" else None
        net = _new(pkg, feedback=True)
        _tanh(net, pkg, "pop", np.zeros((8, 8)), train=False)
        net.add_edge("pop", "pop", weights=W, delays=delays, feedback=True, train="gd")
        return net.compile(), 40, 8
    if topo == "block_coupling_free":
        return _block_qif(pkg), 500, 1
    raise ValueError(topo)


def _flat(d, prefix=()):
    if isinstance(d, dict):
        out = {}
        for k, v in d.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: d}


def _nest(flat, base):
    out = {sec: {lbl: dict(sub) for lbl, sub in base[sec].items()} for sec in base}
    for (sec, lbl, k), v in flat.items():
        out[sec][lbl][k] = v
    return out


def _float_leaves(args, floating):
    return {p: v for p, v in _flat(args).items() if floating(v)}


def _drive(topo, T, n_in):
    rng = np.random.default_rng(zlib.crc32(topo.encode()) + 1)
    if topo == "block_coupling_free":
        xs = np.zeros((T, 1))
        xs[T // 4:, 0] = 3.0
        return xs, rng.normal(size=(T, 128)) * 0.1
    return rng.normal(size=(T, n_in)) * (3.0 if topo.startswith("two_pop") else 1.0), None


def _fit(pkg, topo, fused, epochs=3, **kw):
    net, T, n_in = build(pkg, topo)
    xs, _ = _drive(topo, T, n_in)
    tgt = np.random.default_rng(5).normal(size=(T, net.n_out)) * 0.1
    obs = net.fit_bptt([xs] * epochs, [tgt] * epochs, optimizer="adam", lr=1e-2, verbose=False,
                       fused_bptt=fused, **kw)
    return net, np.asarray(obs["epoch_loss"])


def _trained(net, topo):
    """The trained leaves as numpy arrays, by path."""
    out = {}
    for path in net.trainable_paths():
        kind, label, key = (path.split("/") if isinstance(path, str) else path)
        holder = (net.get_node(label)._args if kind == "nodes"
                  else net.get_edge(*label.split("->")).params)
        out[(kind, label, key)] = np.asarray(holder[key].detach().cpu()
                                             if isinstance(holder[key], torch.Tensor)
                                             else holder[key])
    return out


def _block_grad(pkg, net, ins, tgt):
    """The gradient of the mean squared error of ``net``'s graph trajectory
    with respect to its block feedback edge."""
    if pkg == "jax":
        traj, spec = j_make_graph_traj(net)
        w, a = j_weights_args(spec, net.parameters_pytree())
        st = net.init_state()
        C0 = {"Y": {lbl: st["nodes"][lbl] for lbl in spec.pop_labels}, "fb": st["fb"],
              "E": {ek: spec.estate_pack[ek](st["edges"][ek]) for ek in spec.stateful_edges}}
        g = jax.grad(lambda w: jnp.mean((traj(w, a, C0, jnp.asarray(ins))[1] - tgt) ** 2))(w)
        return np.asarray(g["e:qif->qif"])
    traj, spec = make_graph_traj(net)
    w, a = graph_weights_args(spec, net.parameters_pytree())
    w = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    _, outs = traj(w, a, net._graph_pack(spec, net.init_state()), torch.as_tensor(ins))
    loss = ((outs - torch.as_tensor(tgt)) ** 2).mean()
    return torch.autograd.grad(loss, [w["e:qif->qif"]])[0].numpy()
