"""Circuits of mixed node templates and the graph-editing calls, against the
JAX package.

Mirrors ``tests/test_network.py``: ``test_circuit_template_heterogeneous_
equations_auto_expand`` (:912; the expansion into one node per template
group, its golden match with the hand-built network, the refusals) and the
``pop_node`` part of :197, plus ``clear`` and ``detach``; and trains an
expanded circuit through the graph trajectory against plain autograd and
the JAX package's fit; and ``convert.load_jax_params`` of the expanded
circuit and of every network of the graph-trajectory tests.  float64, the
same seeded numpy inputs through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rectipy_tpu as J
import rectipy_tpu_torch as P
from _torch_graph_cases import TRAJ_TOPOS, _drive, build
from rectipy_tpu.dsl.parser import (CircuitTemplate as JCircuit, NodeTemplate as JNode,
                                    OperatorTemplate as JOp, VarSpec as JVar)
from rectipy_tpu_torch.dsl.parser import (CircuitTemplate, NodeTemplate, OperatorTemplate,
                                          TemplateError, VarSpec)

PREFIX = {"jax": "neuron_model_templates.", "torch": "rectipy_tpu_torch.models."}
TANH = "rate_neurons.leaky_integrator.tanh"
SIG = "rate_neurons.leaky_integrator.sigmoid"
N_T, N_S = 4, 3
N = N_T + N_S


def _dsl(pkg):
    if pkg == "jax":
        return JCircuit, JNode, JOp, JVar
    return CircuitTemplate, NodeTemplate, OperatorTemplate, VarSpec


def _net(pkg):
    return (J.Network(1e-2, dtype=jnp.float64) if pkg == "jax"
            else P.Network(1e-2, dtype=torch.float64, device="cpu"))


def _circuit(pkg, edges=("tt", "st"), target="qualified"):
    """Four tanh members with per-member etas and three sigmoid members: an
    intra-tanh recurrence and a tanh -> sigmoid projection, both declared on
    the full (7, 7) circuit index space."""
    Circuit, Node, Op, Var = _dsl(pkg)
    rng = np.random.default_rng(47)
    base, sig_t = Node.from_yaml(PREFIX[pkg] + TANH), Node.from_yaml(PREFIX[pkg] + SIG)

    def variant(eta):  # per-member parameter heterogeneity inside the group
        ops = []
        for op in base.operators:
            variables = dict(op.variables)
            if "eta" in variables:
                variables["eta"] = Var(variables["eta"].role, float(eta))
            ops.append(Op(op.name, list(op.equations), variables))
        return Node(base.name, ops)

    nodes = {f"t{i}": variant(e) for i, e in enumerate(np.linspace(-0.5, 0.5, N_T))}
    nodes.update({f"s{i}": sig_t for i in range(N_S)})
    circ = Circuit("mix", nodes)
    W_tt = np.zeros((N, N))
    W_tt[:N_T, :N_T] = rng.normal(size=(N_T, N_T)) * 0.4
    W_st = np.zeros((N, N))
    W_st[N_T:, :N_T] = rng.normal(size=(N_S, N_T)) * 0.7
    tv = {"qualified": ("t0/li_op/r_in", "s0/li_op/r_in"),
          "bare": ("li_op/r_in", "li_op/r_in")}[target]
    if "tt" in edges:
        circ.add_edges_from_matrix(source_var="tanh_op/r", target_var=tv[0], weight=W_tt)
    if "st" in edges:
        circ.add_edges_from_matrix(source_var="tanh_op/r", target_var=tv[1], weight=W_st)
    if "bad" in edges:  # sigmoid -> tanh entries on a tanh -> sigmoid edge
        W_bad = W_st.copy()
        W_bad[0, N_T:] = 1.0
        circ.add_edges_from_matrix(source_var="tanh_op/r", target_var=tv[1], weight=W_bad)
    return circ, W_tt[:N_T, :N_T], W_st[N_T:, :N_T]


def _expanded(pkg, **kw):
    circ, _, _ = _circuit(pkg)
    net = _net(pkg)
    out = net.add_diffeq_node("c", node=circ, input_var="t0/li_op/I_ext",
                              output_var="sigmoid_op/r",
                              node_vars={"all/li_op/tau": np.linspace(8.0, 14.0, N)}, **kw)
    return net, out


def test_circuit_of_mixed_templates_expands_like_jax_and_by_hand():
    """One node per template group (``c.tanh``, ``c.sigmoid``), wired by a
    Linear edge cut from the circuit's matrix; the run equals the
    hand-built two-node network and the JAX package's expansion."""
    net, out_node = _expanded("torch")
    assert sorted(net.nodes) == ["c.sigmoid", "c.tanh"]
    assert out_node is net.get_node("c.sigmoid")
    _, W_tt, W_st = _circuit("torch")
    taus = np.linspace(8.0, 14.0, N)
    hand = _net("torch")
    hand.add_diffeq_node("tanh", PREFIX["torch"] + TANH, weights=W_tt, input_var="li_op/I_ext",
                         output_var="tanh_op/r", source_var="tanh_op/r",
                         target_var="li_op/r_in",
                         node_vars={"all/li_op/eta": np.linspace(-0.5, 0.5, N_T),
                                    "all/li_op/tau": taus[:N_T]})
    hand.add_diffeq_node("sig", PREFIX["torch"] + SIG, N=N_S, input_var="li_op/r_in",
                         output_var="sigmoid_op/r", node_vars={"all/li_op/tau": taus[N_T:]})
    hand.add_edge("tanh", "sig", weights=W_st)
    inp = np.random.default_rng(3).normal(size=(25, N_T))
    o1 = net.run(inp, verbose=False).to_numpy("out")
    o2 = hand.run(inp, verbose=False).to_numpy("out")
    oj = _expanded("jax")[0].run(inp, verbose=False).to_numpy("out")
    assert o1.shape == (25, N_S)
    np.testing.assert_allclose(o1, o2, atol=1e-12)
    np.testing.assert_allclose(o1, oj, rtol=1e-12, atol=1e-14)
    assert np.std(o1[-1]) > 1e-8, "coupled dynamics collapsed"


@pytest.mark.parametrize("case,match", [
    ("ambiguous", "exactly one node template"),  # li_op/r_in is on both groups
    ("outside", "outside"),  # weight mass outside the owner block
    ("op", "op"),  # the op shorthand
    ("weights", "add_edges_from_matrix"),  # a coupling beside the circuit's
    ("undriven", "neither provides"),  # a group joined to no other
])
def test_circuit_refusals_match_jax(case, match):
    """The expansion refuses what the JAX package refuses, with its
    message."""
    kw = {}
    if case == "ambiguous":
        circ = _circuit("torch", target="bare")[0]
    elif case == "outside":
        circ = _circuit("torch", edges=("tt", "bad"))[0]
    elif case == "undriven":
        circ = _circuit("torch", edges=("tt",))[0]
    else:
        circ = _circuit("torch")[0]
        kw = {"op": dict(op="li_op"), "weights": dict(weights=np.eye(N))}[case]
    for pkg, err in (("torch", TemplateError), ("jax", Exception)):
        c = circ if pkg == "torch" else _jax_twin(case)
        with pytest.raises(err, match=match):
            _net(pkg).add_diffeq_node("c", node=c, input_var="t0/li_op/I_ext",
                                      output_var="sigmoid_op/r", **kw)


def _jax_twin(case):
    if case == "ambiguous":
        return _circuit("jax", target="bare")[0]
    if case == "outside":
        return _circuit("jax", edges=("tt", "bad"))[0]
    if case == "undriven":
        return _circuit("jax", edges=("tt",))[0]
    return _circuit("jax")[0]


def test_lowering_a_mixed_circuit_points_at_add_diffeq_node():
    from rectipy_tpu_torch.dsl.lower import lower

    with pytest.raises(TemplateError, match="add_diffeq_node"):
        lower(_circuit("torch")[0], device="cpu")


def test_expanded_circuit_trains_through_the_graph_trajectory_like_jax():
    """Both groups' trained couplings and the inter-group edge: fit_bptt
    takes the graph trajectory, and its losses and weights equal plain
    autograd's and the JAX package's fit."""
    rng = np.random.default_rng(48)
    inp = rng.normal(size=(60, N_T))
    tgt = rng.normal(size=(60, N_S)) * 0.1
    res = {}
    for pkg, fused in (("torch", True), ("torch", False), ("jax", "auto")):
        net, _ = _expanded(pkg, train_params=["weights"])
        net.get_edge("c.tanh", "c.sigmoid").train_keys = ["weights"]
        obs = net.fit_bptt([inp] * 4, [tgt] * 4, optimizer="adam", lr=1e-2, verbose=False,
                           fused_bptt=fused)
        if pkg == "torch":
            assert net.last_fit["trajectory"] == ("graph" if fused else "autograd")
        w = net.get_node("c.tanh")["weights"]
        e = net.get_edge("c.tanh", "c.sigmoid").params["weights"]
        res[(pkg, fused)] = (np.asarray(obs["epoch_loss"]),
                             np.asarray(w.detach() if isinstance(w, torch.Tensor) else w),
                             np.asarray(e.detach() if isinstance(e, torch.Tensor) else e))
    (lg, wg, eg), (lp, wp, ep), (lj, wj, ej) = res.values()
    np.testing.assert_allclose(lg, lp, rtol=1e-8)
    np.testing.assert_allclose(lg, lj, rtol=1e-8)
    for a, b, c in ((wg, wp, wj), (eg, ep, ej)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-10)
    assert lg[-1] < lg[0]


def test_pop_node_clear_and_detach():
    """``pop_node`` removes a node with its edges and returns it, as in the
    JAX package (test_network.py:197); ``clear`` empties the graph;
    ``detach`` cuts each state out of any autograd graph."""
    nets = {}
    for pkg in ("torch", "jax"):
        net = _net(pkg)
        net.add_func_node("inp", 3, activation_function="identity")
        net.add_diffeq_node("rnn", PREFIX[pkg] + TANH, weights=np.eye(4) * 0.3,
                            input_var="li_op/I_ext", output_var="li_op/v",
                            source_var="tanh_op/r", target_var="li_op/r_in")
        net.add_func_node("out", 2, activation_function="tanh")
        net.add_edge("inp", "rnn", weights=np.ones((4, 3)))
        net.add_edge("rnn", "out", weights=np.ones((2, 4)))
        net.compile()
        out = net.get_node("out")
        assert net.pop_node("out") is out
        assert len(net) == 2 and not net.graph.has_edge("rnn", "out")
        nets[pkg] = net
    inp = np.random.default_rng(0).normal(size=(10, 3))
    np.testing.assert_allclose(nets["torch"].run(inp, verbose=False).to_numpy("out"),
                               nets["jax"].run(inp, verbose=False).to_numpy("out"),
                               rtol=1e-12)
    net = nets["torch"]
    node = net.get_node("rnn")
    node.y = node.y * torch.ones((), dtype=node.y.dtype, requires_grad=True)
    assert node.y.grad_fn is not None
    net.detach(requires_grad=False)
    assert node.y.grad_fn is None and not node.y.requires_grad
    net.clear()
    assert len(net) == 0 and net.graph.number_of_edges() == 0


def _host_tree(tree):
    """A JAX params or state tree as numpy arrays (tuples kept)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_host_tree(v) for v in tree)
    return None if tree is None else np.asarray(tree)


@pytest.mark.parametrize("topo", TRAJ_TOPOS)
def test_load_jax_params_carries_every_graph_case(topo):
    """``convert.load_jax_params`` carries each network of these tests: the
    JAX network's parameters and its state after a few steps (population
    states, edge buffers and filter states, a block edge's ``(hist, t)``,
    the carried feedback outputs) overwrite a perturbed port network, and
    both then run the same records."""
    from rectipy_tpu_torch import load_jax_params

    jnet, T, n_in = build("jax", topo)
    tnet, _, _ = build("torch", topo)
    xs, _ = _drive(topo, T, n_in)
    xs = xs[:40]
    jnet.run(xs[:7], verbose=False)
    for sec, sub in tnet.parameters_pytree().items():  # the load must overwrite these
        for label, leaves in sub.items():
            owner = (getattr(tnet.get_node(label), "_args", {}) if sec == "nodes"
                     else tnet.get_edge(*label.split("->")).params)
            for k, v in leaves.items():
                if isinstance(v, torch.Tensor) and v.is_floating_point():
                    owner[k] = v * 1.1
    load_jax_params(tnet, _host_tree(jnet.parameters_pytree()), _host_tree(jnet.init_state()))
    a = np.asarray(jnet.run(xs[7:], verbose=False).to_numpy("out"))
    b = tnet.run(xs[7:], verbose=False).to_numpy("out")
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12)


def test_load_jax_params_carries_an_expanded_circuit():
    """The expanded circuit's parameters and state after a few steps carry
    from the JAX network into a perturbed port network."""
    from rectipy_tpu_torch import load_jax_params

    jnet, _ = _expanded("jax")
    tnet, _ = _expanded("torch")
    inp = np.random.default_rng(5).normal(size=(30, N_T))
    jnet.run(inp[:6], verbose=False)
    for label in tnet.nodes:
        args = tnet.get_node(label)._args
        for k, v in list(args.items()):
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                args[k] = v * 1.1
    load_jax_params(tnet, _host_tree(jnet.parameters_pytree()), _host_tree(jnet.init_state()))
    np.testing.assert_allclose(tnet.run(inp[6:], verbose=False).to_numpy("out"),
                               jnet.run(inp[6:], verbose=False).to_numpy("out"),
                               rtol=1e-12, atol=1e-14)
