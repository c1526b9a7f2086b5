"""The port's ``FeedbackNetwork`` against the JAX package on the CPU:
one-step-delayed feedback edges, the re-entrant compile that moves them into
``_fb_graph``, the feedback outputs carried across runs and dropped by
``reset``, training through a feedback edge, the other trainers on a
feedback network, and populations with either fused step attached.

Float64 unless a fused kernel needs float32, the same seeded numpy inputs
through both packages; the cases mirror ``tests/test_network.py`` and
``tests/test_coverage_extras.py`` (the reference line of each case is named
in its comment)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import FeedbackNetwork as JFeedbackNetwork
from rectipy_tpu.ops.generic_fused import attach_generic_fused_step as j_attach
from rectipy_tpu.ops.kernels import attach_fused_qif_step as j_qif_attach
from rectipy_tpu_torch import (FeedbackNetwork, attach_fused_qif_step, attach_generic_fused_step,
                               load_jax_params)

J, T_ = "neuron_model_templates.", "rectipy_tpu_torch.models."
TANH = "rate_neurons.leaky_integrator.tanh"
LIF = "spiking_neurons.lif.lif"
PKGS = ("jax", "torch")


def _net(pkg, dt=1e-2, dtype="float64"):
    if pkg == "jax":
        return JFeedbackNetwork(dt, dtype=getattr(jnp, dtype))
    return FeedbackNetwork(dt, dtype=getattr(torch, dtype), device="cpu")


def _prefix(pkg):
    return J if pkg == "jax" else T_


def _pops(pkg, weights, output_var="li_op/v", **kw):
    """Tanh populations p1, p2, ... with the given couplings."""
    net = _net(pkg)
    for i, W in enumerate(weights):
        net.add_diffeq_node(f"p{i + 1}", _prefix(pkg) + TANH, weights=W,
                            input_var="li_op/I_ext", output_var=output_var,
                            source_var="tanh_op/r", target_var="li_op/r_in", **kw)
    return net


def test_feedback_network_matches_jax():
    # test_network.py:389 -- the feedback edge changes the output from the
    # second step on (the first reads the initial state); compile is
    # re-entrant; outputs against JAX
    n = 5
    rng = np.random.default_rng(10)
    W1, W2 = rng.normal(size=(n, n)) * 0.2, rng.normal(size=(n, n)) * 0.2
    k_ff, k_fb = rng.normal(size=(n, n)) * 0.5, rng.normal(size=(n, n)) * 0.5
    T = 30
    inp = rng.normal(size=(T, n))

    def build(pkg, with_fb):
        net = _pops(pkg, (W1, W2))
        net.add_edge("p1", "p2", weights=k_ff)
        if with_fb:
            net.add_edge("p2", "p1", weights=k_fb, feedback=True)
        return net

    outs = {}
    for pkg in PKGS:
        net_fb = build(pkg, True)
        out_fb = net_fb.run(inp, verbose=False).to_numpy("out")
        out_ff = build(pkg, False).run(inp, verbose=False).to_numpy("out")
        net_fb.compile()
        net_fb.compile()
        out_fb2 = build(pkg, True).run(inp, verbose=False).to_numpy("out")
        outs[pkg] = (out_fb, out_ff, out_fb2)
    out_fb, out_ff, out_fb2 = outs["torch"]
    assert out_fb.shape == out_ff.shape
    np.testing.assert_allclose(out_fb[0], out_ff[0], atol=1e-12)
    assert np.mean(np.abs(out_fb[5:] - out_ff[5:])) > 1e-8
    np.testing.assert_allclose(out_fb, out_fb2, atol=1e-12)
    for a, b in zip(outs["torch"], outs["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


def test_feedback_network_bptt_trains_feedback_edge_like_jax():
    # test_network.py:607 -- gradients flow through the delayed feedback
    # edge: the epoch losses and both weight sets against JAX
    n = 6
    rng = np.random.default_rng(17)
    W1, W2 = rng.normal(size=(n, n)) * 0.2, rng.normal(size=(n, n)) * 0.2
    k_fb0 = rng.normal(size=(n, n)) * 0.1
    T = 60
    inp = rng.normal(size=(T, n))
    k_teacher = rng.normal(size=(n, n)) * 0.3

    def build(pkg, k_fb, train):
        net = _pops(pkg, (W1, W2))
        net.add_edge("p1", "p2", weights=np.eye(n))
        net.add_edge("p2", "p1", weights=k_fb, feedback=True, train=train)
        return net

    target = build("torch", k_teacher, None).run(inp, verbose=False).to_numpy("out")
    res = {}
    for pkg in PKGS:
        student = build(pkg, k_fb0, "gd")
        obs = student.fit_bptt([inp] * 20, [target] * 20, optimizer="adam", lr=1e-2,
                               verbose=False)
        res[pkg] = (np.asarray(obs["epoch_loss"]),
                    np.asarray(student.get_edge("p2", "p1").weights), student)
    losses, w_after, tnet = res["torch"]
    assert tnet.last_fit["trajectory"] == "graph"
    assert losses[-1] < losses[0] * 0.8, f"no training through feedback: {losses}"
    assert np.abs(w_after - k_fb0).max() > 1e-4, "feedback weights untouched"
    # adam divides each gradient entry by its own running scale, so the
    # round-off of the nearly-zero entries reaches the updates: rtol 1e-7
    np.testing.assert_allclose(losses, res["jax"][0], rtol=1e-7)
    np.testing.assert_allclose(w_after, res["jax"][1], rtol=1e-7, atol=1e-10)
    # plain autograd (fused_bptt=False) takes the same steps
    plain = build("torch", k_fb0, "gd")
    obs = plain.fit_bptt([inp] * 20, [target] * 20, optimizer="adam", lr=1e-2, verbose=False,
                         fused_bptt=False)
    assert plain.last_fit["trajectory"] == "autograd"
    np.testing.assert_allclose(np.asarray(obs["epoch_loss"]), losses, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(plain.get_edge("p2", "p1").weights), w_after,
                               rtol=1e-7, atol=1e-10)


def test_feedback_network_step_mode_matches_jax():
    # truncated BPTT through the feedback edge: the fb outputs ride in the
    # carried state across chunks
    n, T = 4, 45
    rng = np.random.default_rng(27)
    W1, W2, k_fb = (rng.normal(size=(n, n)) * 0.3 for _ in range(3))
    inp, tgt = rng.normal(size=(T, n)), rng.normal(size=(T, n))
    res = {}
    for pkg in PKGS:
        net = _pops(pkg, (W1, W2))
        net.add_edge("p1", "p2", weights=np.eye(n))
        net.add_edge("p2", "p1", weights=k_fb, feedback=True, train="gd")
        obs = net.fit_bptt(inp, tgt, optimizer="sgd", lr=5e-2, update_steps=10,
                           sampling_steps=4, verbose=False)
        res[pkg] = (obs.to_numpy("loss"), obs.to_numpy("out"),
                    np.asarray(net.get_edge("p2", "p1").weights),
                    np.asarray(net._fb_store["p2"]))
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-13)


def test_feedback_network_eager_forward_carries_fb():
    # test_network.py:642 -- step-by-step forward() carries the feedback
    # store; after reset() a run gives the same outputs; both against JAX
    n = 4
    rng = np.random.default_rng(18)
    Ws = [rng.normal(size=(n, n)) * 0.2 for _ in range(2)]
    x = rng.normal(size=(5, n))
    res = {}
    for pkg in PKGS:
        net = _pops(pkg, Ws)
        net.add_edge("p1", "p2", weights=np.eye(n))
        net.add_edge("p2", "p1", weights=np.eye(n), feedback=True)
        net.compile()
        eager = np.stack([np.asarray(net.forward(x[t])) for t in range(5)])
        net.reset()
        res[pkg] = (eager, net.run(x, verbose=False).to_numpy("out"))
    np.testing.assert_allclose(res["torch"][0], res["torch"][1], atol=1e-12)
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


def test_feedback_initial_state_and_reset_semantics():
    # test_network.py:682 -- the first step reads the source's current
    # out-slice; the store carries the last output across runs; reset()
    # clears it
    n = 3
    v0 = -2.0
    stores = {}
    for pkg in PKGS:
        net = _pops(pkg, [np.zeros((n, n))] * 2, node_vars={"all/li_op/v": v0})
        net.add_edge("p1", "p2", weights=np.eye(n))
        net.add_edge("p2", "p1", weights=np.eye(n), feedback=True)
        net.compile()
        np.testing.assert_allclose(np.asarray(net.init_state()["fb"]["p2"]), v0 * np.ones(n))
        net.run(np.ones((5, n)), verbose=False)
        assert net._fb_store, "the feedback store should carry across runs"
        carried = np.asarray(net._fb_store["p2"])
        np.testing.assert_allclose(np.asarray(net.init_state()["fb"]["p2"]), carried)
        net.reset()
        assert not net._fb_store
        np.testing.assert_allclose(np.asarray(net.init_state()["fb"]["p2"]), np.zeros(n))
        stores[pkg] = carried
    np.testing.assert_allclose(stores["torch"], stores["jax"], rtol=1e-12)


def test_feedback_network_ridge_and_rls_match_jax():
    # test_coverage_extras.py:150 -- fit_ridge (readout node added behind
    # the feedback loop), test(), and an RLS readout fitted online
    n = 6
    rng = np.random.default_rng(3)
    Ws = [rng.normal(size=(n, n)) * 0.2 for _ in range(2)]
    W_in, k_fb = rng.normal(size=(n, 2)), rng.normal(size=(n, n)) * 0.1
    T = 100
    inp, tgt = rng.normal(size=(T, 2)), rng.normal(size=(T, 3)) * 0.1

    def build(pkg):
        net = _net(pkg)
        net.add_func_node("inp", 2, activation_function="identity")
        for label, W in zip(("p1", "p2"), Ws):
            net.add_diffeq_node(label, _prefix(pkg) + TANH, weights=W,
                                input_var="li_op/I_ext", output_var="tanh_op/r",
                                source_var="tanh_op/r", target_var="li_op/r_in")
        net.add_edge("inp", "p1", weights=W_in)
        net.add_edge("p1", "p2", weights=np.eye(n))
        net.add_edge("p2", "p1", weights=k_fb, feedback=True)
        return net

    res = {}
    for pkg in PKGS:
        net = build(pkg)
        obs = net.fit_ridge(inp, tgt, sampling_steps=1, verbose=False, alpha=1e-3)
        assert np.asarray(obs["w_out"]).shape == (n, 3) and "readout" in net.nodes
        obs2, loss = net.test(inp, tgt, sampling_steps=1, verbose=False)
        assert np.isfinite(loss)
        rls_net = build(pkg)
        rls_net.add_func_node("out", 3, activation_function="identity")
        rls_net.add_edge("p2", "out", train="rls", beta=0.99)
        rls_obs = rls_net.fit_rls(inp, tgt, update_steps=2, sampling_steps=5, verbose=False)
        res[pkg] = (np.asarray(obs["w_out"]), np.asarray(obs["y"]), obs2.to_numpy("out"),
                    np.asarray(loss), rls_obs.to_numpy("out"), rls_obs.to_numpy("loss"),
                    np.asarray(rls_net.get_edge("p2", "out").weights))
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)


def test_feedback_pop_edge_after_compile():
    # test_coverage_extras.py:308 -- pop_edge finds a feedback edge in
    # _fb_graph; the pruned network runs as a feedforward chain
    n = 4
    outs = {}
    for pkg in PKGS:
        net = _net(pkg)
        for lbl in ("a", "b"):
            net.add_diffeq_node(lbl, _prefix(pkg) + TANH, weights=np.zeros((n, n)),
                                input_var="li_op/I_ext", output_var="li_op/v",
                                source_var="tanh_op/r", target_var="li_op/r_in")
        net.add_edge("a", "b", weights=np.eye(n))
        net.add_edge("b", "a", weights=np.eye(n) * 0.5, feedback=True)
        net.compile()
        assert net.pop_edge("b", "a") is not None
        with pytest.raises(KeyError):
            net.get_edge("b", "a")
        obs = net.run(np.ones((5, n)), verbose=False)
        assert obs.to_numpy("out").shape[0] == 5
        outs[pkg] = obs.to_numpy("out")
        assert net.pop_edge("a", "b") is not None
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-12)


def test_feedback_network_parameters_and_describe_match_jax():
    # parameters() yields the trained feedback edge after compile; the
    # summary tags it, as the JAX package does
    n = 3
    rng = np.random.default_rng(4)
    text = {}
    for pkg in PKGS:
        net = _pops(pkg, [rng.normal(size=(n, n))] * 2, train_params=["weights"])
        net.add_edge("p1", "p2", weights=np.eye(n))
        net.add_edge("p2", "p1", weights=np.eye(n), feedback=True, train="gd")
        net.compile()
        assert len(list(net.parameters())) == 3
        assert ("edges", "p2->p1", "weights") in net.trainable_paths()
        text[pkg] = net.describe()
    assert "p2 -> p1 [feedback]: Linear (3x3 float64, train=['weights'])" in text["torch"]
    assert text["torch"] == text["jax"]


def test_load_jax_params_carries_feedback_edges_and_store():
    # a JAX feedback network after a run: its feedback edge weights and
    # carried feedback outputs loaded into the port continue identically
    n, T = 5, 40
    rng = np.random.default_rng(7)
    Ws = [rng.normal(size=(n, n)) * 0.3 for _ in range(2)]
    inp = rng.normal(size=(T, n))
    nets = {}
    for pkg in PKGS:
        net = _pops(pkg, Ws)
        net.add_edge("p1", "p2", weights=np.eye(n))
        net.add_edge("p2", "p1", weights=np.zeros((n, n)), feedback=True)
        net.compile()
        nets[pkg] = net
    jnet, tnet = nets["jax"], nets["torch"]
    jnet.get_edge("p2", "p1").params["weights"] = jnp.asarray(rng.normal(size=(n, n)) * 0.4)
    jnet.run(inp[:20], verbose=False)
    params = {kind: {lbl: {k: np.asarray(v) for k, v in sub.items()}
                     for lbl, sub in jnet.parameters_pytree()[kind].items()}
              for kind in ("nodes", "edges")}
    state = jnet.init_state()
    load_jax_params(tnet, params, {"nodes": {k: np.asarray(v) for k, v in state["nodes"].items()},
                                   "fb": {k: np.asarray(v) for k, v in state["fb"].items()}})
    np.testing.assert_array_equal(tnet._fb_store["p2"].numpy(), np.asarray(jnet._fb_store["p2"]))
    np.testing.assert_allclose(tnet.run(inp[20:], verbose=False).to_numpy("out"),
                               jnet.run(inp[20:], verbose=False).to_numpy("out"), rtol=1e-12)


@pytest.mark.parametrize("coupling", ["float32", "bfloat16"])
def test_feedback_network_generic_fused_populations_match_jax(coupling):
    # examples/feedback_populations.py at n = 48: two LIF populations with
    # the generic fused step attached (JAX: Pallas in interpret mode; port:
    # the plain version behind the wrapper), dense float32 feedforward and
    # feedback edges; the fused state keeps the layout, so the feedback
    # reads the same out-slice; float32, the generic tests' tolerance
    n, T = 48, 300
    rng = np.random.default_rng(5)
    Ws = [rng.normal(size=(n, n)) * (100 / n) for _ in range(2)]
    k = 10.0 * 100 / n
    W_ff, W_fb = k * rng.random((n, n)), -10 * k * rng.random((n, n))
    inp = np.zeros((T, 1), dtype=np.float32) + 100.0
    res = {}
    for pkg in PKGS:
        net = _net(pkg, dtype="float32")
        for label, W in zip(("p1", "p2"), Ws):
            net.add_diffeq_node(label, _prefix(pkg) + LIF, input_var="I_ext", output_var="s",
                                weights=W, source_var="s", target_var="s_in", op="lif_op",
                                spike_var="spike", spike_def="v", coupling_dtype=coupling,
                                dtype=jnp.float32 if pkg == "jax" else torch.float32)
        net.add_edge("p1", "p2", weights=W_ff)
        net.add_edge("p2", "p1", weights=W_fb, feedback=True)
        net.compile()
        for label in ("p1", "p2"):
            if pkg == "jax":
                j_attach(net.get_node(label), tile=16, interpret=True)
            else:
                attach_generic_fused_step(net.get_node(label))
        init_fb = np.asarray(net.init_state()["fb"]["p2"])
        obs = net.run(inp, sampling_steps=10, verbose=False,
                      record_vars=[("p1", "s", True), ("p2", "v", False)])
        res[pkg] = (init_fb, obs.to_numpy(("p1", "s")), obs.to_numpy("out"),
                    np.asarray(net._fb_store["p2"]))
    assert res["torch"][1].max() > 0, "no spikes -- weak test"
    np.testing.assert_allclose(res["torch"][0], res["jax"][0])
    for a, b in zip(res["torch"][1:], res["jax"][1:]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-4 * max(1.0, np.abs(b).max()))


def test_feedback_network_fused_qif_populations_match_jax():
    # the same check for attach_fused_qif_step: the JAX kernel pads the
    # state to [v | s | x] blocks and moves the out-slice with it, the port
    # keeps the layout; the first feedback read (a nonzero initial s) and
    # the run agree; float32, the attached-node tolerance
    n, T = 40, 300
    rng = np.random.default_rng(9)
    Ws = [(rng.random((n, n)) < 0.2) * 0.02 for _ in range(2)]
    etas = rng.normal(size=n) + 100.0
    s0 = rng.random(n)
    W_ff, W_fb = rng.random((n, n)) * 0.05, -rng.random((n, n)) * 0.05
    inp = rng.normal(size=(T, n)).astype(np.float32)
    res = {}
    for pkg in PKGS:
        net = _net(pkg, dt=1e-3, dtype="float32")
        for label, W in zip(("p1", "p2"), Ws):
            net.add_diffeq_node(label, _prefix(pkg) + "spiking_neurons.qif.qif_sfa", weights=W,
                                source_var="s", target_var="s_in", input_var="I_ext",
                                output_var="s", op="qif_sfa_op", spike_var="spike",
                                spike_def="v", spike_threshold=30.0, spike_reset=-30.0,
                                dtype=jnp.float32 if pkg == "jax" else torch.float32,
                                node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/s": s0})
        net.add_edge("p1", "p2", weights=W_ff)
        net.add_edge("p2", "p1", weights=W_fb, feedback=True)
        net.compile()
        for label in ("p1", "p2"):
            if pkg == "jax":
                j_qif_attach(net.get_node(label), tile=128, interpret=True)
            else:
                attach_fused_qif_step(net.get_node(label))
        init_fb = np.asarray(net.init_state()["fb"]["p2"])
        obs = net.run(inp, sampling_steps=5, verbose=False, record_vars=[("p1", "s", True)])
        res[pkg] = (init_fb, obs.to_numpy(("p1", "s")), obs.to_numpy("out"),
                    np.asarray(net._fb_store["p2"]))
    np.testing.assert_allclose(res["torch"][0], s0.astype(np.float32))
    np.testing.assert_array_equal(res["torch"][0], res["jax"][0])
    assert res["torch"][2].max() > 0, "no spiking activity -- weak test"
    for a, b in zip(res["torch"][1:], res["jax"][1:]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
