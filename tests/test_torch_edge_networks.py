"""The stateful edges inside port networks, against the JAX package: delay,
filter and masked edges in ``Network.run`` (state carried across runs),
the per-connection delay matrix (its ``add_edge`` dispatch, the feedback
self-edge of the whole-brain wiring, ``run_batch`` with swept edge
parameters, ``fit_bptt`` with trainable weights and delays,
``fit_bptt_batch``), chunked runs, ``convert.load_jax_params`` carrying edge
parameters and state, and the Jansen-Rit template of the whole-brain
network.  Mirrors ``tests/test_integration_extras.py:22-82`` and
``:227-470`` and ``tests/test_extra_models.py:136-170``; float64, the same
seeded numpy inputs through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import FeedbackNetwork as JFeedbackNetwork
from rectipy_tpu import Network as JNetwork
from rectipy_tpu.dsl import lower as jlower
from rectipy_tpu_torch import (FeedbackNetwork, LinearMemory, LinearMemoryMatrix, Network,
                               load_jax_params, lower)

TANH = "rate_neurons.leaky_integrator.tanh"
JR = "mean_field.jansen_rit.jansen_rit"
PREFIX = {"jax": "rectipy_tpu.models.", "torch": "rectipy_tpu_torch.models."}
PKGS = ("jax", "torch")


def _net(pkg, dt=1e-2, feedback=False):
    if pkg == "jax":
        return (JFeedbackNetwork if feedback else JNetwork)(dt, dtype=jnp.float64)
    return (FeedbackNetwork if feedback else Network)(dt, dtype=torch.float64, device="cpu")


def _rnn(pkg, net, n, W=None):
    net.add_diffeq_node("rnn", PREFIX[pkg] + TANH, weights=np.zeros((n, n)) if W is None else W,
                        input_var="li_op/I_ext", output_var="li_op/v",
                        source_var="tanh_op/r", target_var="li_op/r_in")


def _chain(pkg, n, **edge_kw):
    """inp (identity) -> edge -> tanh population: the reference tests' net."""
    net = _net(pkg)
    net.add_func_node("inp", n, activation_function="identity")
    _rnn(pkg, net, n)
    net.add_edge("inp", "rnn", **edge_kw)
    net.compile()
    return net


def _np(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def test_delay_edge_in_network_run():
    # test_integration_extras.py:22 -- per-source delays shift the drive; the
    # buffer persists across run() calls; the JAX package's records
    n, T = 3, 12
    delays = np.array([0, 2, 4])
    inp = np.zeros((T, n))
    inp[0] = 1.0
    out_d = {pkg: _chain(pkg, n, weights=np.eye(n), delays=delays) for pkg in PKGS}
    outs = {pkg: net.run(inp, verbose=False).to_numpy("out") for pkg, net in out_d.items()}
    out_p = _chain("torch", n, weights=np.eye(n)).run(inp, verbose=False).to_numpy("out")
    for i, d in enumerate(delays):
        np.testing.assert_allclose(outs["torch"][d:, i], out_p[: T - d, i], atol=1e-12)
        np.testing.assert_allclose(outs["torch"][:d, i], 0.0, atol=1e-12)
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-12, atol=1e-14)
    edge = out_d["torch"].get_edge("inp", "rnn")
    assert isinstance(edge, LinearMemory)
    buf_after = edge.buffer.clone()
    inp2 = np.zeros((3, n))
    inp2[0] = 2.0
    for net in out_d.values():
        net.run(inp2, verbose=False)
    assert not torch.allclose(edge.buffer, buf_after)
    np.testing.assert_array_equal(edge.buffer.numpy(),
                                  np.asarray(out_d["jax"].get_edge("inp", "rnn").buffer))


def test_filter_and_masked_edges_in_network():
    # test_integration_extras.py:60
    n = 4
    rng = np.random.default_rng(0)
    x1, x2 = rng.normal(size=(10, n)), rng.normal(size=(10, n))
    W, mask = rng.normal(size=(n, n)), (rng.random((n, n)) > 0.5).astype(float)
    outs = {}
    for pkg in PKGS:
        net = _chain(pkg, n, weights=np.eye(n), filter_weights=np.eye(n) * 0.5)
        out = net.run(x1, verbose=False).to_numpy("out")
        net2 = _chain(pkg, n, weights=W, mask=mask, train="gd")
        assert net2.get_edge("inp", "rnn").train_keys == ["weights"]
        outs[pkg] = (out, net2.run(x2, verbose=False).to_numpy("out"),
                     np.asarray(net.get_edge("inp", "rnn").y))
    for a, b in zip(outs["torch"], outs["jax"]):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("kw", [
    dict(delays=np.array([1, 0, 3, 2])),
    dict(delays=np.array([1, 0, 3, 2]), filter_weights=np.eye(4) * 0.4),
    dict(filter_weights=np.full((4, 4), 0.1)),
    dict(tau_facil=0.3, tau_depress=0.2, U=0.3),
    dict(delays=np.arange(16).reshape(4, 4) % 5),
    dict(delays=np.arange(16).reshape(4, 4) % 5, mode="gather"),
    dict(delays=np.arange(16).reshape(4, 4) % 5 + 0.4, mode="interp"),
], ids=["memory", "memory_filter", "filter", "stp", "matrix", "matrix_gather", "interp"])
def test_chunked_runs_equal_one_long_run(kw):
    # the write-back of every edge state: two chunks == one run == JAX's
    n, T = 4, 30
    rng = np.random.default_rng(3)
    W = rng.normal(size=(n, n))
    inp = np.abs(rng.normal(size=(T, n)))
    full = _chain("torch", n, weights=W, **kw).run(inp, verbose=False).to_numpy("out")
    net = _chain("torch", n, weights=W, **kw)
    parts = [net.run(inp[:13], verbose=False).to_numpy("out"),
             net.run(inp[13:], verbose=False).to_numpy("out")]
    np.testing.assert_allclose(np.concatenate(parts), full, rtol=1e-12, atol=1e-14)
    jout = _chain("jax", n, weights=W, **kw).run(inp, verbose=False).to_numpy("out")
    np.testing.assert_allclose(full, jout, rtol=1e-10, atol=1e-12)


def test_delay_matrix_edge_in_network():
    # test_integration_extras.py:227 -- dispatch, column-constant == per
    # source, chunked runs == one run, 2-D delays + filter is an error
    n, T = 3, 20
    rng = np.random.default_rng(11)
    W = rng.normal(size=(n, n))
    inp = rng.normal(size=(T, n))
    d_src = np.array([0, 2, 4])
    net_m = _chain("torch", n, weights=W, delays=np.tile(d_src[:, None], (1, n)))
    assert isinstance(net_m.get_edge("inp", "rnn"), LinearMemoryMatrix)
    out_m = net_m.run(inp, verbose=False).to_numpy("out")
    out_s = _chain("torch", n, weights=W, delays=d_src).run(inp, verbose=False).to_numpy("out")
    np.testing.assert_allclose(out_m, out_s, atol=1e-12)
    D = rng.integers(0, 5, size=(n, n))
    out_full = {pkg: _chain(pkg, n, weights=W, delays=D).run(inp, verbose=False).to_numpy("out")
                for pkg in PKGS}
    net_b = _chain("torch", n, weights=W, delays=D)
    out_1 = net_b.run(inp[:8], verbose=False).to_numpy("out")
    out_2 = net_b.run(inp[8:], verbose=False).to_numpy("out")
    np.testing.assert_allclose(np.concatenate([out_1, out_2]), out_full["torch"], atol=1e-12)
    np.testing.assert_allclose(out_full["torch"], out_full["jax"], rtol=1e-12, atol=1e-14)
    net = _net("torch")
    net.add_func_node("inp", n, activation_function="identity")
    _rnn("torch", net, n)
    with pytest.raises(ValueError):
        net.add_edge("inp", "rnn", weights=W, delays=D, filter_weights=np.eye(n))


def test_delay_matrix_feedback_self_edge():
    # test_integration_extras.py:282 -- the whole-brain wiring: a
    # column-constant matrix == per-source delays through the feedback path
    n, T = 4, 30
    rng = np.random.default_rng(5)
    W = rng.normal(size=(n, n)) * 0.4
    d_src = np.array([1, 3, 2, 1])
    inp = rng.normal(size=(T, n))

    def build(pkg, delays):
        net = _net(pkg, feedback=True)
        _rnn(pkg, net, n)
        net.add_edge("rnn", "rnn", weights=W, delays=delays, feedback=True)
        net.compile()
        return net

    D = np.tile(d_src[:, None], (1, n))
    out_m = build("torch", D).run(inp, verbose=False).to_numpy("out")
    out_s = build("torch", d_src).run(inp, verbose=False).to_numpy("out")
    np.testing.assert_allclose(out_m, out_s, atol=1e-12)
    assert np.all(np.isfinite(out_m))
    np.testing.assert_allclose(out_m, build("jax", D).run(inp, verbose=False).to_numpy("out"),
                               rtol=1e-12, atol=1e-14)


def test_delay_matrix_edge_trains_via_bptt_like_jax():
    # test_integration_extras.py:308 and :395 -- fit_bptt through the delay
    # read (plain autograd): the losses fall, are the same for every read,
    # and equal the JAX package's
    n, T = 3, 40
    rng = np.random.default_rng(9)
    D = rng.integers(0, 4, size=(n, n))
    W0 = rng.normal(size=(n, n))
    inp = rng.normal(size=(T, n))
    tgt = 0.2 * np.ones((T, n))

    def fit(pkg, mode):
        net = _chain(pkg, n, weights=W0, delays=D, train="gd", mode=mode)
        obs = net.fit_bptt([inp] * 4, [tgt] * 4, optimizer="adam", lr=5e-2, verbose=False)
        if pkg == "torch":
            assert net.last_fit["trajectory"] == "autograd"
        return [float(x) for x in obs["epoch_loss"]], np.asarray(net.get_edge("inp",
                                                                              "rnn").weights)

    l_g, w_g = fit("torch", "gather")
    l_f, w_f = fit("torch", "factored")
    np.testing.assert_allclose(l_f, l_g, rtol=1e-12)
    np.testing.assert_allclose(w_f, w_g, rtol=1e-10)
    assert l_g[-1] < l_g[0]
    l_j, w_j = fit("jax", "factored")
    np.testing.assert_allclose(l_f, l_j, rtol=1e-10)
    np.testing.assert_allclose(w_f, w_j, rtol=1e-10, atol=1e-12)
    assert not np.allclose(w_f, W0)


def test_delay_matrix_edge_run_batch():
    # test_integration_extras.py:335 -- a trial batch equals per-trial runs
    n, B, T = 3, 3, 15
    rng = np.random.default_rng(4)
    D = rng.integers(0, 5, size=(n, n))
    W = rng.normal(size=(n, n))
    inputs = rng.normal(size=(B, T, n))
    net = _chain("torch", n, weights=W, delays=D)
    buf0 = net.get_edge("inp", "rnn").buffer.clone()
    batch = net.run_batch(inputs, verbose=False)
    np.testing.assert_array_equal(net.get_edge("inp", "rnn").buffer.numpy(), buf0.numpy())
    for b in range(B):
        solo = _chain("torch", n, weights=W, delays=D).run(inputs[b], verbose=False)
        np.testing.assert_allclose(batch["out"][b], solo.to_numpy("out"), atol=1e-12)
    jbatch = _chain("jax", n, weights=W, delays=D).run_batch(inputs, verbose=False)
    np.testing.assert_allclose(batch["out"], jbatch["out"], rtol=1e-12, atol=1e-14)


def test_run_batch_sweeps_edge_parameters_like_jax():
    # ("edge", src, tgt, param) in batch_vars: per-trial STP weights and
    # per-trial interp delays (prepped per trial), against the JAX package
    n, B, T = 3, 3, 20
    rng = np.random.default_rng(12)
    inp = np.abs(rng.normal(size=(T, n)))
    Ws = rng.normal(size=(B, n, n))
    Ds = rng.uniform(0, 4, size=(B, n, n))
    cases = [(dict(weights=np.eye(n), tau_facil=0.2, tau_depress=0.1),
              {("edge", "inp", "rnn", "weights"): Ws}),
             (dict(weights=np.eye(n), delays=np.ones((n, n)), mode="interp", max_delay=5),
              {("edge", "inp", "rnn", "delays"): Ds}),
             (dict(weights=np.eye(n), delays=np.ones((n, n)), mode="interp", max_delay=5,
                   interp_impl="factored2"),
              {("edge", "inp", "rnn", "delays"): Ds})]
    for kw, sweep in cases:
        res = {pkg: _chain(pkg, n, **kw).run_batch(inp, batch_vars=sweep, verbose=False)["out"]
               for pkg in PKGS}
        np.testing.assert_allclose(res["torch"], res["jax"], rtol=1e-12, atol=1e-14)
        assert np.abs(res["torch"][0] - res["torch"][1]).max() > 1e-6


def test_run_batch_leaves_stp_and_buffer_state_alone():
    # run_batch starts every trial from the network's edge state (repeated
    # over the trials, tuples included) and writes nothing back
    n, B, T = 3, 4, 25
    rng = np.random.default_rng(1)
    inputs = np.abs(rng.normal(size=(B, T, n)))
    for kw in (dict(tau_facil=0.3, tau_depress=0.2), dict(delays=np.array([2, 0, 1]))):
        nets = {pkg: _chain(pkg, n, weights=np.eye(n), **kw) for pkg in PKGS}
        for net in nets.values():
            net.run(inputs[0, :10], verbose=False)  # a non-initial edge state
        state0 = nets["torch"].get_edge("inp", "rnn").init_state()
        res = {pkg: net.run_batch(inputs, verbose=False)["out"] for pkg, net in nets.items()}
        np.testing.assert_allclose(res["torch"], res["jax"], rtol=1e-12, atol=1e-14)
        after = nets["torch"].get_edge("inp", "rnn").init_state()
        for a, b in zip(jax.tree.leaves(_np(state0)), jax.tree.leaves(_np(after))):
            np.testing.assert_array_equal(a, b)


def test_delay_matrix_onehots_are_prep_arguments_built_once_per_run():
    # test_integration_extras.py:362 -- the selectors are prep arguments, not
    # edge parameters; the prep is idempotent; a run builds them once, never
    # per step
    n = 4
    D = np.random.default_rng(0).integers(0, 6, size=(n, n))
    for mode, keys in [("onehot", {"_oh"}), ("factored", {"_oh_q", "_oh_r"})]:
        net = _chain("torch", n, weights=np.eye(n), delays=D, mode=mode)
        edge = net.get_edge("inp", "rnn")
        assert isinstance(edge, LinearMemoryMatrix) and edge.mode == mode
        raw = net.parameters_pytree()
        assert not (keys & set(raw["edges"]["inp->rnn"]))
        prepped = net._prep_params(raw)
        assert keys <= set(prepped["edges"]["inp->rnn"])
        again = net._prep_params(prepped)
        for k in keys:
            assert again["edges"]["inp->rnn"][k] is prepped["edges"]["inp->rnn"][k]
        before = edge.selector_builds
        net.run(np.zeros((50, n)), verbose=False)
        assert edge.selector_builds == before + 1


def _fit_delays(pkg, n, d0, inp, tgt, lr, epochs=4, **kw):
    net = _chain(pkg, n, delays=d0, train="gd", train_delays=True, mode="interp", **kw)
    assert ("edges", "inp->rnn", "delays") in net.trainable_paths()
    obs = net.fit_bptt([inp] * epochs, [tgt] * epochs, optimizer="adam", lr=lr, verbose=False)
    return ([float(x) for x in obs["epoch_loss"]],
            np.asarray(net.get_edge("inp", "rnn").params["delays"]))


def test_trainable_delays_follow_jax():
    # test_integration_extras.py:420, at a tenth of its epochs: weights and
    # fractional delays trained together through the hat read from a teacher
    # (the diagonal starts on a bound, d = 0, where the hat's gradient takes
    # the JAX package's values at the ties): the same losses and delays
    n, T = 3, 60
    rng = np.random.default_rng(5)
    W = rng.normal(size=(n, n))
    d_true = np.array([[0.0, 2.4, 1.2], [3.1, 0.0, 0.7], [1.8, 2.9, 0.0]])
    d_0 = np.full((n, n), 1.5)
    np.fill_diagonal(d_0, 0.0)
    inp = rng.normal(size=(T, n))
    kw = dict(weights=W, max_delay=5, interp_impl="hat")
    tgt = _chain("torch", n, delays=d_true, mode="interp", **kw).run(
        inp, verbose=False).to_numpy("out")
    (l_t, d_t), (l_j, d_j) = (_fit_delays(pkg, n, d_0, inp, tgt, 5e-2, **kw) for pkg in PKGS[::-1])
    assert l_t[-1] < l_t[0]
    assert np.abs(d_t - d_0.T).max() > 1e-3
    np.testing.assert_allclose(l_t, l_j, rtol=1e-10)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-8, atol=1e-12)
    # fused_bptt=True refuses a network with a delay-matrix edge: no chain,
    # and the graph trajectory takes linear-family edges only
    net = _chain("torch", n, delays=d_0, train="gd", train_delays=True, mode="interp", **kw)
    with pytest.raises(ValueError, match="linear-family"):
        net.fit_bptt([inp], [tgt], fused_bptt=True, verbose=False)


def test_trainable_delays_factored2_fit_parity():
    # test_integration_extras.py:458 (without its remat case, ROADMAP entry
    # F): the factored2 read trains to the hat's losses and delays, and to
    # the JAX package's factored2
    n, T = 4, 60
    rng = np.random.default_rng(11)
    W = rng.normal(size=(n, n))
    d_0 = rng.uniform(0.3, 3.6, size=(n, n))
    inp = rng.normal(size=(T, n))
    tgt = 0.1 * np.ones((T, n))
    res = {(pkg, impl): _fit_delays(pkg, n, d_0, inp, tgt, 3e-2, weights=W, max_delay=6,
                                    interp_impl=impl)
           for pkg, impl in (("torch", "hat"), ("torch", "factored2"), ("jax", "factored2"))}
    (l_h, d_h), (l_f, d_f), (l_j, d_j) = res.values()
    assert l_h[-1] < l_h[0]
    np.testing.assert_allclose(l_f, l_h, rtol=1e-10)
    np.testing.assert_allclose(d_f, d_h, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(l_f, l_j, rtol=1e-10)
    np.testing.assert_allclose(d_f, d_j, rtol=1e-8, atol=1e-12)


def test_filter_trains_in_step_mode_like_jax():
    # truncated BPTT (step mode) through a trainable filter edge: chunk by
    # chunk the filter state is carried (detached) and the filter trained
    n, T = 3, 40
    rng = np.random.default_rng(8)
    inp = rng.normal(size=(T, n))
    tgt = 0.1 * np.ones((T, n))
    res = {}
    for pkg in PKGS:
        net = _chain(pkg, n, weights=rng.normal(size=(n, n)) if pkg == "jax" else None,
                     filter_weights=np.eye(n) * 0.5, train="gd")
        res[pkg] = net
    W = np.asarray(res["jax"].get_edge("inp", "rnn").weights)
    res["torch"].get_edge("inp", "rnn").params["weights"] = torch.tensor(W)
    assert ("edges", "inp->rnn", "filter") in res["torch"].trainable_paths()
    outs = {}
    for pkg, net in res.items():
        obs = net.fit_bptt(inp, tgt, optimizer="sgd", lr=1e-2, update_steps=10,
                           verbose=False)
        outs[pkg] = (obs.to_numpy("out"), np.asarray(net.get_edge("inp", "rnn").filter),
                     np.asarray(net.get_edge("inp", "rnn").y))
    for a, b in zip(outs["torch"], outs["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)
    assert not np.allclose(outs["torch"][1], np.eye(n) * 0.5)


def test_fit_bptt_batch_through_stateful_edges_like_jax():
    # minibatch BPTT over trials through a delay matrix and an STP edge
    # (plain autograd over the batched step, the edge state repeated over
    # the trials): losses and trained weights equal the JAX package's
    n, B, T = 3, 4, 15
    rng = np.random.default_rng(14)
    ins = np.abs(rng.normal(size=(B, T, n)))
    tgts = rng.normal(size=(B, T, n)) * 0.1
    for kw in (dict(delays=rng.integers(0, 4, (n, n)), mode="factored"),
               dict(tau_facil=0.3, tau_depress=0.2, U=0.4)):
        W = rng.normal(size=(n, n))
        res = {}
        for pkg in PKGS:
            net = _chain(pkg, n, weights=W, train="gd", **kw)
            obs = net.fit_bptt_batch(ins, tgts, n_epochs=3, batch_size=2, seed=3, lr=1e-2,
                                     verbose=False)
            res[pkg] = (np.asarray(obs["train_loss"]),
                        np.asarray(net.get_edge("inp", "rnn").weights))
        np.testing.assert_allclose(res["torch"][0], res["jax"][0], rtol=1e-10)
        np.testing.assert_allclose(res["torch"][1], res["jax"][1], rtol=1e-10, atol=1e-12)


def _wb_net(pkg, M, W, D, taues, stp=None, dt=1e-4):
    """The whole-brain network at width M: Jansen-Rit regions with a
    delay-matrix feedback self-edge; ``stp`` adds an input node feeding the
    regions through an STP edge."""
    net = _net(pkg, dt=dt, feedback=True)
    net.add_diffeq_node("brain", PREFIX[pkg] + JR, weights=np.zeros((M, M)), source_var="m_py",
                        target_var="r_in", input_var="r_in", output_var="m_py",
                        node_vars={"all/jr_op/tau_e": taues})
    if stp is not None:
        net.add_func_node("inp", M, activation_function="identity")
        net.add_edge("inp", "brain", weights=np.eye(M), **stp)
    net.add_edge("brain", "brain", weights=40.0 * W, delays=D, feedback=True)
    net.compile()
    return net


def _wb_data(M, seed=0, speed=2.0, dt=1e-4, span=0.14):
    """benchmarks/whole_brain_scale.py's connectome at width M."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, span, size=(M, 3))
    dist = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    W = np.exp(-dist / 0.06)
    np.fill_diagonal(W, 0.0)
    W /= W.sum(axis=0, keepdims=True)
    D = np.rint(dist / speed / dt).astype(int)
    np.fill_diagonal(D, 0)
    return W, D, rng.uniform(8e-3, 13e-3, size=M)


def test_load_jax_params_carries_edge_parameters_and_state():
    # a JAX network with a delay-matrix and an STP edge, run k steps, then
    # carried to the port: both continue k more steps, equal at float64
    M, k = 6, 60
    W, D, taues = _wb_data(M, span=0.02)
    assert D.max() > 5
    stp = dict(tau_facil=2e-3, tau_depress=3e-3, U=0.3)
    rng = np.random.default_rng(2)
    inp = np.abs(rng.normal(size=(2 * k, M))) * 50.0
    jnet = _wb_net("jax", M, W, D, taues, stp=stp)
    jnet.run(inp[:k], verbose=False)
    tnet = _wb_net("torch", M, W * 0.0, np.zeros_like(D) + D, taues, stp=stp)
    params, state = _np(jnet.parameters_pytree()), _np(jnet.init_state())
    assert np.abs(state["edges"]["brain->brain"]).max() > 0
    load_jax_params(tnet, params, state)
    u, x = tnet.get_edge("inp", "brain").init_state()
    np.testing.assert_array_equal(x.numpy(), np.asarray(jnet.get_edge("inp", "brain").x))
    assert float(x.min()) < 1.0
    np.testing.assert_allclose(tnet.run(inp[k:], verbose=False).to_numpy("out"),
                               jnet.run(inp[k:], verbose=False).to_numpy("out"), rtol=1e-10,
                               atol=1e-13)
    # a state whose structure or shape differs raises KeyError
    bad = dict(state, edges={**state["edges"], "inp->brain": state["edges"]["inp->brain"][0]})
    with pytest.raises(KeyError, match="inp->brain"):
        load_jax_params(tnet, params, bad)
    bad = dict(state, edges={**state["edges"], "brain->brain": np.zeros((M, 2))})
    with pytest.raises(KeyError, match="brain->brain"):
        load_jax_params(tnet, params, bad)


def test_jansen_rit_vector_field_and_run_match_jax():
    # test_extra_models.py:136 -- the port's lowering of the template (its
    # coupling source m_py is algebraic) against the JAX package's and the
    # oracle; then a 200-step run of the whole-brain network
    n = 3
    rng = np.random.default_rng(4)
    y = rng.normal(size=6 * n) * 1e-3
    jvf = jlower("rectipy_tpu.models.mean_field.jansen_rit.jansen_rit", n=n, dtype=jnp.float64)
    tvf = lower(PREFIX["torch"] + JR, n=n, dtype=torch.float64, device="cpu")
    dy_t = tvf.func(0.0, torch.as_tensor(y), tvf.args).numpy()
    np.testing.assert_allclose(dy_t, np.asarray(jvf.func(0.0, jnp.asarray(y), jvf.args)),
                               rtol=1e-12, atol=1e-14)
    psp_p, z_p, psp_e, z_e, psp_i, z_i = y.reshape(6, n)
    H_e, H_i, tau_e, tau_i = 3.25e-3, 22.0e-3, 10.0e-3, 20.0e-3
    sig = lambda v: 5.0 / (1.0 + np.exp(560.0 * (6.0e-3 - v)))  # noqa: E731
    m_py, m_ein, m_iin = sig(psp_e - psp_i), sig(135.0 * psp_p), sig(33.75 * psp_p)
    expect = np.concatenate([
        z_p, H_e / tau_e * m_py - 2 * z_p / tau_e - psp_p / tau_e ** 2,
        z_e, H_e / tau_e * (108.0 * m_ein + 220.0) - 2 * z_e / tau_e - psp_e / tau_e ** 2,
        z_i, H_i / tau_i * 33.75 * m_iin - 2 * z_i / tau_i - psp_i / tau_i ** 2])
    np.testing.assert_allclose(dy_t, expect, rtol=1e-10, atol=1e-14)
    M = 8
    W, D, taues = _wb_data(M, span=0.05)
    inp = np.random.default_rng(2).normal(size=(200, M)) * 2.0
    kw = dict(sampling_steps=10, record_vars=[("brain", "psp_e", False)], verbose=False)
    obs = {pkg: _wb_net(pkg, M, W, D, taues).run(inp, **kw) for pkg in PKGS}
    for key in ("out", ("brain", "psp_e")):
        got = obs["torch"].to_numpy(key)
        assert np.all(np.isfinite(got)) and got.std() > 0
        np.testing.assert_allclose(got, obs["jax"].to_numpy(key), rtol=1e-10, atol=1e-14)
