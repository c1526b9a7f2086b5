"""The port's remaining trainers against the JAX package on the CPU: the
``RLS`` edge and ``fit_rls`` (online and epoch mode), ``fit_ridge``,
``test``, ``fit_bptt`` step mode (truncated BPTT), ``run(truncate_steps=)``
and the legacy helpers (``from_yaml``, ``add_input_layer``,
``add_output_layer``, ``describe``).

Float64 unless a fused kernel needs float32, the same seeded numpy inputs
through both packages; the cases mirror ``tests/test_network.py``,
``tests/test_coverage_extras.py``, ``tests/test_edges.py`` and
``tests/test_golden_parity.py`` (the reference line of each case is named in
its comment).  The port's RLS downdate rounds ``(k*z_i)*z_j`` where JAX
rounds ``k*(z_i*z_j)``: the two stay within float64 round-off."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.edges import RLS as JRLS
from rectipy_tpu.ops.kernels import attach_fused_qif_step as j_attach
from rectipy_tpu_torch import RLS, Network, attach_fused_qif_step, load_jax_params

J, T_ = "neuron_model_templates.", "rectipy_tpu_torch.models."
TANH = "rate_neurons.leaky_integrator.tanh"
QIF_SFA = "spiking_neurons.qif.qif_sfa"
PKGS = ("jax", "torch")


def _net(pkg, dt=1e-2, dtype="float64"):
    if pkg == "jax":
        return JNetwork(dt, dtype=getattr(jnp, dtype))
    return Network(dt, dtype=getattr(torch, dtype), device="cpu")


def _prefix(pkg):
    return J if pkg == "jax" else T_


def _reservoir(pkg, W, W_in=None, output_var="tanh_op/r", **kw):
    """[inp ->] a tanh population, as the reference trainer tests build it."""
    net = _net(pkg)
    if W_in is not None:
        net.add_func_node("inp", W_in.shape[1], activation_function="identity")
    net.add_diffeq_node("rnn", _prefix(pkg) + TANH, weights=W, input_var="li_op/I_ext",
                        output_var=output_var, source_var="tanh_op/r",
                        target_var="li_op/r_in", **kw)
    if W_in is not None:
        net.add_edge("inp", "rnn", weights=W_in)
    return net


def _rls_net(pkg, W, W_in, k, **edge_kw):
    net = _reservoir(pkg, W, W_in)
    net.add_func_node("out", k, activation_function="identity")
    net.add_edge("rnn", "out", train="rls", **edge_kw)
    return net


def _edge_arrays(net, src="rnn", tgt="out"):
    edge = net.get_edge(src, tgt)
    return np.asarray(edge.weights), np.asarray(edge.P)


# ------------------------------------------------------------------ RLS edge


def _cpu_rls(*args, **kwargs):
    return RLS(*args, device="cpu", **kwargs)


def test_rls_layer_matches_jax():
    # test_edges.py:126 -- hyperparameter checks, zero initial weights,
    # forward and update of four edges, each against JAX
    n, m = 10, 2
    rng = np.random.default_rng(5)
    w1 = rng.normal(size=(n, m))
    x, y = rng.normal(size=n), rng.normal(size=m)
    kws = [{}, {"weights": w1}, {"weights": w1, "beta": 0.5}, {"weights": w1, "alpha": 0.1}]
    got = {}
    for pkg, cls in (("jax", JRLS), ("torch", _cpu_rls)):
        edges = [cls(n, m, **kw) for kw in kws]
        outs = [np.asarray(edges[0].forward(x)), np.asarray(edges[0].forward(x))]
        for e in edges[1:]:
            e.update(x, np.asarray(e.forward(x)), y)
            outs.append(np.asarray(e.forward(x)))
        got[pkg] = (outs, [np.asarray(e.P) for e in edges], edges)
    edges = got["torch"][2]
    np.testing.assert_allclose(np.asarray(_cpu_rls(n, m, weights=w1).weights), w1.T)
    assert edges[0].P.shape[0] == n and edges[0].P.dtype == torch.float64
    assert len(list(edges[1].parameters())) == 0 and edges[1].train_keys == []
    for a, b in zip(got["torch"][0] + got["torch"][1], got["jax"][0] + got["jax"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)
    r2, r3, r4 = got["torch"][0][2:]
    assert np.abs(np.sum(r2 - r3)) > 0 and np.abs(np.sum(r3 - r4)) > 0
    for kw in ({"alpha": -0.5}, {"beta": 1.5}):
        with pytest.raises(ValueError):
            _cpu_rls(n, m, **kw)


def test_rls_converges_to_linear_readout_like_jax():
    # test_edges.py:162 -- 300 online updates recover W_true; the port's
    # weights, P and loss equal JAX's to float64 round-off
    n, m = 8, 2
    rng = np.random.default_rng(6)
    W_true = rng.normal(size=(m, n))
    xs = rng.normal(size=(300, n))
    edges = {"jax": JRLS(n, m, beta=1.0, alpha=1.0), "torch": _cpu_rls(n, m, beta=1.0, alpha=1.0)}
    for x in xs:
        for e in edges.values():
            e.update(x, W_true @ x, np.asarray(e.forward(x)))
    t, j = edges["torch"], edges["jax"]
    np.testing.assert_allclose(np.asarray(t.weights), W_true, atol=1e-2)
    assert float(t.loss) < 1e-3
    np.testing.assert_allclose(np.asarray(t.weights), np.asarray(j.weights), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(t.P), np.asarray(j.P), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(t.loss), float(j.loss), rtol=1e-6, atol=1e-20)


def test_rls_update_matches_reference_formula():
    # test_golden_parity.py:120 -- the rank-1 (W, P) recursion written out
    # in float64 torch, and the JAX edge
    n, m = 12, 3
    rng = np.random.default_rng(2)
    W = torch.zeros((m, n), dtype=torch.float64)
    P = torch.eye(n, dtype=torch.float64) * 0.8
    beta_inv = 1.0 / 0.95
    rls = _cpu_rls(n, m, beta=0.95, alpha=0.8)
    jrls = JRLS(n, m, beta=0.95, alpha=0.8, dtype=jnp.float64)
    for _ in range(20):
        x, y = rng.normal(size=n), rng.normal(size=m)
        xt, yt = torch.tensor(x), torch.tensor(y)
        z = beta_inv * (P @ xt)
        k_gain = 1.0 / (1.0 + xt @ z)
        W = W + torch.outer(yt - k_gain * (xt @ (W + torch.outer(yt, z)).T), z)
        P = P - k_gain * torch.outer(z, z)
        rls.update(x, y, rls.forward(x))
        jrls.update(x, y, jrls.forward(x))
    np.testing.assert_allclose(rls.weights.numpy(), W.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(rls.P.numpy(), P.numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(rls.P.numpy(), np.asarray(jrls.P), rtol=1e-12, atol=1e-14)


def test_rls_readout_dtype_matches_jax():
    # a float32 network with the float64 RLS readout: the readout's output
    # and the records come out float64 in both packages (JAX promotes
    # f32 @ f64; the port casts explicitly)
    n, m, T = 6, 2, 40
    rng = np.random.default_rng(11)
    W, W_in = rng.normal(size=(n, n)) * 0.3, rng.normal(size=(n, m))
    inp, tgt = rng.normal(size=(T, m)), rng.normal(size=(T, 1))
    dtypes = {}
    for pkg in PKGS:
        net = _net(pkg, dtype="float32")
        net.add_func_node("inp", m, activation_function="identity")
        net.add_diffeq_node("rnn", _prefix(pkg) + TANH, weights=W, input_var="li_op/I_ext",
                            output_var="tanh_op/r", source_var="tanh_op/r",
                            target_var="li_op/r_in",
                            dtype=jnp.float32 if pkg == "jax" else torch.float32)
        net.add_edge("inp", "rnn", weights=W_in)
        net.add_func_node("out", 1, activation_function="identity")
        edge = net.add_edge("rnn", "out", train="rls")
        run = net.run(inp, verbose=False).to_numpy("out")
        fit = net.fit_rls(inp, tgt, sampling_steps=5, verbose=False)
        dtypes[pkg] = (np.dtype(str(edge.weights.dtype).replace("torch.", "")), run.dtype,
                       fit.to_numpy("out").dtype, fit.to_numpy("loss").dtype)
    assert dtypes["torch"] == dtypes["jax"] == (np.dtype("float64"),) * 4
    # rls_dtype overrides the port's float64 default
    net = _net("torch", dtype="float32")
    net.add_func_node("a", 3, activation_function="identity")
    net.add_func_node("b", 1, activation_function="identity")
    assert net.add_edge("a", "b", train="rls", rls_dtype="float32").P.dtype == torch.float32


# ------------------------------------------------------------------ fit_rls


def _rls_fit_both(W, W_in, inp, target, k, edge_kw=None, **fit_kw):
    res = {}
    for pkg in PKGS:
        net = _rls_net(pkg, W, W_in, k, **(edge_kw or {}))
        obs = net.fit_rls(inp, target, verbose=False, **fit_kw)
        res[pkg] = (obs, net)
    return res


def test_fit_rls_online_matches_jax():
    # test_network.py:293 -- a representable teacher readout; outputs,
    # losses, weights, P and the final state against JAX
    n, m, k = 15, 2, 1
    rng = np.random.default_rng(8)
    W_res, W_in = rng.normal(size=(n, n)) * 0.4, rng.normal(size=(n, m))
    T = 500
    time = np.linspace(0, T * 1e-2, T)
    inp = np.stack([np.sin(2 * np.pi * 0.7 * time), np.cos(2 * np.pi * 0.3 * time)], axis=1)
    w_t = rng.normal(size=(n, k))
    X = _reservoir("torch", W_res, W_in).run(inp, verbose=False).to_numpy("out")
    target = X @ w_t
    res = _rls_fit_both(W_res, W_in, inp, target, k, edge_kw=dict(beta=1.0, alpha=1.0),
                        update_steps=1, sampling_steps=10)
    (jobs, jnet), (tobs, tnet) = res["jax"], res["torch"]
    losses = tobs.to_numpy("loss")
    assert losses[-1] < 1e-2, f"RLS did not converge (final loss {losses[-1]})"
    assert isinstance(tnet.get_edge("rnn", "out"), RLS)
    np.testing.assert_array_equal(tobs["steps"], jobs["steps"])
    np.testing.assert_allclose(tobs.to_numpy("out"), jobs.to_numpy("out"), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(losses, jobs.to_numpy("loss"), rtol=1e-6, atol=1e-18)
    for a, b in zip(_edge_arrays(tnet), _edge_arrays(jnet)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tnet.get_node("rnn").y.numpy(), np.asarray(jnet.get_node("rnn").y),
                               rtol=1e-12)
    assert float(tnet.get_edge("rnn", "out").loss) == pytest.approx(
        float(jnet.get_edge("rnn", "out").loss), rel=1e-6, abs=1e-18)


@pytest.mark.parametrize("update_steps,sampling_steps", [(3, 7), (10, 10)])
def test_fit_rls_update_and_record_grid_matches_jax(update_steps, sampling_steps):
    # updates fall on step % update_steps == 0, records on step %
    # sampling_steps == 0 with the loss current at that step
    n, m, k, T = 10, 2, 2, 120
    rng = np.random.default_rng(12)
    W_res, W_in = rng.normal(size=(n, n)) * 0.4, rng.normal(size=(n, m))
    inp, target = rng.normal(size=(T, m)), rng.normal(size=(T, k))
    res = _rls_fit_both(W_res, W_in, inp, target, k, edge_kw=dict(beta=0.99, alpha=2.0),
                        update_steps=update_steps, sampling_steps=sampling_steps)
    (jobs, jnet), (tobs, tnet) = res["jax"], res["torch"]
    np.testing.assert_array_equal(tobs["steps"], np.arange(0, T, sampling_steps))
    np.testing.assert_allclose(tobs.to_numpy("out"), jobs.to_numpy("out"), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(tobs.to_numpy("loss"), jobs.to_numpy("loss"), rtol=1e-9)
    for a, b in zip(_edge_arrays(tnet), _edge_arrays(jnet)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_fit_rls_record_vars_match_run_and_jax():
    # the RLS half of test_network.py:328 -- the readout does not feed back,
    # so the recorded reservoir variable equals a plain run's
    n, m, k, T = 12, 2, 1, 200
    rng = np.random.default_rng(31)
    W_res, W_in = rng.normal(size=(n, n)) * 0.4, rng.normal(size=(n, m))
    inp, target = rng.normal(size=(T, m)), rng.normal(size=(T, k))
    ref = _rls_net("torch", W_res, W_in, k).run(inp, sampling_steps=10, verbose=False,
                                                record_vars=[("rnn", "v", False)])
    v_ref = ref.to_numpy(("rnn", "v"))
    for reduce in (False, True):
        res = _rls_fit_both(W_res, W_in, inp, target, k, sampling_steps=10,
                            record_vars=[("rnn", "v", reduce)])
        got = res["torch"][0].to_numpy(("rnn", "v"))
        np.testing.assert_allclose(got, v_ref.mean(axis=1) if reduce else v_ref, rtol=1e-12)
        np.testing.assert_allclose(got, res["jax"][0].to_numpy(("rnn", "v")), rtol=1e-12)


def test_fit_rls_epoch_mode_matches_jax():
    # test_coverage_extras.py:45 -- two epochs; the state resets after each,
    # (W, P) carry across; mismatched lists raise
    n, m = 10, 2
    rng = np.random.default_rng(0)
    W_res, W_in = rng.normal(size=(n, n)) * 0.3, rng.normal(size=(n, m))
    T = 150
    inp = rng.normal(size=(T, m))
    tgt = rng.normal(size=(T, 1)) * 0.1
    res = _rls_fit_both(W_res, W_in, [inp, inp], [tgt, tgt], 1, edge_kw=dict(beta=1.0),
                        update_steps=1, sampling_steps=50)
    (jobs, jnet), (tobs, tnet) = res["jax"], res["torch"]
    assert len(tobs["epoch_loss"]) == 2 and np.isfinite(tobs["epoch_loss"]).all()
    np.testing.assert_allclose(tobs["epoch_loss"], jobs["epoch_loss"], rtol=1e-8)
    np.testing.assert_array_equal(tobs["epochs"], np.arange(2))
    for a, b in zip(_edge_arrays(tnet), _edge_arrays(jnet)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tnet.get_node("rnn").y.numpy(), np.asarray(jnet.get_node("rnn").y),
                               rtol=1e-12, atol=1e-15)
    assert tnet.get_edge("rnn", "out").loss == tobs["epoch_loss"][-1]
    with pytest.raises(ValueError):
        tnet.fit_rls([inp], [tgt, tgt])
    with pytest.raises(ValueError, match="RLS"):
        _reservoir("torch", W_res, W_in).fit_rls(inp, tgt)


def test_fit_rls_through_fused_qif_node_matches_jax():
    # FORCE on a spiking reservoir whose node has the fused QIF+SFA step
    # attached (JAX: the Pallas kernel in interpret mode; port: the plain
    # version behind the wrapper), float32; the attached-node tolerance of
    # test_torch_kernels.py
    n, T = 64, 400
    rng = np.random.default_rng(3)
    W = (rng.random((n, n)) < 0.2).astype(np.float64) * 0.02
    etas = rng.normal(size=n) + 100.0
    W_in = rng.normal(size=(n, 1))
    inp = (rng.normal(size=(T, 1)) + 1.0).astype(np.float32)
    target = np.sin(np.linspace(0.0, 4 * np.pi, T))[:, None]
    res = {}
    for pkg in PKGS:
        net = _net(pkg, dt=1e-3, dtype="float32")
        net.add_diffeq_node("qif", _prefix(pkg) + QIF_SFA, weights=W, source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            op="qif_sfa_op", spike_var="spike", spike_def="v",
                            spike_threshold=30.0, spike_reset=-30.0,
                            dtype=jnp.float32 if pkg == "jax" else torch.float32,
                            node_vars={"all/qif_sfa_op/eta": etas})
        net.add_func_node("inp", 1, activation_function="identity")
        net.add_edge("inp", "qif", weights=W_in)
        net.add_func_node("out", 1, activation_function="identity")
        net.add_edge("qif", "out", train="rls", beta=0.99, alpha=1.0)
        net.compile()
        if pkg == "jax":
            j_attach(net.get_node("qif"), tile=128, interpret=True)
        else:
            attach_fused_qif_step(net.get_node("qif"))
        obs = net.fit_rls(inp, target, update_steps=5, sampling_steps=10, verbose=False,
                          record_vars=[("qif", "s", True)])
        res[pkg] = (obs, net)
    (jobs, jnet), (tobs, tnet) = res["jax"], res["torch"]
    s_mean = tobs.to_numpy(("qif", "s"))
    assert s_mean.max() > 0, "no spiking activity -- weak test"
    np.testing.assert_allclose(s_mean, jobs.to_numpy(("qif", "s")), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tobs.to_numpy("out"), jobs.to_numpy("out"), rtol=1e-3, atol=1e-4)
    w_t, w_j = (np.asarray(net.get_edge("qif", "out").weights) for net in (tnet, jnet))
    np.testing.assert_allclose(w_t, w_j, rtol=1e-3, atol=1e-4 * np.abs(w_j).max())


# ------------------------------------------------------------ ridge and test


def test_fit_ridge_readout_matches_jax():
    # test_network.py:265 -- w_out, the fitted predictions and the wired
    # readout node against JAX
    n, m, k = 20, 2, 2
    rng = np.random.default_rng(7)
    W, W_in = rng.normal(size=(n, n)) * 0.4, rng.normal(size=(n, m))
    T = 300
    inp = rng.normal(size=(T, m))
    w_t = rng.normal(size=(n, k))
    X = _reservoir("torch", W, W_in).run(inp, verbose=False).to_numpy("out")
    targets = X @ w_t
    res = {}
    for pkg in PKGS:
        net = _reservoir(pkg, W, W_in)
        obs = net.fit_ridge(inp, targets, sampling_steps=1, alpha=1e-6, verbose=False,
                            add_readout_node=True)
        res[pkg] = (obs, net)
    (jobs, jnet), (tobs, tnet) = res["jax"], res["torch"]
    w_out = np.asarray(tobs["w_out"])
    np.testing.assert_allclose(w_out, w_t, atol=0.2)
    assert float(np.mean((np.asarray(tobs["y"]) - targets) ** 2)) < 1e-6
    assert "readout" in tnet.nodes and tnet.n_out == k
    # the Gram matrix is ill-conditioned: the predictions are tight, w_out
    # agrees to the conditioning
    np.testing.assert_allclose(np.asarray(tobs["y"]), np.asarray(jobs["y"]), rtol=1e-8,
                               atol=1e-9)
    np.testing.assert_allclose(w_out, np.asarray(jobs["w_out"]), atol=1e-5)
    np.testing.assert_allclose(tnet.get_edge("rnn", "readout").weights.numpy(), w_out.T)


@pytest.mark.parametrize("sampling_steps", [1, 3])
def test_fit_ridge_then_test_matches_jax(sampling_steps):
    # the readout fitted on downsampled records, then scored by test() with
    # the targets downsampled to the recorded steps
    n, m, k, T = 16, 2, 3, 240
    rng = np.random.default_rng(17)
    W, W_in = rng.normal(size=(n, n)) * 0.4, rng.normal(size=(n, m))
    inp, tgt = rng.normal(size=(T, m)), rng.normal(size=(T, k))
    res = {}
    for pkg in PKGS:
        net = _reservoir(pkg, W, W_in)
        obs = net.fit_ridge(inp, tgt, sampling_steps=sampling_steps, alpha=1e-3, verbose=False)
        net.reset()
        obs2, loss = net.test(inp, tgt, loss="mse", sampling_steps=sampling_steps, verbose=False)
        res[pkg] = (np.asarray(obs["w_out"]), np.asarray(obs["y"]), obs2.to_numpy("out"), loss)
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-10)


def test_test_method_matches_jax():
    # test_network.py:369 -- a frozen run against its own outputs scores 0
    # (mse and l1), and the loss of other targets equals JAX's
    n = 8
    rng = np.random.default_rng(9)
    W = rng.normal(size=(n, n)) * 0.3
    T = 60
    inp = rng.normal(size=(T, n))
    other = rng.normal(size=(T, n))
    net = _reservoir("torch", W, output_var="li_op/v")
    target = net.run(inp, verbose=False).to_numpy("out")
    net.reset()
    _, loss = net.test(inp, target, loss="mse", sampling_steps=1, verbose=False)
    assert loss == pytest.approx(0.0, abs=1e-9)
    net.reset()
    _, loss2 = net.test(inp, target, loss="l1", sampling_steps=1, verbose=False)
    assert loss2 == pytest.approx(0.0, abs=1e-9)
    losses = {}
    for pkg in PKGS:
        net = _reservoir(pkg, W, output_var="li_op/v")
        losses[pkg] = [net.test(inp, other, loss=loss, sampling_steps=s, verbose=False)[1]
                       for loss, s in (("mse", 1), ("l1", 7))]
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-12)


# ------------------------------------------------------- fit_bptt step mode


def _step_net(pkg, W, n):
    return _reservoir(pkg, W, output_var="li_op/v", train_params=["weights"])


def test_bptt_step_mode_truncated_matches_jax():
    # test_network.py:237 -- six passes of truncated BPTT (update_steps 50,
    # sampling_steps 10) against a teacher; the per-pass losses and the
    # trained weights against JAX
    n = 6
    rng = np.random.default_rng(6)
    W = rng.normal(size=(n, n)) * 0.3
    T = 400
    inp = rng.normal(size=(T, n))
    target = _reservoir("torch", W, output_var="li_op/v").run(inp, verbose=False).to_numpy("out")
    res = {}
    for pkg in PKGS:
        net = _step_net(pkg, np.zeros((n, n)), n)
        pass_losses = []
        for _ in range(6):
            net.reset()
            obs = net.fit_bptt(inp, target, optimizer="adam", lr=2e-2, update_steps=50,
                               sampling_steps=10, verbose=False)
            pass_losses.append(obs.to_numpy("loss"))
        res[pkg] = (np.asarray(pass_losses), obs.to_numpy("out"),
                    np.asarray(net.get_node("rnn")["weights"]), net)
    (l_t, o_t, w_t, tnet), (l_j, o_j, w_j, _) = res["torch"], res["jax"]
    means = l_t.mean(axis=1)
    assert means[-1] < means[0] * 0.5, f"truncated BPTT loss did not decrease: {means}"
    assert o_t.shape[1] == n
    assert tnet.last_fit["trajectory"] == "chain"
    np.testing.assert_allclose(l_t, l_j, rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(o_t, o_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("fused_bptt", ["auto", False])
def test_bptt_step_mode_chain_and_autograd_match_jax(fused_bptt):
    # the chain trajectory and plain autograd give the same chunks: a chain
    # with an input layer and a trained readout edge, sgd
    n, m, k, T = 6, 2, 3, 90
    rng = np.random.default_rng(21)
    W, W_in, W_out = (rng.normal(size=s) for s in ((n, n), (n, m), (k, n)))
    inp, tgt = rng.normal(size=(T, m)), rng.normal(size=(T, k))
    res = {}
    for pkg in PKGS:
        net = _reservoir(pkg, W * 0.3, W_in, train_params=["weights"])
        net.add_func_node("out", k, activation_function="tanh")
        net.add_edge("rnn", "out", weights=W_out, train="gd")
        kw = {"fused_bptt": fused_bptt} if pkg == "torch" else {}
        obs = net.fit_bptt(inp, tgt, optimizer="sgd", lr=5e-2, update_steps=20,
                           sampling_steps=4, verbose=False, **kw)
        res[pkg] = (obs.to_numpy("loss"), obs.to_numpy("out"),
                    np.asarray(net.get_node("rnn")["weights"]),
                    np.asarray(net.get_edge("rnn", "out").weights), net)
    assert res["torch"][4].last_fit["trajectory"] == ("chain" if fused_bptt else "autograd")
    for a, b in zip(res["torch"][:4], res["jax"][:4]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-10)


def test_bptt_step_mode_records_vars_matches_jax():
    # test_network.py:513 -- record_vars (reduced) during step mode take
    # plain autograd; shape, finiteness and values against JAX
    n = 5
    rng = np.random.default_rng(14)
    T = 100
    inp, tgt = rng.normal(size=(T, n)), rng.normal(size=(T, n))
    res = {}
    for pkg in PKGS:
        net = _step_net(pkg, np.zeros((n, n)), n)
        obs = net.fit_bptt(inp, tgt, optimizer="sgd", lr=1e-3, update_steps=20,
                           sampling_steps=5, verbose=False, record_vars=[("rnn", "v", True)])
        res[pkg] = (obs.to_numpy(("rnn", "v")), obs.to_numpy("loss"),
                    np.asarray(net.get_node("rnn")["weights"]), net)
    v_rec = res["torch"][0]
    assert v_rec.shape == (T // 5,) and np.all(np.isfinite(v_rec))
    assert res["torch"][3].last_fit["trajectory"] == "autograd"
    for a, b in zip(res["torch"][:3], res["jax"][:3]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-14)


def test_bptt_step_mode_short_input_no_update_chunks():
    # test_network.py:668 -- T < update_steps: forward only, no update, zero
    # losses on the sampling grid
    n = 4
    rng = np.random.default_rng(19)
    inp, tgt = rng.normal(size=(7, n)), rng.normal(size=(7, n))
    res = {}
    for pkg in PKGS:
        net = _step_net(pkg, np.zeros((n, n)), n)
        w_before = np.asarray(net.get_node("rnn")["weights"]).copy()
        obs = net.fit_bptt(inp, tgt, optimizer="sgd", lr=1e-2, update_steps=100,
                           sampling_steps=3, verbose=False)
        np.testing.assert_array_equal(np.asarray(net.get_node("rnn")["weights"]), w_before)
        res[pkg] = (np.asarray(obs["steps"]), obs.to_numpy("loss"), obs.to_numpy("out"),
                    np.asarray(net.get_node("rnn").y))
    np.testing.assert_array_equal(res["torch"][0], [0, 3, 6])
    assert not res["torch"][1].any()
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


def test_bptt_step_mode_global_sampling_grid_matches_jax():
    # test_network.py:729 -- u % s != 0 with a remainder of 3 steps: the
    # global grid, the loss of the last completed chunk, per-step outputs
    n = 4
    rng = np.random.default_rng(23)
    W = rng.normal(size=(n, n)) * 0.1
    T, u, s = 53, 10, 7
    inp, tgt = rng.normal(size=(T, n)), rng.normal(size=(T, n))
    res = {}
    for pkg in PKGS:
        net = _step_net(pkg, W, n)
        obs = net.fit_bptt(inp, tgt, optimizer="sgd", lr=0.0, update_steps=u,
                           sampling_steps=s, verbose=False, record_output=True,
                           record_loss=True)
        res[pkg] = (np.asarray(obs["steps"]), obs.to_numpy("loss"), obs.to_numpy("out"))
    steps, losses, out = res["torch"]
    np.testing.assert_array_equal(steps, np.arange(0, T, s))
    assert losses[0] == 0.0 and losses[1] == 0.0 and losses[2] != 0.0
    ref_out = _reservoir("torch", W, output_var="li_op/v").run(
        inp, sampling_steps=1, verbose=False).to_numpy("out")
    np.testing.assert_allclose(out, ref_out[steps], atol=1e-10)
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    # lr > 0 on the same grid: the updated weights through the chunks
    res = {}
    for pkg in PKGS:
        net = _step_net(pkg, W, n)
        obs = net.fit_bptt(inp, tgt, optimizer="adam", lr=1e-2, update_steps=u,
                           sampling_steps=s, verbose=False)
        res[pkg] = (obs.to_numpy("loss"), obs.to_numpy("out"),
                    np.asarray(net.get_node("rnn")["weights"]), np.asarray(net.get_node("rnn").y))
    for a, b in zip(res["torch"], res["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


# ------------------------------------------------------- run(truncate_steps)


def test_run_truncate_steps_matches_plain_run_and_jax():
    # test_coverage_extras.py:85 -- truncation cuts gradients only: the
    # records equal a run without it, in both packages
    n = 4
    rng = np.random.default_rng(2)
    W = rng.normal(size=(n, n)) * 0.3
    inp = rng.normal(size=(30, n))
    kw = dict(sampling_steps=3, verbose=False, record_vars=[("rnn", "v", True)])
    outs = {}
    for pkg in PKGS:
        for trunc in (None, 10, 1):
            extra = {} if trunc is None else {"truncate_steps": trunc}
            obs = _reservoir(pkg, W, output_var="li_op/v").run(inp, **kw, **extra)
            outs[pkg, trunc] = (obs.to_numpy("out"), obs.to_numpy(("rnn", "v")))
    for key, (o, v) in outs.items():
        np.testing.assert_allclose(o, outs["torch", None][0], atol=1e-12)
        np.testing.assert_allclose(v, outs["torch", None][1], atol=1e-12)
    with pytest.raises(ValueError, match="truncate_steps"):
        _reservoir("torch", W, output_var="li_op/v").run(inp, truncate_steps=0, verbose=False)


# ---------------------------------------------------------- legacy helpers


def test_legacy_api_wrappers_match_jax():
    # test_network.py:470 -- from_yaml + add_input_layer + add_output_layer
    # (an RLS output layer), float_precision honored; outputs against JAX
    # (the network and its input layer are float32, the node float64)
    n, m, k = 10, 2, 3
    rng = np.random.default_rng(12)
    W, v0, W_in, W_out = (rng.normal(size=s) for s in ((n, n), n, (n, m), (k, n)))
    x = rng.normal(size=(15, m))
    outs = {}
    for pkg, cls, kw in (("jax", JNetwork, {}), ("torch", Network, {"device": "cpu"})):
        net = cls.from_yaml(_prefix(pkg) + TANH, weights=W * 0.3, dt=1e-2,
                            source_var="tanh_op/r", target_var="li_op/r_in",
                            input_var="li_op/I_ext", output_var="li_op/v",
                            float_precision="float64", node_vars={"all/li_op/v": v0}, **kw)
        net.add_input_layer(m, weights=W_in)
        edge = net.add_output_layer(k, weights=W_out, train="rls", beta=0.99)
        net.compile()
        assert net.n_in == m and net.n_out == k
        assert net._train_edge == ("rnn", "output_layer")
        outs[pkg] = (net.run(x, verbose=False).to_numpy("out"), net)
    tnet = outs["torch"][1]
    assert isinstance(tnet.get_edge("rnn", "output_layer"), RLS)
    assert tnet.get_node("rnn").y.dtype == torch.float64
    assert outs["torch"][0].shape == (15, k)
    np.testing.assert_allclose(outs["torch"][0], outs["jax"][0], rtol=1e-6)


def test_describe_matches_jax():
    # the summary of a network with an input layer, a trained population, a
    # trained readout and an RLS edge is the JAX package's string
    n, m = 7, 2
    rng = np.random.default_rng(13)
    W, W_in = rng.normal(size=(n, n)) * 0.3, rng.normal(size=(n, m))
    text = {}
    for pkg in PKGS:
        net = _reservoir(pkg, W, W_in, train_params=["weights"])
        net.add_func_node("mid", n, activation_function="tanh")
        net.add_edge("rnn", "mid", weights=np.eye(n), train="gd")
        net.add_func_node("out", 1, activation_function="identity")
        net.add_edge("mid", "out", train="rls")
        text[pkg] = net.describe()
    assert "RLS (1x7 float64, carry: ['P'])" in text["torch"]
    assert text["torch"] == text["jax"]


def test_load_jax_params_carries_rls_weights_and_P():
    # a JAX network after an RLS fit: its weights and P carried over, the
    # port continues the fit as JAX does
    n, m, k, T = 9, 2, 1, 80
    rng = np.random.default_rng(15)
    W_res, W_in = rng.normal(size=(n, n)) * 0.4, rng.normal(size=(n, m))
    inp, tgt = rng.normal(size=(T, m)), rng.normal(size=(T, k))
    jnet, tnet = _rls_net("jax", W_res, W_in, k), _rls_net("torch", W_res, W_in, k)
    jnet.fit_rls(inp[:40], tgt[:40], update_steps=2, verbose=False)

    def numpy_tree(tree):
        return {kind: {lbl: {key: np.asarray(v) for key, v in sub.items()}
                       for lbl, sub in tree[kind].items()} for kind in ("nodes", "edges")}

    state = jnet.init_state()
    load_jax_params(tnet, numpy_tree(jnet.parameters_pytree()),
                    {"nodes": {lbl: np.asarray(y) for lbl, y in state["nodes"].items()
                               if y is not None}})
    for a, b in zip(_edge_arrays(tnet), _edge_arrays(jnet)):
        np.testing.assert_array_equal(a, b)
    jobs = jnet.fit_rls(inp[40:], tgt[40:], update_steps=2, sampling_steps=4, verbose=False)
    tobs = tnet.fit_rls(inp[40:], tgt[40:], update_steps=2, sampling_steps=4, verbose=False)
    np.testing.assert_allclose(tobs.to_numpy("out"), jobs.to_numpy("out"), rtol=1e-9,
                               atol=1e-12)
    for a, b in zip(_edge_arrays(tnet), _edge_arrays(jnet)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
