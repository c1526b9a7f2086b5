"""``Network.fit_bptt`` (epoch mode) of the port against the JAX package, and
its paths against each other: the deferred-gradient chain trajectory, plain
autograd, and the fused adam + requantize tail (``RECTIPY_FUSED_ADAM``).
CPU, float64, inputs from numpy seeds; the cases mirror
``tests/test_bptt_fast.py`` and ``tests/test_network.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu_torch import Network

J, T_ = "neuron_model_templates.", "rectipy_tpu_torch.models."
TANH = "rate_neurons.leaky_integrator.tanh"
QIF = "spiking_neurons.qif.qif"


def _nets():
    return ((JNetwork, J, dict(dtype=jnp.float64)),
            (Network, T_, dict(dtype=torch.float64, device="cpu")))


def _rate(cls, prefix, kw, W0, coupling=None):
    net = cls(1e-2, **kw)
    net.add_diffeq_node("rnn", prefix + TANH, weights=W0, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r", target_var="li_op/r_in",
                        train_params=["weights"], coupling_dtype=coupling)
    return net


def _int8m_qif(cls, prefix, kw, W0, etas):
    # dt=5e-3 so supercritical neurons cross threshold inside short runs
    net = cls(5e-3, **kw)
    net.add_diffeq_node("rnn", prefix + QIF, weights=W0, input_var="I_ext", output_var="s",
                        source_var="s", target_var="s_in", op="qif_op", spike_var="spike",
                        spike_def="v", spike_threshold=100.0, spike_reset=-100.0,
                        node_vars={"all/qif_op/eta": etas}, coupling_dtype="int8_master",
                        train_params=["weights"])
    return net


def _fit(net, inp, tgt, epochs, **kw):
    obs = net.fit_bptt([inp] * epochs, [tgt] * epochs, verbose=False, **kw)
    return np.asarray(obs["epoch_loss"]), np.asarray(net.get_node("rnn")["weights"])


def test_rate_net_fit_matches_jax_on_both_paths():
    # test_bptt_fast.py:116 -- float64, sampling_steps=3.  The port's chain
    # trajectory against JAX's (losses rtol 1e-9, weights rtol 1e-6 as that
    # test allows for dW's float32 rounding over the adam steps) and against
    # the port's plain autograd
    n, T = 8, 120
    rng = np.random.default_rng(4)
    W0 = rng.normal(size=(n, n)) * 0.3
    inp, tgt = rng.normal(size=(T, n)), rng.normal(size=(T // 3, n))
    kw = dict(optimizer="adam", lr=1e-2, sampling_steps=3)
    runs = {}
    for cls, prefix, nkw in _nets():
        runs[cls] = _fit(_rate(cls, prefix, nkw, W0), inp, tgt, 8, **kw)
    plain_net = _rate(Network, T_, _nets()[1][2], W0)
    l_plain, w_plain = _fit(plain_net, inp, tgt, 8, fused_bptt=False, **kw)
    assert plain_net.last_fit["trajectory"] == "autograd"
    (l_j, w_j), (l_t, w_t) = runs[JNetwork], runs[Network]
    np.testing.assert_allclose(l_t, l_j, rtol=1e-9)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(l_t, l_plain, rtol=1e-9)
    np.testing.assert_allclose(w_t, w_plain, rtol=1e-6, atol=1e-10)
    assert l_t[-1] < l_t[0], "training did not reduce the loss"


def test_qif_chain_with_trained_readout_matches_jax():
    # test_bptt_fast.py:249 -- input layer -> QIF SpikeResetNet -> tanh
    # readout with a trained Linear edge; losses and both trained weights
    n, n_in, n_out, T = 8, 2, 3, 150
    rng = np.random.default_rng(6)
    W0 = np.abs(rng.normal(size=(n, n))) * 0.4
    W_in, W_out0 = rng.normal(size=(n, n_in)), rng.normal(size=(n_out, n))
    inp, tgt = rng.normal(size=(T, n_in)) * 3.0, rng.normal(size=(T, n_out))
    etas = 2.0 + rng.random(n)
    res = {}
    for cls, prefix, kw in _nets():
        net = cls(1e-2, **kw)
        net.add_diffeq_node("qif", prefix + QIF, weights=W0, input_var="I_ext", output_var="s",
                            source_var="s", target_var="s_in", op="qif_op", spike_var="spike",
                            spike_def="v", spike_threshold=100.0, spike_reset=-100.0,
                            node_vars={"all/qif_op/eta": etas}, train_params=["weights"])
        net.add_func_node("inp", n_in, activation_function="identity")
        net.add_edge("inp", "qif", weights=W_in)
        net.add_func_node("out", n_out, activation_function="tanh")
        net.add_edge("qif", "out", weights=W_out0, train="gd")
        obs = net.fit_bptt([inp] * 6, [tgt] * 6, optimizer="adam", lr=1e-2, verbose=False)
        res[cls] = (np.asarray(obs["epoch_loss"]), np.asarray(net.get_node("qif")["weights"]),
                    np.asarray(net.get_edge("qif", "out").weights), net)
    (l_j, wn_j, we_j, _), (l_t, wn_t, we_t, tnet) = res[JNetwork], res[Network]
    assert tnet.last_fit["trajectory"] == "chain"
    np.testing.assert_allclose(l_t, l_j, rtol=1e-8)
    np.testing.assert_allclose(wn_t, wn_j, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(we_t, we_j, rtol=1e-6, atol=1e-10)
    assert np.abs(we_t - W_out0).max() > 1e-4, "readout edge did not train"


def test_teacher_student_readout_matches_jax():
    # test_network.py:201 at a shorter length: only the readout edge trains
    # (the population's output is an algebraic variable)
    n, m, k, T, epochs = 10, 3, 2, 100, 30
    rng = np.random.default_rng(5)
    W, W_in, w_out_t = (rng.normal(size=s) for s in ((n, n), (n, m), (k, n)))
    W *= 0.4
    inp = rng.normal(size=(T, m))
    losses, fits = {}, {}
    for cls, prefix, kw in _nets():
        def build(w_out, train):
            net = cls(1e-2, **kw)
            net.add_func_node("inp", m, activation_function="identity")
            net.add_diffeq_node("rnn", prefix + TANH, weights=W, input_var="li_op/I_ext",
                                output_var="tanh_op/r", source_var="tanh_op/r",
                                target_var="li_op/r_in")
            net.add_func_node("out", k, activation_function="identity")
            net.add_edge("inp", "rnn", weights=W_in)
            net.add_edge("rnn", "out", weights=w_out, train=train)
            return net

        target = build(w_out_t, None).run(inp, verbose=False).to_numpy("out")
        student = build(np.zeros((k, n)), "gd")
        obs = student.fit_bptt([inp] * epochs, [target] * epochs, optimizer="adam", lr=5e-2,
                               verbose=False)
        losses[cls] = np.asarray(obs["epoch_loss"])
        fits[cls] = np.asarray(student.get_edge("rnn", "out").weights)
    np.testing.assert_allclose(losses[Network], losses[JNetwork], rtol=1e-8)
    np.testing.assert_allclose(fits[Network], fits[JNetwork], rtol=1e-7, atol=1e-10)
    assert losses[Network][-1] < losses[Network][0] * 0.5


def test_int8_master_fused_adam_modes_match_jax(monkeypatch):
    # test_bptt_fast.py:1005: RECTIPY_FUSED_ADAM=off (optax formulas, float64
    # bias corrections) and on (one-pass adam + requantize, float32 bias
    # corrections; on CPU tensors adam_requant runs its plain version, the
    # JAX package's 'xla' mode) against JAX's off/xla; off vs on as the JAX
    # test holds them (the masters drift by the bias corrections' float32
    # rounding)
    n, T, n_ep = 16, 300, 4  # T=300: the population has spiked by then
    rng = np.random.default_rng(44)
    W0 = rng.normal(size=(n, n)) / np.sqrt(n)
    etas = rng.uniform(5.0, 15.0, n)
    inp = rng.normal(size=(T, 1)) * 5 + 10
    tgt = rng.normal(size=(T, n)) * 0.1
    runs = {}
    for j_mode, t_mode in (("off", "off"), ("xla", "on")):
        for (cls, prefix, kw), mode in zip(_nets(), (j_mode, t_mode)):
            monkeypatch.setenv("RECTIPY_FUSED_ADAM", mode)
            net = _int8m_qif(cls, prefix, kw, W0, etas)
            runs[cls, t_mode] = _fit(net, inp, tgt, n_ep, optimizer="adam", lr=1e-3)
            if cls is Network:
                assert net.last_fit["fused_adam"] == (mode == "on")
    for mode in ("off", "on"):
        (l_j, w_j), (l_t, w_t) = runs[JNetwork, mode], runs[Network, mode]
        np.testing.assert_allclose(l_t, l_j, rtol=1e-9)
        np.testing.assert_allclose(w_t, w_j, rtol=1e-9, atol=1e-12)
    (l_off, w_off), (l_on, w_on) = runs[Network, "off"], runs[Network, "on"]
    assert l_off[-1] < l_off[0], "training did not reduce the loss"
    np.testing.assert_allclose(l_on, l_off, rtol=1e-9)
    np.testing.assert_allclose(w_on, w_off, rtol=1e-3, atol=1e-4)


def test_fused_adam_eligibility_gates(monkeypatch):
    # test_bptt_fast.py:1037: the fused tail engages only for plain adam with
    # b1/b2/eps overrides and a scalar lr, on a trained int8_master coupling
    n, T = 12, 40
    rng = np.random.default_rng(45)
    W0 = rng.normal(size=(n, n)) / np.sqrt(n)
    etas = rng.uniform(5.0, 15.0, n)
    inp, tgt = rng.normal(size=(T, 1)), rng.normal(size=(T, n)) * 0.1
    kw = _nets()[1][2]
    monkeypatch.setenv("RECTIPY_FUSED_ADAM", "on")

    def fused(**fit_kw):
        net = _int8m_qif(Network, T_, kw, W0, etas)
        losses, _ = _fit(net, inp, tgt, 2, **fit_kw)
        assert np.isfinite(losses).all()
        return net.last_fit["fused_adam"], losses

    assert not fused(optimizer="sgd", lr=1e-3)[0]
    assert not fused(optimizer="adam", lr=1e-3, optimizer_kwargs={"nesterov": True})[0]
    assert not fused(optimizer="adam", lr=lambda count: 1e-3 * 0.5 ** count)[0]
    on, l_f = fused(optimizer="adam", lr=1e-3, optimizer_kwargs={"b1": 0.8, "eps": 1e-6})
    assert on
    # a frozen coupling (only eta trained): nothing to requantize
    net = _int8m_qif(Network, T_, kw, W0, etas)
    node = net.get_node("rnn")
    node.train_keys = [node._param_map["eta"]]
    _fit(net, inp, tgt, 2, optimizer="adam", lr=1e-3)
    assert not net.last_fit["fused_adam"]
    # the kill switch on the same network, and the b1/eps overrides honored
    monkeypatch.setenv("RECTIPY_FUSED_ADAM", "off")
    on, l_o = fused(optimizer="adam", lr=1e-3, optimizer_kwargs={"b1": 0.8, "eps": 1e-6})
    assert not on
    np.testing.assert_allclose(l_f, l_o, rtol=1e-9)


@pytest.mark.parametrize("mode", ["xla", "pallas", "auto", "plain"])
def test_invalid_fused_adam_mode_raises(monkeypatch, mode):
    monkeypatch.setenv("RECTIPY_FUSED_ADAM", mode)
    net = _rate(Network, T_, _nets()[1][2], np.eye(3))
    with pytest.raises(ValueError, match="off, on"):
        net.fit_bptt([np.ones((5, 3))], [np.ones((5, 3))], verbose=False)


def test_unported_fit_options_raise():
    net = _rate(Network, T_, _nets()[1][2], np.eye(3))
    data = ([np.ones((4, 3))], [np.ones((4, 3))])
    # step mode (2-D inputs) is ported: it runs, and its options raise as
    # epoch mode's do
    assert net.fit_bptt(np.ones((4, 3)), np.ones((4, 3)), update_steps=2,
                        verbose=False).to_numpy("loss").shape == (4,)
    # remat_steps is ported (tests/test_torch_bptt_heun_remat.py): step mode
    # ignores it, as the JAX package's does
    net.fit_bptt(np.ones((4, 3)), np.ones((4, 3)), remat_steps=2, verbose=False)
    net.fit_bptt(*data, remat_steps=2, verbose=False)
    # mesh= is ported (tests/test_torch_parallel_train.py): a mesh that is no
    # DeviceMesh raises
    with pytest.raises(TypeError, match="DeviceMesh"):
        net.fit_bptt(*data, mesh=object(), verbose=False)
    # fit_bptt_batch is ported, and so is its mesh=
    net.fit_bptt_batch(*data, remat_steps=2, verbose=False)
    with pytest.raises(TypeError, match="DeviceMesh"):
        net.fit_bptt_batch(*data, mesh=object(), verbose=False)
    # fused_bptt=True where neither trajectory applies (an RLS edge); a
    # two-population network takes the graph trajectory
    two = Network(1e-2, dtype=torch.float64, device="cpu")
    for label in ("a", "b"):
        two.add_diffeq_node(label, T_ + TANH, weights=np.eye(3), input_var="li_op/I_ext",
                            output_var="li_op/v", source_var="tanh_op/r",
                            target_var="li_op/r_in", train_params=["weights"])
    two.add_edge("a", "b", weights=np.eye(3), train="rls")
    with pytest.raises(ValueError, match="linear-family"):
        two.fit_bptt(*data, fused_bptt=True, verbose=False)
    two.fit_bptt(*data, verbose=False)  # 'auto': plain autograd
    assert two.last_fit["trajectory"] == "autograd"
    two.pop_edge("a", "b")
    two.add_edge("a", "b", weights=np.eye(3))
    two.fit_bptt(*data, fused_bptt=True, verbose=False)
    assert two.last_fit["trajectory"] == "graph"


def test_fit_records_last_epoch_run():
    # test_bptt_fast.py:1197: a recording fit returns the last epoch's run
    # (weights after K-1 updates, from the initial state) and the same
    # losses and weights as an unrecorded fit; the state is reset after it
    n, T, K, s = 8, 60, 4, 3
    rng = np.random.default_rng(36)
    W0 = rng.normal(size=(n, n)) * 0.3
    inp, tgt = rng.normal(size=(T, n)), rng.normal(size=(T, n))[::s] * 0.2
    kw = _nets()[1][2]
    fit_kw = dict(optimizer="adam", lr=1e-2, sampling_steps=s)
    net0 = _rate(Network, T_, kw, W0)
    l0, w0 = _fit(net0, inp, tgt, K, **fit_kw)
    net1 = _rate(Network, T_, kw, W0)
    obs1 = net1.fit_bptt([inp] * K, [tgt] * K, verbose=False, record_output=True,
                         record_vars=[("rnn", "v", True)], **fit_kw)
    np.testing.assert_allclose(np.asarray(obs1["epoch_loss"]), l0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(net1.get_node("rnn")["weights"]), w0, rtol=1e-12)
    net2 = _rate(Network, T_, kw, W0)
    _fit(net2, inp, tgt, K - 1, **fit_kw)
    ref = net2.run(inp, sampling_steps=s, verbose=False, record_vars=[("rnn", "v", True)])
    np.testing.assert_allclose(obs1.to_numpy("out"), ref.to_numpy("out"), rtol=1e-12)
    np.testing.assert_allclose(obs1.to_numpy(("rnn", "v")), ref.to_numpy(("rnn", "v")),
                               rtol=1e-12)
    np.testing.assert_array_equal(net1.state["rnn"].numpy(),
                                  _rate(Network, T_, kw, W0).state["rnn"].numpy())
