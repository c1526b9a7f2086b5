"""The port's SpikeNet, MultiSpikeResetNet and Heun/RK4 RateNet against the
JAX package (CPU, float64, inputs from numpy seeds), the ``add_diffeq_node``
dispatch to them, and the matching cases of ``tests/test_nodes.py`` run on
the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu_torch import MultiSpikeResetNet, Network, RateNet, SpikeNet, SpikeResetNet

QIF_RESET = "rectipy_tpu.models.spiking_neurons.qif.qif_reset"
IK = "rectipy_tpu.models.spiking_neurons.ik.ik"
TANH = "rectipy_tpu.models.rate_neurons.leaky_integrator.tanh"
QIF = "rectipy_tpu.models.spiking_neurons.qif.qif"


def _qif_reset(net, n=16, output_var="s", **kw):
    rng = np.random.default_rng(40)
    net.add_diffeq_node("qif", QIF_RESET, weights=rng.normal(size=(n, n)) * 0.5,
                        source_var="s", target_var="s_in", input_var="I_ext",
                        output_var=output_var,
                        op="qif_reset_op", spike_var="spike", reset_var="reset", reset=False,
                        spike_threshold=10.0, spike_reset=-10.0,
                        node_vars={"eta": rng.uniform(5.0, 9.0, n),
                                   "v": rng.uniform(-2.0, 9.9, n)}, **kw)
    net.compile()
    return net


def _ik(net, n=16, **kw):
    rng = np.random.default_rng(41)
    net.add_diffeq_node("ik", IK, weights=np.abs(rng.normal(size=(n, n))) * 0.02,
                        source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
                        op="ik_op", spike_var=["spike"], reset_var=["v"],
                        spike_threshold=40.0, spike_reset=-60.0,
                        node_vars={"eta": rng.uniform(150.0, 250.0, n),
                                   "v": rng.uniform(-60.0, 35.0, n)}, **kw)
    net.compile()
    return net


def _tanh(net, integrator, n=12):
    rng = np.random.default_rng(42)
    net.add_diffeq_node("rnn", TANH, weights=rng.normal(size=(n, n)) * 0.4,
                        source_var="tanh_op/r", target_var="li_op/r_in",
                        input_var="li_op/I_ext", output_var="tanh_op/r", integrator=integrator,
                        node_vars={"all/li_op/tau": rng.uniform(0.02, 0.05, n)})
    net.compile()
    return net


CASES = {  # network builder, steps, recorded state variable, label
    "spikenet": (_qif_reset, 1500, "v", "qif"),
    "multi_spike_reset": (_ik, 1500, "v", "ik"),
    "heun": (lambda net: _tanh(net, "heun"), 400, "li_op/v", "rnn"),
    "rk4": (lambda net: _tanh(net, "rk4"), 400, "li_op/v", "rnn"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_matches_jax_f64(case):
    # float64 on both sides: the matvecs sum in other orders, nothing else
    # differs; spike decisions must be identical
    build, steps, var, label = CASES[case]
    jnet = build(JNetwork(1e-2 if build is _ik else 1e-3, dtype=jnp.float64))
    tnet = build(Network(1e-2 if build is _ik else 1e-3, device="cpu", dtype=torch.float64))
    n = tnet.get_node(label).n_out
    inp = np.random.default_rng(43).normal(size=(steps, n)) * 2.0
    kw = dict(sampling_steps=5, record_output=True, record_vars=[(label, var, False)],
              verbose=False)
    jo, to = jnet.run(inp, **kw), tnet.run(inp, **kw)
    np.testing.assert_allclose(to.to_numpy("out"), jo.to_numpy("out"), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(to.to_numpy((label, var)), jo.to_numpy((label, var)),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tnet.get_node(label).y.numpy(),
                               np.asarray(jnet.get_node(label).y), rtol=1e-10, atol=1e-10)
    if case in ("spikenet", "multi_spike_reset"):
        assert jo.to_numpy("out").max() > 0.0, "no spikes -- weak test"


def test_add_diffeq_node_dispatch():
    net = _qif_reset(Network(1e-3, device="cpu"))
    node = net.get_node("qif")
    assert type(node) is SpikeNet
    assert (node._spike_key, node._reset_key) == ("qif_reset_op/spike", "qif_reset_op/reset")
    assert (node._spike_lo, node._spike_hi) == node._var_map["qif_reset_op/v"]
    multi = _ik(Network(1e-2, device="cpu")).get_node("ik")
    assert type(multi) is MultiSpikeResetNet
    assert multi._spike_keys == ["ik_op/spike"] and multi._segments == [multi._var_map["v"]]
    # spike_def names the spike-condition variable of a SpikeNet
    net2 = Network(1e-3, device="cpu")
    net2.add_diffeq_node("q", QIF_RESET, input_var="I_ext", output_var="s", N=3,
                         op="qif_reset_op", spike_var="spike", reset_var="reset", reset=False,
                         spike_def="qif_reset_op/s")
    node2 = net2.get_node("q")
    assert (node2._spike_lo, node2._spike_hi) == node2._var_map["qif_reset_op/s"] == (3, 6)
    assert type(_tanh(Network(1e-3, device="cpu"), "heun").get_node("rnn")) is RateNet


def test_spikenet_intrinsic_reset():
    """test_nodes.py's case: the -2*reset*v term mirrors v at spike time."""
    n = 3
    node = SpikeNet.from_pyrates(
        "neuron_model_templates.spiking_neurons.qif.qif_reset",
        weights=np.zeros((n, n)), source_var="s", target_var="s_in",
        input_var="I_ext", output_var="s", spike_var="spike", reset_var="reset",
        spike_threshold=10.0, spike_reset=-10.0, dt=1e-3,
        node_vars={"all/qif_reset_op/eta": 8.0}, dtype=torch.float64, device="cpu")
    mirrored = False
    v_prev = node["v"].numpy().copy()
    for _ in range(8000):
        node.forward(np.zeros(n))
        v = node["v"].numpy()
        if v_prev.max() > 9.0 and v.min() < 0.0:
            mirrored = True
            break
        v_prev = v.copy()
    assert mirrored, "intrinsic reset term did not mirror v after threshold crossing"


def test_multi_spike_reset_net():
    """test_nodes.py's case: a list spike_var builds a MultiSpikeResetNet
    that spikes and resets."""
    n = 4
    node = SpikeResetNet.from_pyrates(
        "neuron_model_templates.spiking_neurons.ik.ik", weights=np.zeros((n, n)),
        source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
        spike_var=["spike"], reset_var=["v"], spike_threshold=40.0, spike_reset=-60.0,
        dt=1e-2, node_vars={"all/ik_op/eta": 200.0}, dtype=torch.float64, device="cpu")
    assert isinstance(node, MultiSpikeResetNet)
    spiked = False
    for _ in range(5000):
        node.forward(np.zeros(n))
        if node["v"].numpy().min() <= -59.0 and node["s"].numpy().max() > 0:
            spiked = True
            break
    assert spiked


def _li_error(integrator, dt):
    tau, eta, T = 5.0, 1.0, 2.0
    exact = eta * tau * (1.0 - np.exp(-T / tau))
    node = RateNet.from_pyrates(
        "neuron_model_templates.rate_neurons.leaky_integrator.tanh",
        weights=np.zeros((1, 1)), source_var="tanh_op/r", target_var="li_op/r_in",
        input_var="li_op/I_ext", output_var="li_op/v", dt=dt,
        node_vars={"all/li_op/tau": tau, "all/li_op/eta": eta}, integrator=integrator,
        dtype=torch.float64, device="cpu")
    step, y = node.make_step(), node.y
    for _ in range(int(round(T / dt))):
        y, _ = step(y, node.args, torch.zeros(1, dtype=torch.float64))
    return abs(float(y[0]) - exact)


def test_heun_integrator_second_order():
    """test_nodes.py's case on the analytic leaky integrator."""
    e_eu_1, e_eu_2 = _li_error("euler", 2e-2), _li_error("euler", 1e-2)
    e_he_1, e_he_2 = _li_error("heun", 2e-2), _li_error("heun", 1e-2)
    assert 1.7 < e_eu_1 / e_eu_2 < 2.3
    assert 3.3 < e_he_1 / e_he_2 < 4.7
    assert e_he_2 < e_eu_2 / 50
    with pytest.raises(ValueError):
        RateNet.from_pyrates(TANH, weights=np.zeros((1, 1)), source_var="tanh_op/r",
                             target_var="li_op/r_in", input_var="li_op/I_ext",
                             output_var="li_op/v", integrator="rk99", device="cpu")
    with pytest.raises(ValueError):
        SpikeResetNet.from_pyrates(QIF, weights=np.zeros((2, 2)), source_var="s",
                                   target_var="s_in", input_var="I_ext", output_var="s",
                                   spike_var="spike", reset_var="v", integrator="heun",
                                   device="cpu")


def test_rk4_integrator_fourth_order():
    """test_nodes.py's case on the analytic leaky integrator."""
    e_1, e_2 = _li_error("rk4", 4e-2), _li_error("rk4", 2e-2)
    assert 12.0 < e_1 / e_2 < 20.0
    assert e_2 < _li_error("heun", 2e-2) / 100
    with pytest.raises(ValueError):
        SpikeNet.from_pyrates(QIF_RESET, weights=np.zeros((2, 2)), source_var="s",
                              target_var="s_in", input_var="I_ext", output_var="s",
                              integrator="rk4", device="cpu")


def test_fit_bptt_spikenet_matches_jax_f64():
    # the chain trajectory in the port and in JAX (both admit a SpikeNet):
    # the losses and trained weights agree.
    # The readout is v, which the coupling moves continuously once s > 0
    n, T, K = 8, 80, 3
    rng = np.random.default_rng(44)
    inp = rng.normal(size=(T, n)) * 3.0
    tgt = rng.normal(size=(T, n)) * 0.1
    res = {}
    for pkg, net in (("jax", JNetwork(1e-3, dtype=jnp.float64)),
                     ("torch", Network(1e-3, device="cpu", dtype=torch.float64))):
        _qif_reset(net, n=n, output_var="v", train_params=["weights"])
        obs = net.fit_bptt([inp] * K, [tgt] * K, optimizer="adam", lr=1e-2, verbose=False)
        res[pkg] = (np.asarray(obs["epoch_loss"]), np.asarray(net.get_node("qif")["weights"]))
        if pkg == "torch":
            assert net.last_fit["trajectory"] == "chain"
    np.testing.assert_allclose(res["torch"][0], res["jax"][0], rtol=1e-9)
    np.testing.assert_allclose(res["torch"][1], res["jax"][1], rtol=1e-8, atol=1e-12)
    assert res["jax"][0][-1] != res["jax"][0][0], "nothing trained"
    jax.clear_caches()
