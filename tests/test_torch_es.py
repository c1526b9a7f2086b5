"""``fit_es`` of the port against the JAX package (CPU; the cases of
``tests/test_es.py`` without the mesh).  Both draw the candidates from the
same numpy generator, so at float64 the traces (``es_mean_loss``,
``es_best_loss``, ``es_sigma``, ``es_final_loss``, ``es_returned``) and the
written-back values equal JAX's within 1e-9.  The port's fused QIF node is
held to JAX's unfused network: the JAX package's fused node ignores a swept
``eta`` and would score identical candidates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu_torch import Network, attach_fused_qif_step
from rectipy_tpu_torch.inputs import Noise, Pulse

TANH = "rectipy_tpu.models.rate_neurons.leaky_integrator.tanh"
QIF = "rectipy_tpu.models.spiking_neurons.qif.qif"
QIF_SFA = "rectipy_tpu.models.spiking_neurons.qif.qif_sfa"
TRACES = ("es_mean_loss", "es_best_loss", "es_sigma")


def _net(cls, dt, dtype):
    if cls is JNetwork:
        return cls(dt, dtype=getattr(jnp, dtype))
    return cls(dt, device="cpu", dtype=getattr(torch, dtype))


def _li_net(cls, n, w, eta, dtype="float64"):
    net = _net(cls, 1e-2, dtype)
    net.add_diffeq_node("pop", TANH, weights=w, input_var="li_op/I_ext", output_var="li_op/v",
                        source_var="tanh_op/r", target_var="li_op/r_in", dtype=net.dtype,
                        node_vars={"all/li_op/eta": eta})
    return net


def _same(obs_t, obs_j, rtol=1e-9):
    for key in TRACES:
        np.testing.assert_allclose(np.asarray(obs_t[key]), np.asarray(obs_j[key]), rtol=rtol)
    np.testing.assert_allclose(obs_t["es_final_loss"], obs_j["es_final_loss"], rtol=rtol)
    assert obs_t["es_returned"] == obs_j["es_returned"]


def _li_case(n=4, T=150):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((n, n)) * 0.2
    inp = rng.normal(size=(T, n)) * 0.1
    targets = _li_net(JNetwork, n, w, 0.8).run(inp, sampling_steps=1,
                                                verbose=False).to_numpy("out")
    return w, inp, targets


@pytest.mark.parametrize("rank_shaping", [True, False], ids=["ranks", "z_scores"])
def test_fit_es_traces_match_jax(rank_shaping):
    # test_fit_es_recovers_excitability, at float64 and 20 generations
    n = 4
    w, inp, targets = _li_case(n)
    kw = dict(fit_vars=[("pop", "li_op/eta")], n_generations=20, pop_size=16, sigma=0.3,
              lr=0.3, sigma_decay=0.97, seed=1, rank_shaping=rank_shaping, verbose=False)
    student = _li_net(Network, n, w, 0.0)
    obs = student.fit_es(inp, targets, **kw)
    jstudent = _li_net(JNetwork, n, w, 0.0)
    _same(obs, jstudent.fit_es(inp, targets, **kw))
    eta = student.get_var("pop", "li_op/eta")
    np.testing.assert_allclose(eta.numpy(), np.asarray(jstudent.get_var("pop", "li_op/eta")),
                               rtol=1e-9)
    assert abs(float(eta) - 0.8) < 0.15
    assert len(obs["es_mean_loss"]) == len(obs["generations"]) == 20
    if rank_shaping:
        assert obs["es_best_loss"][-1] < obs["es_best_loss"][0] * 0.05


def _qif_net(cls, n, dt, eta0, dtype="float64"):
    net = _net(cls, dt, dtype)
    net.add_diffeq_node("qif", QIF, weights=np.zeros((n, n)), source_var="s",
                        target_var="s_in", input_var="I_ext", output_var="s", op="qif_op",
                        spike_var="spike", reset_var="v", dtype=net.dtype,
                        node_vars={"all/qif_op/eta": eta0})
    return net


def test_fit_es_spike_count_objective():
    # test_fit_es_spike_count_objective_via_raster: a callable loss on the
    # recorded counts; then a registry loss (mse) on the int32 counts, scored
    # on the device
    n, T, dt, target_count = 4, 400, 1e-3, 8.0
    inp = np.full((T, 1), 20.0)

    def count_loss(counts, _targets):
        return abs(float(np.asarray(counts).sum()) - target_count)

    kw = dict(fit_vars=[("qif", "qif_op/eta")], loss=count_loss, record_spikes=["qif"],
              objective_key=("qif", "spikes"), sampling_steps=50, n_generations=8,
              pop_size=12, sigma=50.0, lr=40.0, bounds={("qif", "qif_op/eta"): (-20.0, 400.0)},
              seed=5, verbose=False)
    net = _qif_net(Network, n, dt, 100.0)
    obs = net.fit_es(inp, np.zeros(1), **kw)
    _same(obs, _qif_net(JNetwork, n, dt, 100.0).fit_es(inp, np.zeros(1), **kw))
    assert obs["es_best_ever_loss"] <= obs["es_best_loss"][0]
    assert -20.0 <= float(net.get_var("qif", "qif_op/eta")) <= 400.0
    kw.update(loss="mse", n_generations=4)
    tgt = np.full((T // 50, n), 1.0)
    _same(_qif_net(Network, n, dt, 100.0).fit_es(inp, tgt, **kw),
          _qif_net(JNetwork, n, dt, 100.0).fit_es(inp, tgt, **kw))


def test_fit_es_objective_key_validation():
    n = 3
    inp = np.zeros((10, n))
    with pytest.raises(KeyError, match="not a recorded series"):
        _li_net(Network, n, np.zeros((n, n)), 0.0).fit_es(
            inp, np.zeros(1), fit_vars=[("pop", "li_op/eta")], objective_key=("pop", "spikes"),
            n_generations=1, pop_size=2, verbose=False)
    # mixed str/tuple record keys in the message
    with pytest.raises(KeyError, match="not a recorded series"):
        _qif_net(Network, 2, 1e-3, -5.0).fit_es(
            np.zeros((10, 1)), np.zeros(1), fit_vars=[("qif", "qif_op/eta")],
            record_spikes=["qif"], objective_key=("qif", "spike"), pop_size=2,
            n_generations=1, verbose=False)


def test_fit_es_state_untouched_and_bounds():
    n, T = 3, 60
    rng = np.random.default_rng(9)
    w = rng.standard_normal((n, n)) * 0.1
    inp = rng.normal(size=(T, n))
    kw = dict(fit_vars=[("pop", "li_op/eta")], n_generations=5, pop_size=8, sigma=0.2, lr=0.1,
              bounds={("pop", "li_op/eta"): (0.0, 0.4)}, seed=2, verbose=False)
    net, jnet = _li_net(Network, n, w, 0.5), _li_net(JNetwork, n, w, 0.5)
    net.run(inp, verbose=False)
    jnet.run(inp, verbose=False)
    y_before = net.get_node("pop").y.clone()
    _same(net.fit_es(inp, np.zeros((T, n)), **kw), jnet.fit_es(inp, np.zeros((T, n)), **kw))
    assert torch.equal(net.get_node("pop").y, y_before)
    eta = float(net.get_var("pop", "li_op/eta"))
    assert 0.0 <= eta <= 0.4


def test_fit_es_validation_errors():
    n = 3
    net = _li_net(Network, n, np.zeros((n, n)), 0.0)
    inp, tgt = np.zeros((10, n)), np.zeros((10, n))
    with pytest.raises(ValueError, match="even pop_size"):
        net.fit_es(inp, tgt, fit_vars=[("pop", "li_op/eta")], pop_size=7)
    with pytest.raises(ValueError, match="pop_size >= 2"):
        net.fit_es(inp, tgt, fit_vars=[("pop", "li_op/eta")], pop_size=1, antithetic=False)
    with pytest.raises(ValueError, match="at least one"):
        net.fit_es(inp, tgt, fit_vars=[])
    with pytest.raises(ValueError, match="not in fit_vars"):
        net.fit_es(inp, tgt, fit_vars=[("pop", "li_op/eta")],
                   bounds={("pop", "li_op/tau"): (0, 1)})
    with pytest.raises(KeyError, match="nope"):
        net.fit_es(inp, tgt, fit_vars=[("pop", "li_op/nope")], n_generations=1, pop_size=2,
                   verbose=False)
    with pytest.raises(ValueError, match="broadcast"):
        net.fit_es(inp, np.zeros((3, 7)), fit_vars=[("pop", "li_op/eta")], n_generations=1,
                   pop_size=2, verbose=False)
    with pytest.raises(TypeError, match="DeviceMesh"):  # mesh= is ported: no DeviceMesh
        net.fit_es(inp, tgt, fit_vars=[("pop", "li_op/eta")], mesh=object())
    with pytest.raises(ValueError, match=r"\(T, m\)"):
        net.fit_es(np.zeros((2, 10, n)), tgt, fit_vars=[("pop", "li_op/eta")])


def test_fit_es_survives_all_nan_generation():
    n = 3
    inp, tgt = np.zeros((20, n)), np.zeros((20, n))

    def make_loss():
        calls = {"n": 0}

        def flaky_loss(out, _t):
            calls["n"] += 1
            if 4 < calls["n"] <= 8:  # generation 1 (pop 4) diverges entirely
                return float("nan")
            return float(np.mean(np.asarray(out) ** 2))
        return flaky_loss

    kw = dict(fit_vars=[("pop", "li_op/eta")], n_generations=3, pop_size=4, sigma=0.1, lr=0.1,
              seed=0, verbose=False)
    obs = _li_net(Network, n, np.zeros((n, n)), 0.2).fit_es(inp, tgt, loss=make_loss(), **kw)
    jobs = _li_net(JNetwork, n, np.zeros((n, n)), 0.2).fit_es(inp, tgt, loss=make_loss(), **kw)
    hist = obs["es_mean_loss"]
    assert len(hist) == 3 and np.isnan(hist[1]) and np.isfinite(hist[0])
    np.testing.assert_allclose(hist, jobs["es_mean_loss"], rtol=1e-9)
    assert np.isfinite(obs["es_final_loss"])


def test_fit_es_input_specs():
    n, T = 3, 40
    net = _li_net(Network, n, np.zeros((n, n)), 0.0)
    with pytest.raises(ValueError, match="UNBATCHED"):
        net.fit_es(Noise(T, channels=n, seed=np.arange(4)), np.zeros((T, n)),
                   fit_vars=[("pop", "li_op/eta")], pop_size=4, n_generations=1, verbose=False)
    # an unbatched spec is the run fed its materialized drive
    spec = Pulse(T, channels=n, t_on=5, amp=1.0) + Noise(T, channels=n, scale=0.5, seed=2)
    kw = dict(fit_vars=[("pop", "li_op/eta")], pop_size=4, n_generations=3, seed=1,
              verbose=False)
    a = _li_net(Network, n, np.zeros((n, n)), 0.0).fit_es(spec, np.ones((T, n)), **kw)
    b = _li_net(Network, n, np.zeros((n, n)), 0.0).fit_es(
        spec.materialize(1e-2, torch.float64, device="cpu"), np.ones((T, n)), **kw)
    for key in TRACES + ("es_final_loss",):
        np.testing.assert_array_equal(a[key], b[key])


def test_fit_es_edge_coupling_weights_match_jax():
    # test_fit_es_recovers_edge_coupling_weights, 15 generations
    n, T = 4, 150
    rng = np.random.default_rng(5)
    w = rng.standard_normal((n, n)) * 0.2
    w_in_true = np.array([[1.2], [-0.7], [0.4], [0.9]])
    inp = rng.normal(size=(T, 1))

    def build(cls, w_in):
        net = _li_net(cls, n, w, 0.5)
        net.add_func_node("inp", 1, activation_function="identity")
        net.add_edge("inp", "pop", weights=np.asarray(w_in, dtype=np.float64))
        return net

    targets = build(JNetwork, w_in_true).run(inp, sampling_steps=1, verbose=False).to_numpy("out")
    kw = dict(fit_vars=[("edge", "inp", "pop", "weights")], n_generations=15, pop_size=16,
              sigma=0.3, lr=0.3, sigma_decay=0.97, seed=2, verbose=False)
    student, jstudent = build(Network, np.zeros((n, 1))), build(JNetwork, np.zeros((n, 1)))
    obs = student.fit_es(inp, targets, **kw)
    _same(obs, jstudent.fit_es(inp, targets, **kw))
    np.testing.assert_allclose(student.get_edge("inp", "pop").params["weights"].numpy(),
                               np.asarray(jstudent.get_edge("inp", "pop").params["weights"]),
                               rtol=1e-9)
    assert obs["es_final_loss"] < obs["es_best_loss"][0] * 0.25


def test_fit_es_interp_delay_matrix_matches_jax():
    # test_fit_es_recovers_delay_matrix, float32, 12 generations
    n, m, T = 3, 2, 200
    rng = np.random.default_rng(7)
    d_true = np.array([[4.0, 1.0], [0.0, 6.0], [2.0, 3.0]])
    w_fix = (0.8 + rng.random((n, m))) * np.where(rng.random((n, m)) < 0.5, -1.5, 1.5)
    inp = rng.normal(size=(T, m)).astype(np.float32)

    def build(cls, delays):
        net = _net(cls, 1e-2, "float32")
        net.add_diffeq_node("pop", TANH, weights=np.zeros((n, n)), input_var="li_op/I_ext",
                            output_var="li_op/v", source_var="tanh_op/r",
                            target_var="li_op/r_in", dtype=net.dtype,
                            node_vars={"all/li_op/eta": 0.0, "all/li_op/tau": 1.0})
        net.add_func_node("inp", m, activation_function="identity")
        net.add_edge("inp", "pop", weights=w_fix, delays=np.asarray(delays), mode="interp",
                     max_delay=8)
        return net

    targets = build(JNetwork, d_true).run(inp, sampling_steps=1, verbose=False).to_numpy("out")
    key = ("edge", "inp", "pop", "delays")
    kw = dict(fit_vars=[key], bounds={key: (0.0, 8.0)}, n_generations=12, pop_size=24,
              sigma=1.2, lr=0.8, sigma_decay=0.98, rank_shaping=False, seed=3, verbose=False)
    student = build(Network, np.full((n, m), 3.0))
    obs = student.fit_es(inp, targets, **kw)
    jobs = build(JNetwork, np.full((n, m), 3.0)).fit_es(inp, targets, **kw)
    _same(obs, jobs, rtol=1e-4)  # float32 runs: z-scores move theta continuously
    d_fit = student.get_edge("inp", "pop").params["delays"].numpy()
    assert d_fit.min() >= 0.0 and d_fit.max() <= 8.0
    assert obs["es_final_loss"] < obs["es_best_loss"][0]


def test_fit_es_edge_var_validation():
    n = 3
    net = _li_net(Network, n, np.random.default_rng(9).standard_normal((n, n)) * 0.2, 0.5)
    net.add_func_node("inp", 1, activation_function="identity")
    net.add_edge("inp", "pop", weights=np.ones((n, 1)), delays=np.array([[1, 0, 2]]).T)
    inp, tgt = np.zeros((20, 1)), np.zeros((20, n))
    with pytest.raises(KeyError, match="interp"):
        net.fit_es(inp, tgt, fit_vars=[("edge", "inp", "pop", "delays")], n_generations=1,
                   pop_size=2, verbose=False)
    with pytest.raises(KeyError, match="not a parameter"):
        net.fit_es(inp, tgt, fit_vars=[("edge", "inp", "pop", "nope")], n_generations=1,
                   pop_size=2, verbose=False)


def _sfa(cls, n, W, etas, fused):
    net = _net(cls, 1e-3, "float32")
    net.add_diffeq_node("qif", QIF_SFA, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", spike_var="spike", spike_def="v",
                        op="qif_sfa_op", spike_threshold=30.0, spike_reset=-30.0,
                        dtype=net.dtype, node_vars={"all/qif_sfa_op/eta": etas})
    net.compile()
    if fused:
        attach_fused_qif_step(net.get_node("qif"))
    return net


def test_fused_qif_node_matches_jax_unfused():
    # per-neuron eta of the fused node (its plain version here) against
    # JAX's unfused network, float32, the output objective with z-scores
    # (float32 round-off moves theta continuously, never reorders ranks);
    # the write-back refreshes the kernel's copy of eta
    n, T = 16, 200
    rng = np.random.default_rng(4)
    W = np.abs(rng.normal(size=(n, n))) * 0.02
    etas = rng.normal(size=n) + 100.0
    inp = rng.normal(size=(T, 1)) * 10.0
    targets = _sfa(JNetwork, n, W, etas + 5.0, False).run(inp, verbose=False).to_numpy("out")
    kw = dict(fit_vars=[("qif", "eta")], n_generations=3, pop_size=8, sigma=2.0, lr=2.0,
              rank_shaping=False, seed=6, verbose=False)
    net = _sfa(Network, n, W, etas, True)
    obs = net.fit_es(inp, targets, **kw)
    jnet = _sfa(JNetwork, n, W, etas, False)
    jobs = jnet.fit_es(inp, targets, **kw)
    _same(obs, jobs, rtol=2e-3)
    node = net.get_node("qif")
    eta = node.get_param("eta") if hasattr(node, "get_param") else node["eta"]
    np.testing.assert_allclose(eta.numpy(), np.asarray(jnet.get_var("qif", "eta")), rtol=1e-4)
    assert torch.equal(node._args["__eta_fused__"], eta.to(torch.float32))
    assert len(set(np.round(obs["es_best_loss"], 9))) > 1
