"""The port's main path as a whole against the JAX package: the bench network
(qif_sfa SpikeResetNet fed by a tanh node through a Linear edge), its
windowed ``run`` records, ``reset`` and ``load_jax_params``.  CPU, inputs from
numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.ops.kernels import attach_fused_qif_step as j_attach
from rectipy_tpu_torch import Network, attach_fused_qif_step, load_jax_params

QIF_SFA = "rectipy_tpu.models.spiking_neurons.qif.qif_sfa"


def _bench_weights(n, seed=0):
    # 10% fixed fan-in, row-normalised, as bench.py builds it
    rng = np.random.default_rng(seed)
    W = np.zeros((n, n))
    n_conns = max(1, int(n * 0.1))
    cols = np.argsort(rng.random((n, n)), axis=1)[:, :n_conns]
    W[np.repeat(np.arange(n), n_conns), cols.ravel()] = 1.0 / n_conns
    etas = -5.0 + np.tan((np.pi / 2) * (2.0 * np.arange(1, n + 1) - n - 1) / (n + 1))
    return W, etas + 60.0  # shifted so the short test runs spike


def _bench_net(cls, n, dtype, **net_kw):
    W, etas = _bench_weights(n)
    net = cls(1e-3, dtype=dtype, **net_kw)
    net.add_diffeq_node(
        "qif", QIF_SFA, weights=W, source_var="s", target_var="s_in", input_var="I_ext",
        output_var="s", spike_var="spike", spike_def="v", op="qif_sfa_op",
        spike_threshold=1e2, spike_reset=-1e2, dtype=dtype,
        node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/alpha": 0.05,
                   "all/qif_sfa_op/k": 15.0})
    net.add_func_node("inp", 1, activation_function="tanh")
    net.add_edge("inp", "qif")  # unseeded random weights: carried across below
    net.compile()
    return net


def _to_numpy(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def _pair(n=128, dtype="float64"):
    jnet = _bench_net(JNetwork, n, getattr(jnp, dtype))
    tnet = _bench_net(Network, n, getattr(torch, dtype), device="cpu")
    load_jax_params(tnet, _to_numpy(jnet.parameters_pytree()), _to_numpy(jnet.init_state()))
    return jnet, tnet


def _drive(steps):
    inp = np.zeros((steps, 1))
    inp[steps // 4: 3 * steps // 4, 0] = 3.0
    return inp


RUNS = [  # steps, sampling_steps, cutoff, record_output, record_vars
    (1000, 100, 0, False, [("qif", "s", True)]),  # bench recording
    (1037, 100, 250, True, [("qif", "s", True), ("qif", "v", False)]),  # tail + cutoff
    (301, 1, 0, True, [("qif", "x", False)]),
    (250, 7, 13, True, [("qif", "v", True), ("qif", "s", False)]),
    (1, 10, 0, True, [("qif", "s", True)]),  # a single step
]


@pytest.mark.parametrize("steps,s,cutoff,rec_out,rec_vars", RUNS)
def test_run_records_match_jax_f64(steps, s, cutoff, rec_out, rec_vars):
    # float64 on both sides; the records agree to near rounding (the matvec
    # sums in another order, and spiking amplifies differences slightly)
    jnet, tnet = _pair()
    kw = dict(sampling_steps=s, cutoff=cutoff, record_output=rec_out, record_vars=rec_vars,
              verbose=False)
    jo = jnet.run(_drive(steps), **kw)
    to = tnet.run(_drive(steps), **kw)
    assert to["steps"] == jo["steps"]
    keys = [(lbl, var) for lbl, var, _ in rec_vars] + (["out"] if rec_out else [])
    for key in keys:
        np.testing.assert_allclose(to.to_numpy(key), jo.to_numpy(key), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tnet.get_node("qif").y.numpy(),
                               np.asarray(jnet.get_node("qif").y), rtol=1e-9, atol=1e-8)
    if steps == 1000:
        assert to.to_numpy(("qif", "s")).max() > 0.0, "no spiking activity -- weak test"


def test_reset_zeroes_every_node_state():
    jnet, tnet = _pair(n=32)
    for net in (jnet, tnet):
        net.run(_drive(200), verbose=False)
        net.reset()
    assert torch.count_nonzero(tnet.get_node("qif").y) == 0
    np.testing.assert_array_equal(tnet.get_node("qif").y.numpy(), np.asarray(jnet.get_node("qif").y))
    tnet.reset({"qif": np.arange(96.0)})
    np.testing.assert_array_equal(tnet.get_node("qif").y.numpy(), np.arange(96.0))


def test_forward_and_vars_match_jax():
    jnet, tnet = _pair(n=16)
    for k in range(5):
        np.testing.assert_allclose(tnet.forward([0.5 * k]).numpy(),
                                   np.asarray(jnet.forward(np.asarray([0.5 * k]))), rtol=1e-12)
    for var in ("v", "s", "x", "eta", "tau"):
        np.testing.assert_allclose(np.asarray(tnet.get_var("qif", var)),
                                   np.asarray(jnet.get_var("qif", var)), rtol=1e-12)
    for net in (jnet, tnet):
        net.set_var("qif", "v", np.full(16, 3.0))
    np.testing.assert_array_equal(tnet.get_var("qif", "v").numpy(), np.full(16, 3.0))
    assert tnet.get_var("inp", "n_out") == 1  # graph-attribute fallback
    with pytest.raises(KeyError):
        tnet.set_var("qif", "no_such_var", 1.0)


def test_load_jax_params_from_attached_jax_network():
    # JAX keeps a fused node's state padded and its coupling transposed and
    # padded (__wt_pad__/__eta_pad__); the port rebuilds its own copies.
    # f32, fused on both sides: the Pallas kernel in interpret mode against
    # the port's plain version behind the wrapper
    n = 40
    jnet, _ = _pair(n=n, dtype="float32")
    j_attach(jnet.get_node("qif"), tile=128, interpret=True)
    jnet.run(_drive(120), verbose=False)  # a non-trivial, padded state
    tnet = _bench_net(Network, n, torch.float32, device="cpu")
    attach_fused_qif_step(tnet.get_node("qif"))
    jparams, jstate = _to_numpy(jnet.parameters_pytree()), _to_numpy(jnet.init_state())
    assert jstate["nodes"]["qif"].shape[0] == 3 * 128  # padded to the tile
    load_jax_params(tnet, jparams, jstate)
    jnode, tnode = jnet.get_node("qif"), tnet.get_node("qif")
    np.testing.assert_array_equal(tnode.y.numpy(), np.asarray(jnode._fused_unpad(jnode.y)))
    np.testing.assert_array_equal(tnode.args["__w_fused__"].numpy(),
                                  np.asarray(jnode.args["weights"], dtype=np.float32))
    kw = dict(sampling_steps=10, record_vars=[("qif", "s", True)], verbose=False)
    jo, to = jnet.run(_drive(400), **kw), tnet.run(_drive(400), **kw)
    np.testing.assert_allclose(to.to_numpy("out"), jo.to_numpy("out"), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to.to_numpy(("qif", "s")), jo.to_numpy(("qif", "s")),
                               rtol=1e-4, atol=1e-4)


def test_load_jax_params_rejects_unknown_keys():
    jnet, tnet = _pair(n=8)
    params = _to_numpy(jnet.parameters_pytree())
    params["nodes"]["qif"]["qif_sfa_op/no_such_param"] = np.zeros(())
    with pytest.raises(KeyError, match="no_such_param"):
        load_jax_params(tnet, params)
    with pytest.raises(KeyError, match="ghost"):
        load_jax_params(tnet, {"nodes": {"ghost": {}}})
    with pytest.raises(KeyError, match="a->b"):
        load_jax_params(tnet, {"edges": {"a->b": {}}})


def test_network_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Network(1e-3)
    assert Network(1e-3, device="cpu").device == torch.device("cpu")


def test_run_accepts_tensor_inputs_and_checks_shapes():
    _, tnet = _pair(n=8)
    obs = tnet.run(torch.zeros(5, 1), verbose=False)
    assert obs.to_numpy("out").shape == (5, 8)
    with pytest.raises(ValueError, match="channels"):
        tnet.run(np.zeros((5, 3)), verbose=False)
    with pytest.raises(ValueError, match=r"\(T, m\)"):
        tnet.run(np.zeros(5), verbose=False)


def test_unported_network_features_raise():
    _, tnet = _pair(n=8)
    # masks, delays and block-sparse weights are ported
    # (tests/test_torch_edges.py, tests/test_torch_block_edges.py); a block
    # edge with a mask is refused, as in the JAX package
    from rectipy_tpu_torch import BlockSparseCoupling, LinearMasked, LinearMemory

    blocks = BlockSparseCoupling(np.ones((1, 1, 8, 8)), np.zeros((1, 1)))
    with pytest.raises(ValueError, match="per-block delays"):
        tnet.add_edge("qif", "qif", weights=blocks, mask=np.ones((8, 8)))
    assert isinstance(tnet.add_edge("inp", "qif", mask=np.ones((8, 1))), LinearMasked)
    assert isinstance(tnet.add_edge("inp", "qif", delays=np.ones(1, dtype=int)), LinearMemory)
    # the RLS readout and run(truncate_steps=) are ported; eprop/stdp are not
    for rule in ("eprop", "stdp"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
            tnet.add_edge("inp", "qif", train=rule)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tnet.run(np.zeros((5, 1)), record_spikes=["qif"], verbose=False)
    # SpikeNet (reset=False) is ported; a circuit of mixed templates is not
    from rectipy_tpu_torch.dsl.parser import CircuitTemplate, NodeTemplate

    mixed = CircuitTemplate("c", {"a": NodeTemplate.from_yaml(QIF_SFA),
                                  "b": NodeTemplate.from_yaml(QIF_SFA.replace("qif_sfa", "qif"))})
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 3"):
        tnet.add_diffeq_node("q2", mixed, input_var="I_ext", output_var="s",
                             spike_var="spike", reset_var="v")
