"""The port's ``Network.fit_eprop`` against the JAX package (CPU, float64
unless stated, inputs from numpy seeds; the eprop cases of
``tests/test_network.py``: the eprop half of
``test_fit_rls_and_eprop_record_vars_match_run``,
``test_fit_eprop_online_learning``,
``test_fit_eprop_float64_accumulator_precision`` and
``test_fit_eprop_nlms_step_size_robustness``).  Records and weights within
rtol 1e-10 of JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu_torch import Linear, Network

TANH = "rectipy_tpu.models.rate_neurons.leaky_integrator.tanh"
TIGHT = dict(rtol=1e-10, atol=1e-13)


def _reservoir(cls, W_res, W_in, readout=None, out_weights=None, dtype="float64"):
    n, m = W_res.shape[0], W_in.shape[1]
    net = (cls(1e-2, dtype=getattr(jnp, dtype)) if cls is JNetwork
           else cls(1e-2, dtype=getattr(torch, dtype), device="cpu"))
    net.add_func_node("inp", m, activation_function="identity")
    net.add_diffeq_node("rnn", TANH, weights=W_res, input_var="li_op/I_ext",
                        output_var="tanh_op/r", source_var="tanh_op/r", target_var="li_op/r_in")
    net.add_edge("inp", "rnn", weights=W_in)
    if readout:
        net.add_func_node("out", 1, activation_function="identity")
        net.add_edge("rnn", "out", weights=out_weights, train=readout)
    return net


def _weights(net):
    w = net.get_edge("rnn", "out").params["weights"]
    if isinstance(w, torch.Tensor):
        return (w.float() if w.dtype == torch.bfloat16 else w).numpy()
    return np.asarray(w, np.float64)


def test_fit_eprop_record_vars_match_run_and_jax():
    """The readout does not feed back: the recorded reservoir state equals a
    plain run's; the fit equals JAX's (outputs, losses, weights)."""
    n, m, T = 12, 2, 200
    rng = np.random.default_rng(31)
    W_res, W_in = rng.normal(size=(n, n)) * 0.4, rng.normal(size=(n, m))
    inp, target = rng.normal(size=(T, m)), rng.normal(size=(T, 1))
    w_out = rng.normal(size=(1, n)) * 0.1
    ref = _reservoir(Network, W_res, W_in, "rls").run(inp, sampling_steps=10, verbose=False,
                                                      record_vars=[("rnn", "v", False)])
    kw = dict(sampling_steps=10, verbose=False, lr=1e-3, record_vars=[("rnn", "v", False)])
    tnet = _reservoir(Network, W_res, W_in, "eprop", w_out)
    jnet = _reservoir(JNetwork, W_res, W_in, "eprop", w_out)
    tobs, jobs = tnet.fit_eprop(inp, target, **kw), jnet.fit_eprop(inp, target, **kw)
    np.testing.assert_allclose(tobs.to_numpy(("rnn", "v")), ref.to_numpy(("rnn", "v")),
                               rtol=1e-12)
    for key in ("out", "loss", ("rnn", "v")):
        np.testing.assert_allclose(tobs.to_numpy(key), jobs.to_numpy(key), err_msg=str(key),
                                   **TIGHT)
    np.testing.assert_allclose(_weights(tnet), _weights(jnet), **TIGHT)
    assert isinstance(tnet.get_edge("rnn", "out"), Linear)
    assert not tnet.get_edge("rnn", "out").train_keys
    assert tnet._train_edge == ("rnn", "out")


def test_fit_eprop_online_learning_with_and_without_feedback_matches_jax():
    """The delta rule tracks a representable teacher readout, with and
    without err_bar fed back into the input; each fit equals JAX's."""
    n, m = 12, 2
    rng = np.random.default_rng(15)
    W_res, W_in = rng.normal(size=(n, n)) * 0.3, rng.normal(size=(n, m))
    T = 3000
    time = np.arange(T) * 1e-2
    inp = np.stack([np.sin(2 * np.pi * 0.5 * time), np.cos(2 * np.pi * 0.2 * time)], 1)
    w_t = rng.normal(size=(n, 1))
    target = _reservoir(Network, W_res, W_in).run(inp, verbose=False).to_numpy("out") @ w_t
    w0 = rng.normal(size=(1, n))  # weights=None draws from an unseeded generator
    fb = 0.1 * np.random.default_rng(16).normal(size=(m, 1))
    kw = dict(epsilon=0.7, delta=0.7, lr=0.5, update_steps=1, sampling_steps=50,
              verbose=False)
    for extra in ({}, {"feedback_weights": fb}):
        tnet = _reservoir(Network, W_res, W_in, "eprop", w0)
        jnet = _reservoir(JNetwork, W_res, W_in, "eprop", w0)
        tobs = tnet.fit_eprop(inp, target, **kw, **extra)
        jobs = jnet.fit_eprop(inp, target, **kw, **extra)
        losses = tobs.to_numpy("loss")
        assert np.isfinite(losses).all() and np.mean(losses[-5:]) < 1e-3
        np.testing.assert_allclose(losses, jobs.to_numpy("loss"), rtol=1e-8, atol=1e-14)
        np.testing.assert_allclose(tobs.to_numpy("out"), jobs.to_numpy("out"), **TIGHT)
        np.testing.assert_allclose(_weights(tnet), _weights(jnet), **TIGHT)
    with pytest.raises(ValueError, match="feedback_weights"):
        tnet.fit_eprop(inp, target, feedback_weights=np.zeros((n, 1)))
    with pytest.raises(ValueError, match="No online-trainable edge"):
        _reservoir(Network, W_res, W_in).fit_eprop(inp, target)
    with pytest.raises(ValueError, match="agree in the first dimension"):
        tnet.fit_eprop(inp, target[:-1])
    with pytest.raises(TypeError, match="DeviceMesh"):  # mesh= is ported: no DeviceMesh
        tnet.fit_eprop(inp, target, mesh=object())


def test_fit_eprop_float64_accumulator_precision():
    """A float64 readout keeps float64 traces: with epsilon = 1 - 1e-9 the
    factor (1 - epsilon) is 0 in float32, and the weights would freeze."""
    n, m = 8, 2
    rng = np.random.default_rng(21)
    W_res, W_in = rng.normal(size=(n, n)) * 0.3, rng.normal(size=(n, m))
    w0 = rng.normal(size=(1, n))
    inp, tgt = rng.normal(size=(200, m)), rng.normal(size=(200, 1))
    kw = dict(epsilon=1.0 - 1e-9, delta=0.5, lr=1e6, decay=0.0, update_steps=1, verbose=False)
    tnet = _reservoir(Network, W_res, W_in, "eprop", w0)
    jnet = _reservoir(JNetwork, W_res, W_in, "eprop", w0)
    tnet.fit_eprop(inp, tgt, **kw)
    jnet.fit_eprop(inp, tgt, **kw)
    W1 = _weights(tnet)
    assert np.abs(W1 - w0).max() > 0, "the float64 trace was truncated to float32"
    np.testing.assert_allclose(W1, _weights(jnet), **TIGHT)


def test_fit_eprop_nlms_step_size_robustness():
    """normalize=True (NLMS): the instantaneous rule at lr 0.5 diverges as
    plain LMS but stays stable under NLMS across a 10x lr range; the
    trained readouts equal JAX's."""
    n, m = 12, 2
    rng = np.random.default_rng(18)
    W_res, W_in = rng.normal(size=(n, n)) * 0.3, rng.normal(size=(n, m))
    T = 4000
    time = np.arange(T) * 1e-2
    inp = np.stack([np.sin(2 * np.pi * 0.5 * time), np.cos(2 * np.pi * 0.2 * time)], 1)
    w_t = rng.normal(size=(n, 1))
    target = _reservoir(Network, W_res, W_in).run(inp, verbose=False).to_numpy("out") @ w_t

    def trained(cls, normalize, lr):
        net = _reservoir(cls, W_res, W_in, "eprop", np.zeros((1, n)))
        net.fit_eprop(inp[:T // 2], target[:T // 2], epsilon=0.0, delta=0.0, lr=lr,
                      update_steps=1, sampling_steps=50, normalize=normalize, verbose=False)
        _, loss = net.test(inp[T // 2:], target[T // 2:], loss="mse", sampling_steps=1,
                           verbose=False)
        return net, float(loss)

    _, loss = trained(Network, False, 0.5)
    assert not np.isfinite(loss), "instantaneous LMS at lr 0.5 should diverge here"
    for lr in (0.05, 0.2, 0.5):
        tnet, loss = trained(Network, True, lr)
        assert np.isfinite(loss) and loss < 0.5
        if lr == 0.2:
            jnet, jloss = trained(JNetwork, True, lr)
            np.testing.assert_allclose(_weights(tnet), _weights(jnet), rtol=1e-9)
            np.testing.assert_allclose(loss, jloss, rtol=1e-9)


@pytest.mark.parametrize("update_steps,decay", [(3, 0.5), (1, 1.0)])
def test_fit_eprop_update_steps_decay_and_rls_edge_match_jax(update_steps, decay):
    """Updates every ``update_steps`` with an L2 ``decay``, on an ``'rls'``
    edge (float64 in both packages here), and the record grid."""
    n, m, T = 10, 2, 300
    rng = np.random.default_rng(40 + update_steps)
    W_res, W_in = rng.normal(size=(n, n)) * 0.3, rng.normal(size=(n, m))
    inp, tgt = rng.normal(size=(T, m)), rng.normal(size=(T, 1))
    w0 = rng.normal(size=(1, n)) * 0.1
    kw = dict(epsilon=0.9, delta=0.5, lr=1e-2, decay=decay, update_steps=update_steps,
              sampling_steps=7, verbose=False)
    tnet = _reservoir(Network, W_res, W_in, "rls", w0)
    jnet = _reservoir(JNetwork, W_res, W_in, "rls", w0)
    tobs, jobs = tnet.fit_eprop(inp, tgt, **kw), jnet.fit_eprop(inp, tgt, **kw)
    np.testing.assert_array_equal(tobs["steps"], np.arange(0, T, 7))
    for key in ("out", "loss"):
        np.testing.assert_allclose(tobs.to_numpy(key), jobs.to_numpy(key), err_msg=key, **TIGHT)
    np.testing.assert_allclose(_weights(tnet), _weights(jnet), **TIGHT)
    assert np.abs(_weights(tnet) - w0).max() > 1e-4


def test_fit_eprop_bfloat16_readout_keeps_float32_traces():
    """A bfloat16 network: the readout's weights stay bfloat16, the traces,
    the update and the losses run in float32 (epsilon = 0.99 would lose
    ~17% of 1 - epsilon in bfloat16), as the JAX package's promote_types
    rule gives.  (A bfloat16 reservoir parts from JAX's within a few steps:
    XLA keeps float32 between fused operations, the port rounds each.)"""
    n, m, T = 12, 2, 400
    rng = np.random.default_rng(44)
    W_res, W_in = rng.normal(size=(n, n)) * 0.3, rng.normal(size=(n, m))
    inp, tgt = rng.normal(size=(T, m)), rng.normal(size=(T, 1))
    w0 = rng.normal(size=(1, n)) * 0.1
    kw = dict(epsilon=0.99, delta=0.9, lr=5e-2, sampling_steps=20, verbose=False)
    tnet = _reservoir(Network, W_res, W_in, "eprop", w0, dtype="bfloat16")
    jnet = _reservoir(JNetwork, W_res, W_in, "eprop", w0, dtype="bfloat16")
    assert tnet.get_edge("rnn", "out").params["weights"].dtype == torch.bfloat16
    tobs, jobs = tnet.fit_eprop(inp, tgt, **kw), jnet.fit_eprop(inp, tgt, **kw)
    assert tnet.get_edge("rnn", "out").params["weights"].dtype == torch.bfloat16
    assert tobs.to_numpy("loss").dtype == jobs.to_numpy("loss").dtype == np.float32
    assert np.isfinite(tobs.to_numpy("loss")).all()
    assert np.abs(_weights(tnet) - w0).max() > 1e-3
