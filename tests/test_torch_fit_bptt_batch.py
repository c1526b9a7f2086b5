"""``Network.fit_bptt_batch`` of the port against the JAX package and against
the port's own single-trial trainer.  CPU, float64 unless stated, inputs from
numpy seeds; the cases mirror ``tests/test_bptt_batch.py`` and
``tests/test_fit_batch_sweep.py``."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu_torch import Network
from rectipy_tpu_torch.ops import quant
from rectipy_tpu_torch.ops.generic_fused import attach_generic_fused_step

J, T_ = "neuron_model_templates.", "rectipy_tpu_torch.models."
TANH = "rate_neurons.leaky_integrator.tanh"
QIF = "spiking_neurons.qif.qif"


def _kw(cls, dtype="float64"):
    if cls is JNetwork:
        return J, dict(dtype=getattr(jnp, dtype))
    return T_, dict(dtype=getattr(torch, dtype), device="cpu")


def _chain(cls, W0, train=True, dtype="float64"):
    prefix, kw = _kw(cls, dtype)
    net = cls(1e-2, **kw)
    net.add_diffeq_node("p", prefix + TANH, weights=W0.copy(), source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext",
                        output_var="tanh_op/r", train_params=["weights"] if train else None)
    return net


def _trials(rng, B=4, T=30, n=6):
    return rng.normal(size=(B, T, 1)), rng.normal(size=(B, T, n)) * 0.1


def _w(net, label="p"):
    return np.asarray(net.get_node(label)["weights"], dtype=np.float64)


def _fit(net, ins, tgts, **kw):
    obs = net.fit_bptt_batch(ins, tgts, verbose=False, **kw)
    return {k: np.asarray(obs[k], dtype=np.float64) for k in ("train_loss", "epoch_loss")}


def test_b1_equals_repeated_epochs():
    # test_bptt_batch.py::test_batch_b1_equals_repeated_epochs: one trial,
    # full batch, K epochs == fit_bptt over the trial repeated K times
    rng = np.random.default_rng(3)
    W0 = rng.normal(scale=0.3, size=(6, 6))
    ins, tgts = _trials(rng)
    a = _chain(Network, W0)
    la = _fit(a, ins[:1], tgts[:1], n_epochs=5, optimizer="sgd", lr=1e-1)
    b = _chain(Network, W0)
    obs_b = b.fit_bptt([ins[0]] * 5, [tgts[0]] * 5, optimizer="sgd", lr=1e-1, verbose=False)
    np.testing.assert_array_equal(_w(a), _w(b))
    np.testing.assert_allclose(la["epoch_loss"], obs_b["epoch_loss"], rtol=1e-12)
    assert len(la["train_loss"]) == 5 and a.last_fit["trajectory"] == "chain"


def test_minibatch_of_one_without_shuffle_equals_epoch_mode():
    # test_bptt_batch.py::test_batch_mb1_noshuffle_equals_epoch_mode
    rng = np.random.default_rng(4)
    W0 = rng.normal(scale=0.3, size=(6, 6))
    ins, tgts = _trials(rng)
    a = _chain(Network, W0)
    a.fit_bptt_batch(ins, tgts, n_epochs=1, batch_size=1, shuffle=False, optimizer="sgd",
                     lr=1e-1, verbose=False)
    b = _chain(Network, W0)
    b.fit_bptt(list(ins), list(tgts), optimizer="sgd", lr=1e-1, verbose=False)
    np.testing.assert_array_equal(_w(a), _w(b))


@pytest.mark.parametrize("optimizer,batch_size,sampling", [("adam", 2, 1), ("sgd", None, 3),
                                                          ("rmsprop", 1, 2)])
def test_fit_matches_jax(optimizer, batch_size, sampling):
    # the JAX package's fit_bptt_batch: shuffled minibatches (the same numpy
    # permutations), full batch, sampling_steps; losses rtol 1e-9 and the
    # weights rtol 1e-6 (dW is rounded to float32 in both, test_bptt_fast.py)
    rng = np.random.default_rng(7)
    W0 = rng.normal(scale=0.3, size=(6, 6))
    ins, tgts = _trials(rng, T=30)
    tgts = tgts[:, : 30 // sampling]
    kw = dict(n_epochs=4, batch_size=batch_size, seed=11, optimizer=optimizer, lr=1e-2,
              sampling_steps=sampling)
    a, b = _chain(JNetwork, W0), _chain(Network, W0)
    b.compile()
    y_before = b.get_node("p").y.clone()
    la, lb = _fit(a, ins, tgts, **kw), _fit(b, ins, tgts, **kw)
    n_mb = 6 // 6 if batch_size is None else 4 // batch_size
    assert len(lb["train_loss"]) == 4 * (1 if batch_size is None else n_mb)
    assert len(lb["epoch_loss"]) == 4
    np.testing.assert_allclose(lb["train_loss"], la["train_loss"], rtol=1e-9)
    np.testing.assert_allclose(lb["epoch_loss"], la["epoch_loss"], rtol=1e-9)
    np.testing.assert_allclose(_w(b), _w(a), rtol=1e-6, atol=1e-10)
    assert torch.equal(b.get_node("p").y, y_before)  # the state is left unchanged


def test_shuffle_is_seeded_and_verbose_prints():
    # test_bptt_batch.py::test_batch_shuffle_seeded_and_state_untouched and
    # ::test_batch_chunked_equals_per_epoch_loop (the port has one loop)
    rng = np.random.default_rng(7)
    W0 = rng.normal(scale=0.3, size=(6, 6))
    ins, tgts = _trials(rng)
    a, b = _chain(Network, W0), _chain(Network, W0)
    la = _fit(a, ins, tgts, n_epochs=9, batch_size=2, seed=11, lr=1e-2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        obs_b = b.fit_bptt_batch(ins, tgts, n_epochs=9, batch_size=2, seed=11, lr=1e-2,
                                 verbose=True)
    np.testing.assert_array_equal(la["train_loss"], np.asarray(obs_b["train_loss"]))
    np.testing.assert_array_equal(_w(a), _w(b))
    assert "Progress: 9/9 training epochs finished." in buf.getvalue()
    c = _chain(Network, W0)
    lc = _fit(c, ins, tgts, n_epochs=9, batch_size=2, seed=12, lr=1e-2)
    assert not np.array_equal(lc["train_loss"], la["train_loss"])


def test_deferred_trajectory_matches_plain_autograd():
    # test_bptt_batch.py::test_batch_deferred_matches_plain_autodiff: the
    # batched chain trajectory == plain autograd over the batched step, 1e-9
    rng = np.random.default_rng(5)
    W0 = rng.normal(scale=0.3, size=(6, 6))
    ins, tgts = _trials(rng)
    a, b = _chain(Network, W0), _chain(Network, W0)
    la = _fit(a, ins, tgts, n_epochs=3, optimizer="sgd", lr=1e-1, fused_bptt="auto")
    lb = _fit(b, ins, tgts, n_epochs=3, optimizer="sgd", lr=1e-1, fused_bptt=False)
    assert a.last_fit["trajectory"] == "chain" and b.last_fit["trajectory"] == "autograd"
    np.testing.assert_allclose(la["train_loss"], lb["train_loss"], rtol=1e-9)
    np.testing.assert_allclose(_w(a), _w(b), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_steps_equal_the_full_minibatch(accum):
    # test_bptt_batch.py::test_batch_accum_steps_equals_full_minibatch
    rng = np.random.default_rng(11)
    W0 = rng.normal(scale=0.3, size=(6, 6))
    ins, tgts = _trials(rng, B=8)
    a, b = _chain(Network, W0), _chain(Network, W0)
    la = _fit(a, ins, tgts, n_epochs=4, batch_size=4, seed=5, optimizer="adam", lr=1e-2)
    lb = _fit(b, ins, tgts, n_epochs=4, batch_size=4, seed=5, optimizer="adam", lr=1e-2,
              accum_steps=accum)
    np.testing.assert_allclose(lb["train_loss"], la["train_loss"], rtol=1e-12)
    np.testing.assert_allclose(_w(b), _w(a), rtol=1e-12)


def test_full_batch_sgd_is_the_mean_of_per_trial_updates():
    # test_fit_batch_sweep.py::test_fit_sweep_full_batch_sgd_is_mean_of_per_trial_updates
    rng = np.random.default_rng(0)
    N, B, T = 5, 3, 20
    W0 = rng.normal(scale=0.3, size=(N, N))
    etas = np.linspace(-1.0, 2.0, B)
    ins = rng.normal(size=(B, T, 1))
    tgts = rng.normal(scale=0.2, size=(B, T, N))
    net = _chain(Network, W0)
    net.fit_bptt_batch(ins, tgts, n_epochs=1, optimizer="sgd", lr=1e-2,
                       batch_vars={("p", "eta"): etas}, verbose=False)
    singles = []
    for b in range(B):
        nb = _chain(Network, W0)
        nb.set_var("p", "eta", etas[b])
        nb.fit_bptt([ins[b]], [tgts[b]], optimizer="sgd", lr=1e-2, verbose=False)
        singles.append(_w(nb))
    assert np.abs(_w(net) - W0).max() > 1e-6
    assert np.abs(singles[0] - singles[-1]).max() > 1e-8
    np.testing.assert_allclose(_w(net), np.mean(singles, axis=0), rtol=1e-10, atol=1e-12)


def test_swept_conditions_survive_the_shuffle_and_match_jax():
    # test_fit_batch_sweep.py::test_fit_sweep_association_survives_shuffle
    # (lr = 0: every update is one trial's loss) and the shuffled per-trial
    # losses against JAX's
    rng = np.random.default_rng(1)
    N, B, T, E = 4, 4, 15, 2
    W0 = rng.normal(scale=0.3, size=(N, N))
    etas = np.linspace(-2.0, 2.0, B)
    ins = rng.normal(size=(B, T, 1))
    tgts = rng.normal(scale=0.2, size=(B, T, N))
    kw = dict(n_epochs=E, batch_size=1, optimizer="sgd", lr=0.0, seed=7,
              batch_vars={("p", "eta"): etas})
    losses = {s: _fit(_chain(Network, W0), ins, tgts, shuffle=s, **kw)["train_loss"]
              .reshape(E, B) for s in (False, True)}
    per_trial = losses[False][0]
    assert len(np.unique(per_trial.round(12))) == B
    for ep in range(E):
        np.testing.assert_allclose(np.sort(losses[True][ep]), np.sort(per_trial), rtol=1e-12)
    assert not np.allclose(losses[True][1], per_trial)
    lj = _fit(_chain(JNetwork, W0), ins, tgts, shuffle=True, **kw)["train_loss"]
    np.testing.assert_allclose(losses[True].reshape(-1), lj, rtol=1e-12)


def test_heterogeneous_conditions_train_like_jax():
    # test_fit_batch_sweep.py::test_fit_sweep_heterogeneous_conditions_train
    rng = np.random.default_rng(2)
    N, B, T = 6, 4, 30
    W0 = rng.normal(scale=0.2, size=(N, N))
    etas = np.linspace(-0.5, 1.5, B)
    ins = rng.normal(size=(B, T, 1))
    tgts = 0.1 * np.tanh(rng.normal(size=(B, T, N)))
    kw = dict(n_epochs=10, optimizer="adam", lr=5e-3, batch_vars={("p", "eta"): etas})
    a, b = _chain(JNetwork, W0), _chain(Network, W0)
    la, lb = _fit(a, ins, tgts, **kw), _fit(b, ins, tgts, **kw)
    assert lb["epoch_loss"][-1] < lb["epoch_loss"][0]
    np.testing.assert_allclose(lb["epoch_loss"], la["epoch_loss"], rtol=1e-9)
    np.testing.assert_allclose(_w(b), _w(a), rtol=1e-6, atol=1e-10)


def _int8m_qif(cls, W0, etas):
    prefix, kw = _kw(cls, "float32")
    net = cls(5e-3, **kw)
    net.add_diffeq_node("p", prefix + QIF, weights=W0, input_var="I_ext", output_var="s",
                        source_var="s", target_var="s_in", op="qif_op", spike_var="spike",
                        spike_def="v", spike_threshold=100.0, spike_reset=-100.0,
                        node_vars={"all/qif_op/eta": etas}, coupling_dtype="int8_master",
                        train_params=["weights"], dtype=kw["dtype"])
    return net


def test_int8_master_qif_chain_matches_jax_at_float32():
    # bench.py's ensemble phase at a small size: the int8_master QIF chain,
    # B trials through int8_mm/int8_mm_t (their plain versions here), float32
    n, B, T = 16, 3, 80
    rng = np.random.default_rng(6)
    W0 = (rng.random((n, n)) < 0.3) * (1.0 / (0.3 * n))
    etas = 200.0 + rng.normal(size=n) * 20.0  # suprathreshold: the trials spike
    ins = rng.normal(size=(B, T, n)) * 20.0
    tgts = rng.normal(size=(B, T, n)) * 0.1
    kw = dict(n_epochs=3, optimizer="adam", lr=1e-2)
    a, b = _int8m_qif(JNetwork, W0, etas), _int8m_qif(Network, W0, etas)
    quant.int8_mm.launches = quant.int8_mm_t.launches = 0
    la, lb = _fit(a, ins, tgts, **kw), _fit(b, ins, tgts, **kw)
    assert b.last_fit["trajectory"] == "chain"
    assert quant.int8_mm.launches == 0  # CPU tensors take the plain versions
    np.testing.assert_allclose(lb["epoch_loss"], la["epoch_loss"], rtol=1e-5)
    np.testing.assert_allclose(_w(b), _w(a), rtol=1e-4, atol=1e-6)
    assert np.abs(_w(b) - W0).max() > 1e-4


def test_class_loss_takes_integer_targets_like_jax():
    # loss='ce' with (B, R) integer class labels, a log-softmax readout
    rng = np.random.default_rng(8)
    n, k, B, T = 5, 3, 4, 12
    W0 = rng.normal(scale=0.3, size=(n, n))
    W_out = rng.normal(size=(k, n))

    def build(cls):
        net = _chain(cls, W0)
        net.add_func_node("ro", k, activation_function="identity")
        net.add_edge("p", "ro", weights=W_out.copy(), train="gd")
        net.compile()
        return net

    ins = rng.normal(size=(B, T, 1))
    tgts = rng.integers(0, k, size=(B, T))
    kw = dict(n_epochs=3, optimizer="adam", lr=1e-2, loss="ce", batch_size=2, seed=3)
    a, b = build(JNetwork), build(Network)
    la, lb = _fit(a, ins, tgts, **kw), _fit(b, ins, tgts, **kw)
    np.testing.assert_allclose(lb["train_loss"], la["train_loss"], rtol=1e-9)
    np.testing.assert_allclose(np.asarray(b.get_edge("p", "ro").weights),
                               np.asarray(a.get_edge("p", "ro").weights), rtol=1e-6)


def test_two_population_network_trains_through_autograd_like_jax():
    # a non-chain network (two populations): the graph trajectory ('auto',
    # as in JAX) and plain autograd over the batched step (fused_bptt=False)
    # in the port, the graph trajectory in JAX; same gradients
    rng = np.random.default_rng(9)

    def build(cls):
        prefix, kw = _kw(cls)
        r = np.random.default_rng(9)
        net = cls(1e-2, **kw)
        for lbl, n in (("a", 4), ("b", 3)):
            net.add_diffeq_node(lbl, prefix + TANH, weights=r.normal(size=(n, n)) * 0.3,
                                source_var="tanh_op/r", target_var="li_op/r_in",
                                input_var="li_op/I_ext", output_var="tanh_op/r",
                                train_params=["weights"])
        net.add_edge("a", "b", weights=r.normal(size=(3, 4)) * 0.5, train="gd")
        net.compile()
        return net

    ins = rng.normal(size=(3, 20, 4))
    tgts = rng.normal(size=(3, 20, 3)) * 0.1
    kw = dict(n_epochs=3, optimizer="adam", lr=1e-2)
    a, b, c = build(JNetwork), build(Network), build(Network)
    la, lb = _fit(a, ins, tgts, **kw), _fit(b, ins, tgts, **kw)
    lc = _fit(c, ins, tgts, fused_bptt=False, **kw)
    assert b.last_fit["trajectory"] == "graph" and c.last_fit["trajectory"] == "autograd"
    for net, res in ((b, lb), (c, lc)):
        np.testing.assert_allclose(res["epoch_loss"], la["epoch_loss"], rtol=1e-9)
        for lbl in ("a", "b"):
            np.testing.assert_allclose(_w(net, lbl), _w(a, lbl), rtol=1e-6, atol=1e-10)


def test_fit_validation_errors():
    # test_bptt_batch.py::test_batch_validation_errors and
    # ::test_batch_accum_steps_validation
    rng = np.random.default_rng(10)
    W0 = rng.normal(scale=0.3, size=(6, 6))
    ins, tgts = _trials(rng)
    net = _chain(Network, W0)
    with pytest.raises(ValueError, match="batch_size"):
        net.fit_bptt_batch(ins, tgts, batch_size=3, verbose=False)
    with pytest.raises(ValueError, match="first dimension"):
        net.fit_bptt_batch(ins, tgts[:2], verbose=False)
    with pytest.raises(ValueError, match=r"\(B, T, m\)"):
        net.fit_bptt_batch(ins[0], tgts[0], verbose=False)
    with pytest.raises(ValueError, match="No trainable parameters"):
        _chain(Network, W0, train=False).fit_bptt_batch(ins, tgts, verbose=False)
    with pytest.raises(ValueError, match=r"\(B, R, n_out\)"):
        net.fit_bptt_batch(ins, tgts[:, :, 0], verbose=False)
    with pytest.raises(ValueError, match=r"\(B, R\) integer class labels"):
        net.fit_bptt_batch(ins, tgts, loss="ce", verbose=False)
    for accum in (3, 0):
        with pytest.raises(ValueError, match="accum_steps"):
            net.fit_bptt_batch(ins, tgts, verbose=False, accum_steps=accum)
    with pytest.raises(TypeError, match="unexpected"):
        net.fit_bptt_batch(ins, tgts, verbose=False, bogus=1)


def test_batch_vars_validation():
    # test_fit_batch_sweep.py::test_fit_sweep_validation
    rng = np.random.default_rng(4)
    N, B, T = 4, 3, 10
    net = _chain(Network, rng.normal(size=(N, N)) * 0.2)
    ins, tgts = rng.normal(size=(B, T, 1)), rng.normal(size=(B, T, N))
    with pytest.raises(ValueError, match="TRAINABLE"):
        net.fit_bptt_batch(ins, tgts, batch_vars={("p", "weights"): np.zeros((B, N, N))},
                           verbose=False)
    with pytest.raises(KeyError, match="not a parameter"):
        net.fit_bptt_batch(ins, tgts, batch_vars={("p", "nope"): np.ones(B)}, verbose=False)
    with pytest.raises(ValueError, match="shape"):
        net.fit_bptt_batch(ins, tgts, batch_vars={("p", "eta"): np.ones(B + 1)},
                           verbose=False)
    with pytest.raises(KeyError, match="not found"):
        net.fit_bptt_batch(ins, tgts, batch_vars={("nodes", "q", "x"): np.ones(B)},
                           verbose=False)


@pytest.mark.parametrize("kw,item", [
    # the id the case had while mesh= was refused: it is ported
    # (tests/test_torch_parallel_train.py), and a mesh that is no DeviceMesh
    # raises TypeError
    pytest.param(dict(mesh=object()), "DeviceMesh", id="kw1-item 14"),
    # the test id of the refusal's first form, which named a follow-on
    pytest.param("generic_fused", "has no backward", id="generic_fused-follow-on g")])
def test_unported_fit_options_raise(kw, item):
    rng = np.random.default_rng(12)
    ins, tgts = _trials(rng)
    net = _chain(Network, rng.normal(size=(6, 6)),
                 dtype="float32" if kw == "generic_fused" else "float64")
    if kw == "generic_fused":  # the generic kernel has no backward, as JAX's has none
        net.compile()
        attach_generic_fused_step(net.get_node("p"))
        kw = {}
    with pytest.raises(TypeError if "mesh" in kw else NotImplementedError, match=item):
        net.fit_bptt_batch(ins, tgts, verbose=False, **kw)
