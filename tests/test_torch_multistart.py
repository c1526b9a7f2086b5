"""``fit_bptt_multistart`` of the port against the JAX package and against
the port's own ``fit_bptt_batch`` (CPU, float64 unless stated; the cases of
``tests/test_multistart.py`` without the mesh).  A start takes exactly the
update of ``fit_bptt_batch``, so one start, and each explicitly initialised
start, equals a separate ``fit_bptt_batch`` bit for bit; the default
perturbations are the JAX package's numpy draws, so the per-start losses
equal JAX's within 1e-9."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu_torch import Network
from rectipy_tpu_torch.network import _best_start
from rectipy_tpu_torch.ops import quant

TANH = "rectipy_tpu.models.rate_neurons.leaky_integrator.tanh"
QIF = "rectipy_tpu.models.spiking_neurons.qif.qif"

rng0 = np.random.default_rng(0)
N, B, T = 6, 4, 30
W0 = rng0.normal(scale=0.3, size=(N, N))
INS = rng0.normal(size=(B, T, 1))
TGTS = rng0.normal(size=(B, T, N)) * 0.1


def _build(W=None, cls=Network, eta=False):
    net = cls(dt=1e-2) if cls is JNetwork else cls(dt=1e-2, device="cpu")
    net.add_diffeq_node("p", TANH, weights=(W0 if W is None else W).copy(),
                        source_var="tanh_op/r", target_var="li_op/r_in",
                        input_var="li_op/I_ext", output_var="tanh_op/r",
                        float_precision="float64",
                        train_params=["weights"] + (["li_op/eta"] if eta else []))
    return net


def _w(net):
    return np.asarray(net.get_var("p", "weights"))


def test_single_start_equals_batch_fit():
    a, b = _build(), _build()
    obs_a = a.fit_bptt_multistart(INS, TGTS, n_starts=1, n_epochs=4, optimizer="sgd", lr=1e-1,
                                  verbose=False)
    obs_b = b.fit_bptt_batch(INS, TGTS, n_epochs=4, optimizer="sgd", lr=1e-1, verbose=False)
    np.testing.assert_array_equal(_w(a), _w(b))
    np.testing.assert_array_equal(obs_a["epoch_loss"], obs_b["epoch_loss"])
    assert a.last_fit == b.last_fit == {"trajectory": "chain", "fused_adam": False}


def test_explicit_inits_match_separate_fits_and_best_writeback():
    M = 3
    W_inits = np.random.default_rng(1).normal(scale=0.3, size=(M, N, N))
    c = _build()
    obs = c.fit_bptt_multistart(INS, TGTS, n_starts=M, start_inits={("p", "weights"): W_inits},
                                n_epochs=4, batch_size=2, optimizer="adam", lr=1e-2,
                                verbose=False)
    finals = []
    for m in range(M):
        d = _build(W_inits[m])
        od = d.fit_bptt_batch(INS, TGTS, n_epochs=4, batch_size=2, optimizer="adam", lr=1e-2,
                              verbose=False)
        finals.append((od["epoch_loss"][-1], _w(d)))
        np.testing.assert_array_equal(np.asarray(obs["start_epoch_loss"])[:, m],
                                      od["epoch_loss"])
    best = int(obs["best_start"][0])
    assert best == int(np.argmin([f[0] for f in finals]))
    np.testing.assert_array_equal(_w(c), finals[best][1])
    np.testing.assert_array_equal(obs["epoch_loss"], np.asarray(obs["start_epoch_loss"])[:, best])
    # exact trainable paths and (node, param) keys name the same leaf
    e = _build()
    e.fit_bptt_multistart(INS, TGTS, n_starts=M,
                          start_inits={("nodes", "p", "weights"): torch.as_tensor(W_inits)},
                          n_epochs=4, batch_size=2, optimizer="adam", lr=1e-2, verbose=False)
    np.testing.assert_array_equal(_w(e), _w(c))


@pytest.mark.parametrize("eta", [False, True], ids=["weights", "weights_and_eta"])
def test_default_perturbations_match_jax(eta):
    # the numpy draws of default_rng(seed + 1), one stream over the leaves in
    # the train tree's order: per-start losses equal JAX's, start 0 is the
    # unperturbed network
    kw = dict(n_starts=4, n_epochs=3, seed=5, init_scale=0.2, optimizer="adam", lr=1e-2,
              verbose=False)
    obs_t = _build(eta=eta).fit_bptt_multistart(INS, TGTS, **kw)
    jnet = _build(cls=JNetwork, eta=eta)
    obs_j = jnet.fit_bptt_multistart(INS, TGTS, **kw)
    sel = np.asarray(obs_t["start_epoch_loss"])
    assert sel.shape == (3, 4)
    np.testing.assert_allclose(sel, np.asarray(obs_j["start_epoch_loss"]), rtol=1e-9)
    assert obs_t["best_start"] == [int(obs_j["best_start"][0])]
    assert len(set(np.round(sel[-1], 12))) > 1, "starts did not diverge"
    again = _build(eta=eta).fit_bptt_multistart(INS, TGTS, **kw)
    np.testing.assert_array_equal(again["start_final_loss"], obs_t["start_final_loss"])
    single = _build(eta=eta).fit_bptt_batch(INS, TGTS, n_epochs=1, optimizer="adam", lr=1e-2,
                                            verbose=False)
    assert sel[0, 0] == single["epoch_loss"][0]


def test_verbose_equals_quiet():
    g, h = _build(), _build()
    kw = dict(n_starts=3, n_epochs=5, batch_size=2, seed=2, optimizer="adam", lr=1e-2)
    g.fit_bptt_multistart(INS, TGTS, verbose=False, **kw)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        h.fit_bptt_multistart(INS, TGTS, verbose=True, **kw)
    np.testing.assert_array_equal(_w(g), _w(h))
    assert "Best-start epoch loss" in out.getvalue()


def test_multistart_validation():
    net = _build()
    with pytest.raises(ValueError, match="n_starts"):
        net.fit_bptt_multistart(INS, TGTS, n_starts=0, verbose=False)
    with pytest.raises(KeyError, match="not a parameter"):
        net.fit_bptt_multistart(INS, TGTS, n_starts=2,
                                start_inits={("p", "nope"): np.zeros((2, N, N))}, verbose=False)
    with pytest.raises(ValueError, match="expected shape"):
        net.fit_bptt_multistart(INS, TGTS, n_starts=2,
                                start_inits={("p", "weights"): np.zeros((3, N, N))},
                                verbose=False)
    with pytest.raises(KeyError, match="not a trainable path"):
        net.fit_bptt_multistart(INS, TGTS, n_starts=2, start_inits={("p", "eta"): np.zeros(2)},
                                verbose=False)
    with pytest.raises(TypeError, match="DeviceMesh"):  # mesh= is ported: no DeviceMesh
        net.fit_bptt_multistart(INS, TGTS, n_starts=2, mesh=object(), verbose=False)
    with pytest.raises(ValueError, match="TRAINABLE"):
        net.fit_bptt_multistart(INS, TGTS, n_starts=2, verbose=False,
                                batch_vars={("p", "weights"): np.zeros((B, N, N))})
    with pytest.raises(TypeError, match="unexpected"):
        net.fit_bptt_multistart(INS, TGTS, n_starts=2, verbose=False, nope=1)


def test_generic_fused_node_refused():
    from rectipy_tpu_torch.ops.generic_fused import attach_generic_fused_step

    net = Network(1e-3, device="cpu")
    net.add_diffeq_node("p", "rectipy_tpu.models.spiking_neurons.lif.lif", weights=np.eye(8),
                        source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
                        op="lif_op", spike_var="spike", reset_var="v",
                        train_params=["weights"])
    net.compile()
    attach_generic_fused_step(net.get_node("p"))
    with pytest.raises(NotImplementedError, match="no backward"):
        net.fit_bptt_multistart(np.zeros((2, 5, 8)), np.zeros((2, 5, 8)), n_starts=2,
                                verbose=False)


def test_best_start_ignores_nan_losses():
    assert _best_start(np.array([np.nan, 2.0, 1.0])) == 2
    assert _best_start(np.array([3.0, np.inf, 1.0, np.nan])) == 2
    assert _best_start(np.array([np.nan, np.nan])) == 0
    assert _best_start(np.array([0.5, 2.0])) == 0


def test_multistart_nan_start_not_written_back():
    W_inits = np.stack([W0, np.full_like(W0, np.nan)])  # start 1 is poisoned
    c = _build()
    obs = c.fit_bptt_multistart(INS, TGTS, n_starts=2, start_inits={("p", "weights"): W_inits},
                                n_epochs=3, optimizer="adam", lr=1e-2, verbose=False)
    final = np.asarray(obs["start_final_loss"])
    assert not np.isfinite(final[1]) and np.isfinite(final[0])
    assert obs["best_start"] == [0]
    assert np.isfinite(_w(c)).all()


def test_int8_master_starts_at_float32():
    # int8_master on the chain trajectory, float32: the starts and the
    # int8 products of each (the plain versions here) against JAX's
    n, Bq, Tq = 16, 4, 20
    rng = np.random.default_rng(8)
    W = (rng.random((n, n)) < 0.3) * 0.2
    etas = rng.normal(size=n) * 2.0 + 1.0
    ins = rng.normal(size=(Bq, Tq, n)).astype(np.float32) * 5.0
    tgts = rng.normal(size=(Bq, Tq, n)).astype(np.float32) * 0.1

    def build(cls):
        net = (cls(1e-2, dtype=jnp.float32) if cls is JNetwork
               else cls(1e-2, device="cpu", dtype=torch.float32))
        net.add_diffeq_node("p", QIF, weights=W, source_var="s", target_var="s_in",
                            input_var="I_ext", output_var="s", op="qif_op", spike_var="spike",
                            spike_def="v", spike_threshold=1e2, spike_reset=-1e2,
                            dtype=net.dtype, node_vars={"all/qif_op/eta": etas},
                            coupling_dtype="int8_master", train_params=["weights"])
        return net

    kw = dict(n_starts=3, n_epochs=2, seed=1, init_scale=0.5, optimizer="adam", lr=1e-3,
              verbose=False)
    net = build(Network)
    obs = net.fit_bptt_multistart(ins, tgts, **kw)
    jobs = build(JNetwork).fit_bptt_multistart(ins, tgts, **kw)
    assert net.last_fit["trajectory"] == "chain"
    np.testing.assert_allclose(np.asarray(obs["start_epoch_loss"]),
                               np.asarray(jobs["start_epoch_loss"]), rtol=1e-4)
    single = build(Network)
    calls = []
    orig = quant.int8_mm
    try:  # a start's fit is fit_bptt_batch's: the same products, once per start
        quant.int8_mm = lambda *a, **k: calls.append(1) or orig(*a, **k)
        single.fit_bptt_batch(ins, tgts, n_epochs=2, optimizer="adam", lr=1e-3, verbose=False)
        n_single = len(calls)
        build(Network).fit_bptt_multistart(ins, tgts, **kw)
    finally:
        quant.int8_mm = orig
    assert n_single == 2 * Tq and len(calls) == 3 * n_single + n_single
