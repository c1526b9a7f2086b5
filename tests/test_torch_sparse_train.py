"""Training through block-sparse node couplings, against the JAX package:
``fit_bptt`` through the chain trajectory's block contractions
(``ops/bptt.py::_make_sparse_matvec``, ``ops/quant.py::make_block_int8_ops``)
against plain autograd and against JAX's fit, the ``int8_master`` block
trajectory against the composed step, and ``fit_bptt_batch`` of a
block-coupled node.

Mirrors ``test_fit_bptt_fused_block_sparse_matches_plain`` and
``test_int8_master_block_sparse_trains_and_matches_plain`` in
``tests/test_bptt_fast.py`` and ``test_batch_blocksparse_deferred_matches_plain``
in ``tests/test_bptt_batch.py``: float64, the same seeded numpy inputs
through both packages, the reference tests' tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.ops.sparse import block_random_connectivity
from rectipy_tpu_torch import Network
from rectipy_tpu_torch.ops.bptt import make_coupled_traj

PREFIX = {"jax": "rectipy_tpu.models.", "torch": "rectipy_tpu_torch.models."}
QIF = "spiking_neurons.qif.qif"


def _net(pkg, A, etas, coupling_dtype=None):
    net = (JNetwork(1e-2, dtype=jnp.float64) if pkg == "jax"
           else Network(1e-2, dtype=torch.float64, device="cpu"))
    net.add_diffeq_node("qif", PREFIX[pkg] + QIF, weights=A, input_var="I_ext",
                        output_var="s", source_var="s", target_var="s_in", op="qif_op",
                        spike_var="spike", spike_def="v", spike_threshold=100.0,
                        spike_reset=-100.0, node_vars={"all/qif_op/eta": etas},
                        coupling_dtype=coupling_dtype, train_params=["weights"])
    net.compile()
    return net


def _fit(pkg, A, etas, inp, tgt, fused, epochs, coupling_dtype=None):
    net = _net(pkg, A, etas, coupling_dtype)
    obs = net.fit_bptt([inp] * epochs, [tgt] * epochs, optimizer="adam", lr=1e-2,
                       verbose=False, fused_bptt=fused)
    return (np.asarray(obs["epoch_loss"]), np.asarray(net.get_node("qif")["weights"]),
            getattr(net, "last_fit", None))


def test_fit_bptt_fused_block_sparse_matches_plain():
    # test_bptt_fast.py:330 -- the chain trajectory's block contractions
    # (per-block dW after the backward loop, a block scatter for A^T delta)
    # against plain autograd, and both against the JAX package's fit
    n, bs, T = 64, 16, 300
    rng = np.random.default_rng(10)
    A = block_random_connectivity(n, n, 8, block_size=bs, seed=3)
    etas = 2.0 + rng.random(n)
    inp = rng.normal(size=(T, n)) * 2.0
    tgt = rng.normal(size=(T, n)) * 0.1
    l_fast, w_fast, info = _fit("torch", A, etas, inp, tgt, True, 8)
    assert info["trajectory"] == "chain"
    l_std, w_std, info = _fit("torch", A, etas, inp, tgt, False, 8)
    assert info["trajectory"] == "autograd"
    assert w_fast.ndim == 4, "blocks lost their shape through training"
    np.testing.assert_allclose(l_fast, l_std, rtol=1e-8)
    np.testing.assert_allclose(w_fast, w_std, rtol=0.0, atol=1e-5 * np.abs(w_std).max())
    assert np.abs(w_fast - A.blocks).max() > 1e-5, "blocks did not train"
    l_jax, w_jax, _ = _fit("jax", A, etas, inp, tgt, True, 8)
    np.testing.assert_allclose(l_fast, l_jax, rtol=1e-8)
    np.testing.assert_allclose(w_fast, w_jax, rtol=0.0, atol=1e-5 * np.abs(w_jax).max())


def test_int8_master_block_sparse_trains_and_matches_plain():
    # test_bptt_fast.py:622 -- the int8_master block trajectory equals the
    # composed step bit for bit, tracks the float run, trains, and the chain
    # and plain-autograd fits agree with each other and with JAX's
    n, bs, T = 64, 16, 250
    rng = np.random.default_rng(17)
    A = block_random_connectivity(n, n, 8, block_size=bs, seed=5)
    etas = 6.0 + rng.random(n)
    inp = rng.normal(size=(T, n)) * 2.0
    tgt = rng.normal(size=(T, n)) * 0.1
    out_q = _net("torch", A, etas, "int8_master").run(inp, verbose=False).to_numpy("out")
    out_f = _net("torch", A, etas).run(inp, verbose=False).to_numpy("out")
    assert out_q.max() > 0, "no spikes -> vacuous"
    assert np.corrcoef(out_q.ravel(), out_f.ravel())[0, 1] > 0.99
    out_j = _net("jax", A, etas, "int8_master").run(inp, verbose=False).to_numpy("out")
    np.testing.assert_allclose(out_q, out_j, rtol=1e-9, atol=1e-12)
    net = _net("torch", A, etas, "int8_master")
    traj, wkeys = make_coupled_traj(net.get_node("qif"))
    nargs = net.parameters_pytree()["nodes"]["qif"]
    y0 = net.init_state()["nodes"]["qif"]
    step = net.make_step()
    state, outs_std = {"nodes": {"qif": y0}, "edges": {}}, []
    with torch.no_grad():
        for x in torch.as_tensor(inp).unbind(0):
            state, out, _ = step(state, {"nodes": {"qif": nargs}, "edges": {}}, x)
            outs_std.append(out)
        _, outs_fast = traj({k: nargs[k] for k in wkeys},
                            {k: v for k, v in nargs.items() if k not in wkeys}, y0,
                            torch.as_tensor(inp))
    assert all(nargs[k].dim() == 4 for k in wkeys)
    np.testing.assert_array_equal(outs_fast.numpy(), torch.stack(outs_std).numpy())
    l_fast, w_fast, info = _fit("torch", A, etas, inp, tgt, True, 8, "int8_master")
    assert info["trajectory"] == "chain"
    l_std, w_std, _ = _fit("torch", A, etas, inp, tgt, False, 8, "int8_master")
    assert w_fast.ndim == 4
    np.testing.assert_allclose(l_fast, l_std, rtol=1e-7)
    np.testing.assert_allclose(w_fast, w_std, rtol=0.0, atol=1e-4 * np.abs(w_std).max())
    assert l_fast[-1] < l_fast[0], "block int8_master training did not reduce loss"
    l_jax, w_jax, _ = _fit("jax", A, etas, inp, tgt, True, 8, "int8_master")
    np.testing.assert_allclose(l_fast, l_jax, rtol=1e-7)
    np.testing.assert_allclose(w_fast, w_jax, rtol=0.0, atol=1e-4 * np.abs(w_jax).max())


@pytest.mark.parametrize("coupling", [None, "bfloat16_master"])
def test_batch_blocksparse_deferred_matches_plain(coupling):
    # test_bptt_batch.py:164 -- fit_bptt_batch through the chain trajectory
    # with (T, B, n) block contractions against plain autograd, each against
    # the same path of the JAX package; identical trials reproduce the
    # single-trial fit.  Weights are held on their scale (atol 1e-8 of the
    # largest, as test_bptt_fast.py holds block weights): adam's 1/sqrt(v)
    # lifts float32 reordering noise where a gradient is tiny.  With
    # bfloat16_master blocks plain autodiff rounds each step's block
    # gradient to bfloat16 in both packages (the cotangent of the cast
    # operand), the chain trajectory once over all steps, so there each
    # path is held to its JAX counterpart only.
    rng = np.random.default_rng(11)
    n, bs = 64, 16
    A = block_random_connectivity(n, n, 8, block_size=bs, seed=3)
    etas = 20.0 + np.random.default_rng(11).random(n)
    B, T = 3, 120
    ins = rng.normal(size=(B, T, n)) * 2.0 + 5.0
    tgts = rng.normal(size=(B, T, n)) * 0.1

    def fit(pkg, fused, x=ins, y=tgts, epochs=4):
        net = _net(pkg, A, etas, coupling)
        obs = net.fit_bptt_batch(x, y, n_epochs=epochs, optimizer="adam", lr=5e-3,
                                 verbose=False, fused_bptt=fused)
        return (np.asarray(obs["epoch_loss"]), np.asarray(net.get_node("qif")["weights"]),
                getattr(net, "last_fit", None))

    la, wa, info = fit("torch", True)
    assert info["trajectory"] == "chain"
    assert la[-1] < la[0], "batched sparse training did not reduce the loss"
    assert np.abs(wa - A.blocks).max() > 1e-8, "weights did not train"
    lb, wb, info = fit("torch", False)
    assert info["trajectory"] == "autograd"
    lj, wj, _ = fit("jax", True)
    ljp, wjp, _ = fit("jax", False)
    pairs = [(la, wa, lj, wj), (lb, wb, ljp, wjp)]
    if coupling is None:
        pairs.append((la, wa, lb, wb))
    # the chain's bfloat16 dW sums its exact products in float32 in another
    # order than XLA: 1e-7 of the weight scale there
    scale = 1e-8 if coupling is None else 1e-7
    for l1, w1, l2, w2 in pairs:
        np.testing.assert_allclose(l1, l2, rtol=1e-9)
        np.testing.assert_allclose(w1, w2, rtol=0.0, atol=scale * np.abs(w2).max())
    if coupling is None:
        lc = fit("torch", "auto", np.repeat(ins[:1], 2, 0), np.repeat(tgts[:1], 2, 0), 3)[0]
        ld = fit("torch", "auto", ins[:1], tgts[:1], 3)[0]
        np.testing.assert_allclose(lc, ld, rtol=1e-12)
