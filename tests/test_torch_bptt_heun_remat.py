"""The population trajectory's Heun and chunked (``remat_steps``) forms and
its spiking node classes (``SpikeNet``, ``MultiSpikeResetNet``), against the
JAX package's ``make_coupled_traj`` and against the port's plain autograd
through ``make_step``.

Mirrors ``tests/test_bptt_fast.py``: ``test_traj_forward_and_grad_parity``
(the ``spike_intrinsic`` and ``multi`` kinds), ``:400-483`` (Heun) and
``:690-760`` (remat).  float64, the same seeded numpy inputs through both
packages, the reference tests' tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.ops.bptt import make_coupled_traj as j_make_traj
from rectipy_tpu_torch import Network
from rectipy_tpu_torch.ops.bptt import make_coupled_traj

PREFIX = {"jax": "neuron_model_templates.", "torch": "rectipy_tpu_torch.models."}
TANH = "rate_neurons.leaky_integrator.tanh"
QIF = "spiking_neurons.qif.qif"
QIF_RESET = "spiking_neurons.qif.qif_reset"
IK = "spiking_neurons.ik.ik"


def _build(pkg, kind, n, seed):
    rng = np.random.default_rng(seed)
    net = (JNetwork(1e-2, dtype=jnp.float64) if pkg == "jax"
           else Network(1e-2, dtype=torch.float64, device="cpu"))
    p = PREFIX[pkg]
    if kind in ("rate", "heun"):
        net.add_diffeq_node("rnn", p + TANH, weights=rng.normal(size=(n, n)) * 0.3,
                            input_var="li_op/I_ext", output_var="li_op/v",
                            source_var="tanh_op/r", target_var="li_op/r_in",
                            train_params=["weights"],
                            integrator="heun" if kind == "heun" else "euler")
    elif kind == "spike_reset":
        net.add_diffeq_node("rnn", p + QIF, weights=np.abs(rng.normal(size=(n, n))) * 0.5,
                            input_var="I_ext", output_var="s", source_var="s", target_var="s_in",
                            op="qif_op", spike_var="spike", spike_def="v", spike_threshold=100.0,
                            spike_reset=-100.0, node_vars={"all/qif_op/eta": 2.0 + rng.random(n)},
                            train_params=["weights"])
    elif kind == "spike_intrinsic":  # SpikeNet: the reset is in the equations
        net.add_diffeq_node("rnn", p + QIF_RESET, weights=np.abs(rng.normal(size=(n, n))) * 0.2,
                            input_var="I_ext", output_var="s", source_var="s", target_var="s_in",
                            op="qif_reset_op", spike_var="spike", reset_var="reset", reset=False,
                            spike_threshold=100.0, spike_reset=-100.0,
                            node_vars={"all/qif_reset_op/eta": 2.0 + rng.random(n)},
                            train_params=["weights"])
    elif kind == "multi":  # MultiSpikeResetNet: a list of reset segments
        net.add_diffeq_node("rnn", p + IK, weights=np.abs(rng.normal(size=(n, n))) * 0.05,
                            input_var="I_ext", output_var="s", source_var="s", target_var="s_in",
                            op="ik_op", spike_var=["spike"], reset_var=["v"],
                            spike_threshold=40.0, spike_reset=-60.0,
                            node_vars={"all/ik_op/eta": 3000.0 + 100.0 * rng.random(n)},
                            train_params=["weights"])
    net.compile()
    return net


# steps per kind: the spiking kinds need their first spikes in the window
T_OF = {"rate": 150, "heun": 200, "spike_reset": 300, "spike_intrinsic": 150, "multi": 700}


def _jax_traj(jnet, xs, tgt, remat=0):
    traj, wkeys = j_make_traj(jnet.get_node("rnn"), remat_steps=remat)
    args = jnet.parameters_pytree()["nodes"]["rnn"]
    W = {k: args[k] for k in wkeys}
    rest = {k: v for k, v in args.items() if k not in wkeys}
    y0 = jnet.init_state()["nodes"]["rnn"]

    def loss(W, y0, xs):
        return jnp.mean((traj(W, rest, y0, xs)[1] - tgt) ** 2)

    yT, outs = traj(W, rest, y0, jnp.asarray(xs))
    g = jax.grad(loss, argnums=(0, 1, 2))(W, y0, jnp.asarray(xs))
    return np.asarray(outs), np.asarray(yT), g, wkeys


def _port_traj(tnet, xs, tgt, remat=0, plain=False):
    """Outputs, final state and the gradients ``(W..., y0, xs)`` of the
    port's trajectory, or of plain autograd through ``make_step``."""
    args = tnet.parameters_pytree()["nodes"]["rnn"]
    traj, wkeys = make_coupled_traj(tnet.get_node("rnn"), remat_steps=remat)
    W = {k: args[k].detach().clone().requires_grad_(True) for k in wkeys}
    rest = {k: v for k, v in args.items() if k not in wkeys}
    y0 = tnet.init_state()["nodes"]["rnn"].detach().clone().requires_grad_(True)
    x = torch.as_tensor(xs).requires_grad_(True)
    if plain:
        step, outs = tnet.make_step(), []
        state = {"nodes": {"rnn": y0}, "edges": {}}
        for x_t in x.unbind(0):
            state, out, _ = step(state, {"nodes": {"rnn": {**rest, **W}}, "edges": {}}, x_t)
            outs.append(out)
        yT, outs = state["nodes"]["rnn"], torch.stack(outs)
    else:
        yT, outs = traj(W, rest, y0, x)
    g = torch.autograd.grad(((outs - torch.as_tensor(tgt)) ** 2).mean(), [*W.values(), y0, x])
    return outs.detach().numpy(), yT.detach().numpy(), [t.numpy() for t in g], wkeys


@pytest.mark.parametrize("kind", ["heun", "spike_intrinsic", "multi"])
def test_traj_matches_jax_and_plain_autograd(kind):
    """The Heun trajectory (two stage deltas per coupling into dW),
    ``SpikeNet`` (surrogate and detached spikes in the equations,
    post-update output) and ``MultiSpikeResetNet`` (hard reset of each
    segment, post-update output): the forward equals the composed step bit
    for bit and JAX's to float64 round-off; the gradients equal plain
    autograd's and JAX's (test_bptt_fast.py:56 and :400)."""
    n, T = 10, T_OF[kind]
    jnet, tnet = _build("jax", kind, n, 12), _build("torch", kind, n, 12)
    rng = np.random.default_rng(13)
    xs, tgt = rng.normal(size=(T, n)), rng.normal(size=(T, n))
    j_outs, j_yT, jg, wkeys = _jax_traj(jnet, xs, tgt)
    outs, yT, g, twkeys = _port_traj(tnet, xs, tgt)
    p_outs, p_yT, pg, _ = _port_traj(tnet, xs, tgt, plain=True)
    assert twkeys == wkeys
    if kind != "heun":
        assert np.abs(outs).max() > 0, "no spikes in the window: vacuous"
    np.testing.assert_array_equal(outs, p_outs)
    np.testing.assert_array_equal(yT, p_yT)
    np.testing.assert_allclose(outs, j_outs, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(yT, j_yT, rtol=1e-12, atol=1e-12)
    for i, wk in enumerate(wkeys):
        ref = np.asarray(jg[0][wk])
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(g[i], ref, atol=1e-6 * np.abs(ref).max())
        np.testing.assert_allclose(g[i], pg[i], atol=1e-6 * np.abs(ref).max())
    for i, ref in ((-2, jg[1]), (-1, jg[2])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g[i], ref, rtol=1e-9, atol=1e-12 * max(np.abs(ref).max(), 1.0))
        np.testing.assert_allclose(g[i], pg[i], rtol=1e-9,
                                   atol=1e-12 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("kind", ["rate", "spike_reset", "spike_intrinsic"])
def test_chunked_traj_matches_full_and_jax(kind):
    """``make_coupled_traj(remat_steps=K)``: the forward equals the full
    trajectory's bit for bit, the gradients equal the full one's (float64,
    association only) and JAX's chunked trajectory's
    (test_bptt_fast.py:720)."""
    n = 10
    T, K = {"rate": (120, 30), "spike_reset": (300, 50), "spike_intrinsic": (150, 30)}[kind]
    jnet, tnet = _build("jax", kind, n, 12), _build("torch", kind, n, 12)
    rng = np.random.default_rng(13)
    xs, tgt = rng.normal(size=(T, n)), rng.normal(size=(T, n))
    full = _port_traj(tnet, xs, tgt)
    ck = _port_traj(tnet, xs, tgt, remat=K)
    j_outs, _, jg, wkeys = _jax_traj(jnet, xs, tgt, remat=K)
    np.testing.assert_array_equal(ck[0], full[0])
    np.testing.assert_array_equal(ck[1], full[1])
    np.testing.assert_allclose(ck[0], j_outs, rtol=1e-12, atol=1e-12)
    for i, wk in enumerate(wkeys):
        ref = np.asarray(jg[0][wk])
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(ck[2][i], full[2][i], atol=1e-9 * max(np.abs(ref).max(), 1.0))
        np.testing.assert_allclose(ck[2][i], ref, atol=1e-6 * np.abs(ref).max())
    for i in (-2, -1):
        np.testing.assert_allclose(ck[2][i], full[2][i], rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(ck[2][i], np.asarray(jg[i]), rtol=1e-9, atol=1e-13)


def _fit(pkg, kind, epochs, **kw):
    net = _build(pkg, kind, 8, 19)
    rng = np.random.default_rng(19)
    inp, tgt = rng.normal(size=(120, 8)), rng.normal(size=(120, 8)) * 0.2
    obs = net.fit_bptt([inp] * epochs, [tgt] * epochs, optimizer="adam", lr=1e-2, verbose=False,
                       **kw)
    return np.asarray(obs["epoch_loss"]), np.asarray(net.get_node("rnn")["weights"]), net


@pytest.mark.parametrize("kind,kw,trajectory", [
    ("heun", dict(fused_bptt=True), "chain"),
    ("rate", dict(remat_steps=30), "chain"),
    ("rate", dict(remat_steps=30, fused_bptt=False), "autograd"),
    ("rate", dict(remat_steps=50), "autograd"),
    ("heun", dict(remat_steps=30), "graph"),
])
def test_fit_bptt_heun_and_remat_match_plain_and_jax(kind, kw, trajectory):
    """fit_bptt through the Heun trajectory, the chunked trajectory
    (``remat_steps`` dividing T), plain autograd with checkpointed segments
    (``fused_bptt=False``), plain autograd for a ``remat_steps`` that does
    not divide T (120 % 50), and a Heun node with ``remat_steps`` (the
    population trajectory refuses, the graph trajectory takes it, as in the
    JAX package): the losses and weights of the unchunked plain fit and of
    the JAX package's fit with the same options (test_bptt_fast.py:459 and
    :690)."""
    l_f, w_f, net = _fit("torch", kind, 4, **kw)
    assert net.last_fit["trajectory"] == trajectory
    l_p, w_p, _ = _fit("torch", kind, 4, fused_bptt=False)
    l_j, w_j, _ = _fit("jax", kind, 4, **kw)
    np.testing.assert_allclose(l_f, l_p, rtol=1e-8)
    np.testing.assert_allclose(w_f, w_p, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(l_f, l_j, rtol=1e-8)
    np.testing.assert_allclose(w_f, w_j, rtol=1e-6, atol=1e-10)
    assert l_f[-1] < l_f[0]


def test_remat_memory_keeps_chunk_starts_only():
    """The chunked trajectory saves the carry at each chunk's start, not a
    record per step: its saved residuals are ``T / K`` states."""
    tnet = _build("torch", "rate", 8, 3)
    args = tnet.parameters_pytree()["nodes"]["rnn"]
    traj, wkeys = make_coupled_traj(tnet.get_node("rnn"), remat_steps=20)
    W = {k: args[k].detach().clone().requires_grad_(True) for k in wkeys}
    rest = {k: v for k, v in args.items() if k not in wkeys}
    xs = torch.as_tensor(np.random.default_rng(0).normal(size=(100, 8)))
    _, outs = traj(W, rest, tnet.init_state()["nodes"]["rnn"], xs)
    starts = outs.grad_fn.res
    assert isinstance(starts, list) and len(starts) == 5
    with pytest.raises(ValueError, match="must divide"):
        traj(W, rest, tnet.init_state()["nodes"]["rnn"], xs[:90])
