"""The port's deferred-gradient trajectory (``ops/bptt.py``) against the JAX
package's and against the port's own plain autograd through ``make_step``.
CPU, float64, inputs from numpy seeds; the cases of
``tests/test_bptt_fast.py`` (``rate``, ``spike_reset``, ``int8_master``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.ops.bptt import make_coupled_traj as j_make_traj
from rectipy_tpu_torch import Network, RateNet
from rectipy_tpu_torch.ops.bptt import make_coupled_traj

TANH = "rate_neurons.leaky_integrator.tanh"
QIF = "spiking_neurons.qif.qif"


def _build(cls, prefix, kind, n, W, etas, **kw):
    net = cls(1e-2, **kw)
    if kind == "spike_reset":
        net.add_diffeq_node("rnn", prefix + QIF, weights=W, input_var="I_ext", output_var="s",
                            source_var="s", target_var="s_in", op="qif_op", spike_var="spike",
                            spike_def="v", spike_threshold=100.0, spike_reset=-100.0,
                            node_vars={"all/qif_op/eta": etas}, train_params=["weights"])
    else:
        net.add_diffeq_node("rnn", prefix + TANH, weights=W, input_var="li_op/I_ext",
                            output_var="li_op/v", source_var="tanh_op/r",
                            target_var="li_op/r_in", train_params=["weights"],
                            coupling_dtype="int8_master" if kind == "int8_master" else None)
    net.compile()
    return net


def _pair(kind, n, rng):
    if kind == "spike_reset":
        W = np.abs(rng.normal(size=(n, n))) * 0.5
    else:
        W = rng.normal(size=(n, n)) * 0.3
    etas = 2.0 + rng.random(n)
    return (_build(JNetwork, "neuron_model_templates.", kind, n, W, etas, dtype=jnp.float64),
            _build(Network, "rectipy_tpu_torch.models.", kind, n, W, etas,
                   dtype=torch.float64, device="cpu"))


# dW tolerances, relative to the gradient's largest entry:
# - port trajectory vs JAX trajectory: both round the (N,T)x(T,N) product to
#   float32 (the JAX package's dot_general(..., preferred_element_type=
#   float32)); float64 sums in another order can move that rounding by an ulp
# - port trajectory vs port plain autograd: test_bptt_fast.py's own bounds
#   (one float32 rounding of dW, 1e-6; int8_master's float32 dW, 2e-5)
CASES = {"rate": (10, 150, 1e-6), "spike_reset": (10, 150, 1e-6), "int8_master": (12, 150, 2e-5)}


@pytest.mark.parametrize("kind", list(CASES))
def test_traj_matches_jax_and_plain_autograd(kind):
    n, T, w_tol = CASES[kind]
    rng = np.random.default_rng(3)
    jnet, tnet = _pair(kind, n, rng)
    xs_np, tgt_np = rng.normal(size=(T, n)), rng.normal(size=(T, n))

    # JAX trajectory: outputs and gradients
    jnode = jnet.get_node("rnn")
    jtraj, wkeys = j_make_traj(jnode)
    jargs = jnet.parameters_pytree()["nodes"]["rnn"]
    jW = {k: jargs[k] for k in wkeys}
    jrest = {k: v for k, v in jargs.items() if k not in wkeys}
    jy0 = jnet.init_state()["nodes"]["rnn"]

    def jloss(W, y0, xs):
        return jnp.mean((jtraj(W, jrest, y0, xs)[1] - tgt_np) ** 2)

    j_outs = np.asarray(jtraj(jW, jrest, jy0, jnp.asarray(xs_np))[1])
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jW, jy0, jnp.asarray(xs_np))

    # port trajectory
    traj, twkeys = make_coupled_traj(tnet.get_node("rnn"))
    assert twkeys == wkeys
    targs = tnet.parameters_pytree()["nodes"]["rnn"]
    rest = {k: v for k, v in targs.items() if k not in wkeys}
    W = {k: targs[k].clone().requires_grad_(True) for k in wkeys}
    y0 = tnet.init_state()["nodes"]["rnn"].clone().requires_grad_(True)
    xs = torch.as_tensor(xs_np).requires_grad_(True)
    tgt = torch.as_tensor(tgt_np)
    yT, outs = traj(W, rest, y0, xs)
    g = torch.autograd.grad(torch.mean((outs - tgt) ** 2), [*W.values(), y0, xs])

    # the port's plain autograd through make_step, from the same leaves
    step = tnet.make_step()
    st = {"nodes": {"rnn": y0}, "edges": {}}
    p = {"nodes": {"rnn": {**rest, **W}}, "edges": {}}
    outs_std = []
    for x in xs.unbind(0):
        st, out, _ = step(st, p, x)
        outs_std.append(out)
    outs_std = torch.stack(outs_std)
    g_std = torch.autograd.grad(torch.mean((outs_std - tgt) ** 2), [*W.values(), y0, xs])

    # forward: bit-identical to the composed step; equal to JAX to rounding
    assert torch.equal(outs.detach(), outs_std.detach())
    assert torch.equal(yT.detach(), st["nodes"]["rnn"].detach())
    np.testing.assert_allclose(outs.detach().numpy(), j_outs, rtol=1e-9, atol=1e-12)
    if kind == "spike_reset":
        assert j_outs.max() > 0, "no spikes -> test is vacuous"
    for i, wk in enumerate(wkeys):
        a, b, c = g[i].numpy(), np.asarray(jg[0][wk]), g_std[i].numpy()
        assert np.abs(b).max() > 0, "zero weight gradient -> test is vacuous"
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-7 * np.abs(b).max())
        np.testing.assert_allclose(a, c, rtol=0, atol=w_tol * np.abs(c).max())
    for a, b, c in ((g[-2], jg[1], g_std[-2]), (g[-1], jg[2], g_std[-1])):
        scale = max(np.abs(np.asarray(b)).max(), 1.0)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12 * scale)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-9, atol=1e-12 * scale)


def test_traj_only_computes_the_cotangents_asked_for():
    # with only the coupling trained, the backward takes no per-step VJP for
    # the other args, y0 or xs, and returns None for them
    rng = np.random.default_rng(4)
    _, tnet = _pair("rate", 6, rng)
    traj, wkeys = make_coupled_traj(tnet.get_node("rnn"))
    args = tnet.parameters_pytree()["nodes"]["rnn"]
    W = {k: args[k].clone().requires_grad_(True) for k in wkeys}
    rest = {k: v.clone().requires_grad_(True) if v.is_floating_point() else v
            for k, v in args.items() if k not in wkeys}
    y0 = tnet.init_state()["nodes"]["rnn"]
    _, outs = traj(W, rest, y0, torch.as_tensor(rng.normal(size=(20, 6))))
    grads = torch.autograd.grad(outs.sum(), [*W.values(), *rest.values()], allow_unused=True)
    assert grads[0] is not None and grads[0].abs().max() > 0
    # eta is trained through the step's VJP: nonzero; the input placeholder
    # is overwritten by the drive: no gradient
    by_key = dict(zip(list(rest), grads[1:]))
    assert by_key["li_op/eta"].abs().max() > 0


def test_traj_refuses_what_it_does_not_support():
    rng = np.random.default_rng(5)
    _, tnet = _pair("rate", 4, rng)
    # remat_steps is ported for Euler; the Heun trajectory refuses it, as in
    # the JAX package (fit_bptt then takes the graph trajectory)
    make_coupled_traj(tnet.get_node("rnn"), remat_steps=4)
    heun = Network(1e-2, dtype=torch.float64, device="cpu")
    heun.add_diffeq_node("rnn", "rectipy_tpu_torch.models." + TANH, weights=np.eye(4),
                         input_var="li_op/I_ext", output_var="li_op/v", source_var="tanh_op/r",
                         target_var="li_op/r_in", integrator="heun")
    with pytest.raises(ValueError, match="Euler-only"):
        make_coupled_traj(heun.get_node("rnn"), remat_steps=4)
    node = RateNet(lambda t, y, a: -y + a["in"], {"weights": torch.zeros(4), "in": torch.zeros(4)},
                   {"out": [0, 4]}, {"in": "in", "weights": "weights"}, dt=1e-2,
                   dtype=torch.float64, y0=torch.zeros(4, dtype=torch.float64), device="cpu")
    with pytest.raises(ValueError, match="DSL-built"):
        make_coupled_traj(node)
