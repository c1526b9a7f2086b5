"""The port's graph trajectory (``ops/graph_bptt.py``) against the JAX
package's ``make_graph_traj`` and against the port's own plain autograd
through ``make_step``; and the trajectory ``fused_bptt='auto'`` picks.

The cases of ``tests/test_graph_bptt.py``: every edge type (``Linear``,
1-D gains, ``LinearMasked`` with a fixed or trained mask, ``LinearMemory``,
``LinearFilter``, ``LinearMemoryFilter`` at a long delay,
``BlockSparseLinear`` with and without per-block delays), feedback edges,
Heun populations, populations without a coupling, ``remat_steps``, the
block edge's state round trip and ``fused_bptt='auto'`` across
topologies (the trainers: ``test_torch_graph_train.py``).  float64, the
same seeded numpy inputs through both packages, the reference tests'
tolerances (``test_graph_bptt.py:107-138``)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_graph_cases import TRAJ_TOPOS, _drive, _float_leaves, _nest, _new, _tanh, build
from rectipy_tpu.network import _graph_weights_args as j_weights_args
from rectipy_tpu.ops.graph_bptt import make_graph_traj as j_make_graph_traj
from rectipy_tpu_torch.ops.graph_bptt import graph_weights_args, make_graph_traj


@pytest.mark.parametrize("topo", TRAJ_TOPOS)
def test_graph_traj_matches_jax_and_plain_autograd(topo):
    """Forward records and every gradient (deferred weights, the drive,
    every float argument: masks, trained etas) of the port's graph
    trajectory against JAX's and against the port's plain autograd."""
    jnet, T, n_in = build("jax", topo)
    tnet, _, _ = build("torch", topo)
    xs, tgt = _drive(topo, T, n_in)
    jtraj, jspec = j_make_graph_traj(jnet)
    traj, spec = make_graph_traj(tnet)
    assert [w for w in spec.weight_paths] == [tuple(w) for w in jspec.weight_paths]
    assert spec.pop_labels == jspec.pop_labels and spec.needs_carry == jspec.needs_carry
    assert spec.stateful_edges == jspec.stateful_edges and spec.has_fb == jspec.has_fb

    # the JAX trajectory: outputs and gradients
    jw, ja = j_weights_args(jspec, jnet.parameters_pytree())
    jst = jnet.init_state()
    jC0 = {lbl: jst["nodes"][lbl] for lbl in jspec.pop_labels}
    if jspec.needs_carry:
        jC0 = {"Y": jC0, "fb": jst.get("fb", {}),
               "E": {ek: jspec.estate_pack[ek](jst["edges"][ek]) for ek in jspec.stateful_edges}}
    jfa = _float_leaves(ja, lambda v: jnp.issubdtype(jnp.result_type(v), jnp.floating)
                        and np.ndim(v) > 0)
    out_w = np.asarray(jtraj(jw, ja, jC0, jnp.asarray(xs))[1])
    if tgt is None:
        tgt = np.random.default_rng(3).normal(size=out_w.shape)

    def jloss(w, fa, x):
        return jnp.mean((jtraj(w, _nest(fa, ja), jC0, x)[1] - tgt) ** 2)

    jg_w, jg_a, jg_x = jax.grad(jloss, argnums=(0, 1, 2))(jw, jfa, jnp.asarray(xs))

    # the port's trajectory
    tw, ta = graph_weights_args(spec, tnet.parameters_pytree())
    tw = {k: v.detach().clone().requires_grad_(True) for k, v in tw.items()}
    tfa = {p: v.detach().clone().requires_grad_(True)
           for p, v in _float_leaves(ta, lambda v: isinstance(v, torch.Tensor)
                                     and v.is_floating_point() and v.dim() > 0).items()}
    assert sorted(tfa) == sorted(jfa)
    ta = _nest(tfa, ta)
    x_t = torch.as_tensor(xs).requires_grad_(True)
    C0 = tnet._graph_pack(spec, tnet.init_state())
    _, outs = traj(tw, ta, C0, x_t)
    tgt_t = torch.as_tensor(tgt).to(outs.dtype)
    g = torch.autograd.grad(((outs - tgt_t) ** 2).mean(), [*tw.values(), *tfa.values(), x_t],
                            allow_unused=True)
    g_w, g_a, g_x = g[:len(tw)], g[len(tw):-1], g[-1]

    # the port's plain autograd through make_step, on the same leaves
    params = tnet._combine({"nodes": {}, "edges": {}}, ta)
    for fk, kind, label, key in spec.weight_paths:
        params[kind][label][key] = tw[fk]
    params = tnet._prep_edge_params(params)
    step, state, plain = tnet.make_step(), tnet.init_state(), []
    for x in x_t.unbind(0):
        state, out, _ = step(state, params, x)
        plain.append(out)
    plain = torch.stack(plain)
    p_g = torch.autograd.grad(((plain - tgt_t) ** 2).mean(), [*tw.values(), *tfa.values(), x_t],
                              allow_unused=True)

    np.testing.assert_array_equal(outs.detach().numpy(), plain.detach().numpy())
    np.testing.assert_allclose(outs.detach().numpy(), out_w, rtol=1e-9, atol=1e-12)
    for fk, a, b in zip(tw, g_w, p_g[:len(tw)]):
        ref = np.asarray(jg_w[fk])
        assert np.abs(ref).max() > 0, f"zero gradient for {fk}: vacuous"
        np.testing.assert_allclose(a.numpy(), ref, atol=1e-6 * np.abs(ref).max(), err_msg=fk)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6 * np.abs(ref).max(),
                                   err_msg=fk)
    for p, a, b in zip(tfa, g_a, p_g[len(tw):-1]):
        ref = np.asarray(jg_a[p])
        a = np.zeros_like(ref) if a is None else a.numpy()
        b = np.zeros_like(ref) if b is None else b.numpy()
        scale = max(np.abs(ref).max(), 1e-30)
        np.testing.assert_allclose(a, ref, atol=1e-7 * scale, err_msg=str(p))
        np.testing.assert_allclose(a, b, atol=1e-7 * scale, err_msg=str(p))
    if topo == "trainable_mask":
        assert np.abs(np.asarray(jg_a[("edges", "pop1->pop2", "mask")])).max() > 0
    ref = np.asarray(jg_x)
    np.testing.assert_allclose(g_x.numpy(), ref, rtol=1e-9, atol=1e-12 * max(np.abs(ref).max(), 1))
    np.testing.assert_allclose(g_x.numpy(), p_g[-1].numpy(), rtol=1e-9,
                               atol=1e-12 * max(np.abs(ref).max(), 1))


@pytest.mark.parametrize("topo", ["fb_delay", "block_fb_delay"])
def test_graph_traj_remat_matches_full_and_jax(topo):
    """``remat_steps``: the chunked graph trajectory's forward equals the
    full one bit for bit and its gradients equal the full one's and JAX's
    chunked trajectory's (test_graph_bptt.py:618)."""
    jnet, T, n_in = build("jax", topo)
    tnet, _, _ = build("torch", topo)
    K = {"fb_delay": 20, "block_fb_delay": 8}[topo]
    xs, _ = _drive(topo, T, n_in)
    tgt = np.random.default_rng(9).normal(size=(T, tnet.n_out))
    full, spec = make_graph_traj(tnet)
    ck, _ = make_graph_traj(tnet, remat_steps=K)
    jck, jspec = j_make_graph_traj(jnet, remat_steps=K)
    res = {}
    for name, traj in (("full", full), ("ck", ck)):
        tw, ta = graph_weights_args(spec, tnet.parameters_pytree())
        tw = {k: v.detach().clone().requires_grad_(True) for k, v in tw.items()}
        x_t = torch.as_tensor(xs).requires_grad_(True)
        _, outs = traj(tw, ta, tnet._graph_pack(spec, tnet.init_state()), x_t)
        g = torch.autograd.grad(((outs - torch.as_tensor(tgt)) ** 2).mean(), [*tw.values(), x_t])
        res[name] = (outs.detach().numpy(), [t.numpy() for t in g])
    np.testing.assert_array_equal(res["ck"][0], res["full"][0])
    jw, ja = j_weights_args(jspec, jnet.parameters_pytree())
    jst = jnet.init_state()
    jC0 = {"Y": {lbl: jst["nodes"][lbl] for lbl in jspec.pop_labels}, "fb": jst["fb"],
           "E": {ek: jspec.estate_pack[ek](jst["edges"][ek]) for ek in jspec.stateful_edges}}
    jg = jax.grad(lambda w, x: jnp.mean((jck(w, ja, jC0, x)[1] - tgt) ** 2),
                  argnums=(0, 1))(jw, jnp.asarray(xs))
    for fk, a, b in zip(jw, res["ck"][1], res["full"][1]):
        ref = np.asarray(jg[0][fk])
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(a, b, atol=1e-9 * max(np.abs(b).max(), 1.0), err_msg=fk)
        np.testing.assert_allclose(a, ref, atol=1e-6 * np.abs(ref).max(), err_msg=fk)
    np.testing.assert_allclose(res["ck"][1][-1], res["full"][1][-1], rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(res["ck"][1][-1], np.asarray(jg[1]), rtol=1e-9, atol=1e-13)

def test_graph_traj_block_edge_state_roundtrip():
    """The rolled block-delay buffer converts exactly to and from the edge's
    circular ``(hist, t)``: after a trajectory, the unpacked state equals
    the composed run's edge state, slot for slot, for a run shorter and one
    longer than the buffer (test_graph_bptt.py:971)."""
    for T in (3, 40):
        net, _, _ = build("torch", "block_fb_delay")
        traj, spec = make_graph_traj(net)
        ek = spec.stateful_edges[0]
        weights, args = graph_weights_args(spec, net.parameters_pytree())
        inp = np.random.default_rng(T).normal(size=(T, 8))
        state0 = net.init_state()
        with torch.no_grad():
            CT, outs = traj(weights, args, net._graph_pack(spec, state0), torch.as_tensor(inp))
        hist_t, t_t = spec.estate_unpack[ek](CT["E"][ek], state0["edges"][ek], T)
        net_b, _, _ = build("torch", "block_fb_delay")
        full = net_b.run(inp, verbose=False).to_numpy("out")
        hist_r, t_r = net_b.get_edge("pop", "pop").init_state()
        np.testing.assert_array_equal(outs.numpy(), full)
        np.testing.assert_array_equal(hist_t.numpy(), hist_r.numpy())
        assert int(t_t) == int(t_r) == T

TOPOLOGIES = ["single", "chain", "fb_self", "fb_self_delay", "fb_self_matrix", "dag_fb",
              "chain_delay", "stp"]


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_fused_auto_matches_plain_across_topologies(topology):
    """Whatever ``fused_bptt='auto'`` picks for a topology (the chain
    trajectory, the graph trajectory, or plain autograd), the losses and
    trained weights equal plain autograd's (test_graph_bptt.py:783); and
    ``last_fit`` names the pick the JAX package makes."""
    seed = zlib.crc32(topology.encode())
    n, T = 5, 60

    def fit(fused):
        rng = np.random.default_rng(seed)
        inp = rng.normal(size=(T, n))
        tgt = rng.normal(size=(T, n)) * 0.1
        net = _new("torch", feedback=True)
        if topology in ("chain", "chain_delay"):
            net.add_func_node("inp", n, activation_function="identity")
        _tanh(net, "torch", "rnn", rng.normal(size=(n, n)) * 0.2)
        fb = dict(feedback=True, train="gd")
        if topology == "chain":
            net.add_edge("inp", "rnn", weights=np.eye(n))
        elif topology == "chain_delay":
            net.add_edge("inp", "rnn", weights=np.eye(n), delays=rng.integers(0, 4, size=n),
                         train="gd")
        elif topology == "fb_self":
            net.add_edge("rnn", "rnn", weights=rng.normal(size=(n, n)) * 0.2, **fb)
        elif topology == "fb_self_delay":
            net.add_edge("rnn", "rnn", weights=rng.normal(size=(n, n)) * 0.2,
                         delays=rng.integers(0, 4, size=n), **fb)
        elif topology == "fb_self_matrix":
            net.add_edge("rnn", "rnn", weights=rng.normal(size=(n, n)) * 0.2,
                         delays=rng.integers(0, 4, size=(n, n)), **fb)
        elif topology == "stp":
            net.add_edge("rnn", "rnn", weights=rng.normal(size=(n, n)) * 0.2, tau_facil=0.05,
                         tau_depress=0.2, **fb)
        elif topology == "dag_fb":
            _tanh(net, "torch", "rnn2", rng.normal(size=(n, n)) * 0.2, train=False)
            net.add_edge("rnn", "rnn2", weights=rng.normal(size=(n, n)) * 0.3, train="gd")
            net.add_edge("rnn2", "rnn", weights=rng.normal(size=(n, n)) * 0.1, feedback=True)
        net.compile()
        obs = net.fit_bptt([inp] * 4, [tgt] * 4, optimizer="adam", lr=1e-2, verbose=False,
                           fused_bptt=fused)
        return (np.asarray(obs["epoch_loss"]), net.get_node("rnn")["weights"].numpy(),
                net.last_fit["trajectory"])

    l_auto, w_auto, kind = fit("auto")
    l_plain, w_plain, _ = fit(False)
    want = {"single": "chain", "chain": "chain", "fb_self_matrix": "autograd",
            "stp": "autograd"}.get(topology, "graph")
    assert kind == want
    np.testing.assert_allclose(l_auto, l_plain, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(w_auto, w_plain, rtol=1e-6, atol=1e-12)
    assert l_auto[-1] < l_auto[0], f"{topology}: loss did not decrease"

def test_graph_bptt_unsupported_falls_back():
    """An edge outside the linear family (an RLS readout) is outside the
    graph trajectory's scope: ``fused_bptt=True`` raises, ``'auto'`` takes
    plain autograd and trains (test_graph_bptt.py:142)."""
    rng = np.random.default_rng(23)
    n = 6

    def build_rls():
        net = _new("torch")
        _tanh(net, "torch", "pop1", rng.normal(size=(n, n)) * 0.2)
        _tanh(net, "torch", "pop2", rng.normal(size=(n, n)) * 0.2, train=False)
        net.add_edge("pop1", "pop2", weights=np.eye(n), train="rls")
        return net

    inp, tgt = rng.normal(size=(40, n)), rng.normal(size=(40, n))
    with pytest.raises(ValueError, match="linear-family"):
        build_rls().fit_bptt([inp], [tgt], verbose=False, fused_bptt=True)
    net = build_rls()
    obs = net.fit_bptt([inp] * 2, [tgt] * 2, verbose=False, fused_bptt="auto")
    assert len(obs["epoch_loss"]) == 2 and net.last_fit["trajectory"] == "autograd"

