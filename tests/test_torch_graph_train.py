"""The trainers on the port's graph trajectory (``ops/graph_bptt.py``)
against plain autograd and the JAX package's fits: ``fit_bptt`` in epoch
mode (two populations, feedback, Heun, a long-delay memory filter, a block
feedback edge), the N=100,352 block topology at N=128 (float64 and
``int8_master``), ``remat_steps``, truncated BPTT and ``fit_bptt_batch``.
Mirrors ``tests/test_graph_bptt.py``: float64 (float32 where the JAX test
is), the same seeded numpy inputs through both packages, losses rtol 1e-8,
weights rtol 1e-5 to 1e-6 (``test_graph_bptt.py:107-138``)."""

import numpy as np
import pytest
import torch

from _torch_graph_cases import _block_grad, _block_qif, _drive, _fit, _trained, build


@pytest.mark.parametrize("topo", ["two_pop", "feedback", "heun", "memory_filter",
                                  "block_fb_delay"])
def test_fit_bptt_graph_matches_plain_and_jax(topo):
    """fit_bptt picks the graph trajectory (``last_fit``) and matches plain
    autograd and the JAX package's fit: losses and every trained leaf."""
    tnet, l_g = _fit("torch", topo, True)
    assert tnet.last_fit["trajectory"] == "graph"
    pnet, l_p = _fit("torch", topo, False)
    assert pnet.last_fit["trajectory"] == "autograd"
    jnet, l_j = _fit("jax", topo, True)
    np.testing.assert_allclose(l_g, l_p, rtol=1e-8)
    np.testing.assert_allclose(l_g, l_j, rtol=1e-8)
    w_g, w_p = _trained(tnet, topo), _trained(pnet, topo)
    for path, a in w_g.items():
        jkind, jlabel, jkey = path
        jholder = (jnet.get_node(jlabel)._args if jkind == "nodes"
                   else jnet.get_edge(*jlabel.split("->")).params)
        np.testing.assert_allclose(a, w_p[path], rtol=1e-5, atol=1e-9, err_msg=str(path))
        np.testing.assert_allclose(a, np.asarray(jholder[jkey]), rtol=1e-5, atol=1e-9,
                                   err_msg=str(path))
    assert l_g[-1] < l_g[0]


@pytest.mark.parametrize("bdtype", [None, "int8_master"])
def test_block_edge_coupling_free_population_trains_like_plain_and_jax(bdtype):
    """The N=100,352 topology at N=128 (test_graph_bptt.py:1030 and :1087):
    a delayed block-sparse feedback self-edge, float64 and ``int8_master``
    (float32, as the JAX test), trained from a teacher's output with the
    student's blocks scaled by 1.5: the graph trajectory, plain autograd and
    the JAX package's fit agree."""
    dtype = "float32" if bdtype else "float64"
    ins = np.zeros((500, 1), dtype=dtype)
    ins[125:, 0] = 3.0
    tgt = np.asarray(_block_qif("torch", bdtype, dtype).run(ins, verbose=False).to_numpy("out"))
    assert np.abs(tgt).max() > 0, "the teacher must spike"
    res = {}
    for pkg, fused in (("torch", "auto"), ("torch", False), ("jax", "auto")):
        net = _block_qif(pkg, bdtype, dtype)
        e = net.get_edge("qif", "qif")
        e.weights = e.weights * 1.5
        obs = net.fit_bptt([ins] * 2, [tgt] * 2, optimizer="adam", lr=1e-4, verbose=False,
                           fused_bptt=fused)
        if pkg == "torch":
            assert net.last_fit["trajectory"] == ("graph" if fused else "autograd")
        w = net.get_edge("qif", "qif").weights
        res[(pkg, fused)] = (np.asarray(obs["epoch_loss"], dtype=float),
                             np.asarray(w.detach().cpu() if isinstance(w, torch.Tensor) else w))
    (lg, wg), (lp, wp), (lj, wj) = res.values()
    rtol, wtol = (1e-5, 1e-4) if bdtype else (1e-8, 1e-8)
    assert lg[0] > 0
    np.testing.assert_allclose(lg, lp, rtol=rtol)
    np.testing.assert_allclose(lg, lj, rtol=rtol)
    np.testing.assert_allclose(wg, wp, rtol=wtol, atol=1e-8)
    if bdtype is None:
        np.testing.assert_allclose(wg, wj, rtol=wtol, atol=1e-8)
    else:
        # float32: on the rows whose true gradient is zero (JAX at float64
        # gives at most 6.7e-18 there), PyTorch gives exact zeros and XLA's
        # float32 round-off gives 1e-10 to 3.6e-8, which adam's
        # normalization turns into steps of lr size; so against JAX, the
        # first epoch's block gradient (the trajectories' own output), held
        # on its scale
        g = {}
        for pkg in ("torch", "jax"):
            net = _block_qif(pkg, bdtype, dtype)
            e = net.get_edge("qif", "qif")
            e.weights = e.weights * 1.5
            g[pkg] = _block_grad(pkg, net, ins, tgt)
        np.testing.assert_allclose(g["torch"], g["jax"], atol=1e-4 * np.abs(g["jax"]).max())
    w0 = _block_qif("torch", bdtype, dtype).get_edge("qif", "qif").weights.numpy() * 1.5
    assert np.abs(wg - w0).max() > 0, "the blocks did not train"


def test_fit_bptt_graph_remat_matches_full():
    """fit_bptt(remat_steps=) on a multi-population network takes the
    chunked graph trajectory and matches the full one; plain autograd with
    the same request checkpoints segments and matches too
    (test_graph_bptt.py:680)."""
    _, l_f = _fit("torch", "fb_delay", True)
    net_c, l_c = _fit("torch", "fb_delay", True, remat_steps=20)
    assert net_c.last_fit["trajectory"] == "graph"
    net_p, l_p = _fit("torch", "fb_delay", False, remat_steps=20)
    assert net_p.last_fit["trajectory"] == "autograd"
    np.testing.assert_allclose(l_c, l_f, rtol=1e-8)
    np.testing.assert_allclose(l_p, l_f, rtol=1e-8)
    w_c, w_f = _trained(net_c, "fb_delay"), _trained(_fit("torch", "fb_delay", True)[0], "")
    for path in w_f:
        np.testing.assert_allclose(w_c[path], w_f[path], rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("topo", ["fb_delay", "block_fb_delay", "diag_masked"])
def test_tbptt_step_mode_graph_matches_plain_and_jax(topo):
    """Step mode (truncated BPTT) through the graph trajectory: the carried
    feedback values and edge states cross the chunks (chunks shorter than
    the block delay span exercise the rolled buffer's pack and unpack);
    records, losses and trained weights match plain autograd and the JAX
    package (test_graph_bptt.py:459 and :894)."""
    u = 5 if topo == "block_fb_delay" else 20
    res = {}
    for pkg, fused in (("torch", True), ("torch", False), ("jax", True)):
        net, T, n_in = build(pkg, topo)
        xs, _ = _drive(topo, T, n_in)
        tgt = np.random.default_rng(4).normal(size=(T, net.n_out)) * 0.1
        obs = net.fit_bptt(xs, tgt, optimizer="adam", lr=1e-2, update_steps=u, sampling_steps=4,
                           verbose=False, fused_bptt=fused)
        if pkg == "torch":
            assert net.last_fit["trajectory"] == ("graph" if fused else "autograd")
        res[(pkg, fused)] = (obs.to_numpy("out"), np.asarray(obs["loss"], dtype=float),
                             _trained(net, topo))
    (og, lg, wg), (op, lp, wp), (oj, lj, _) = res.values()
    np.testing.assert_allclose(og, op, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(og, oj, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(lg, lp, rtol=1e-7)
    np.testing.assert_allclose(lg, lj, rtol=1e-7)
    for path in wg:
        np.testing.assert_allclose(wg[path], wp[path], rtol=1e-6, atol=1e-10, err_msg=str(path))


@pytest.mark.parametrize("topo", ["feedback", "feedback_swept", "block_fb_delay"])
def test_fit_bptt_batch_graph_matches_plain_and_jax(topo):
    """``fit_bptt_batch`` of a feedback network at B = 4 through the graph
    trajectory with ``(B, ...)`` carries (``feedback_swept``: each trial
    with its own frozen p1 -> p2 weights, ``batch_vars``): the losses and
    trained weights of plain autograd over the batched step and of the JAX
    package's batch fit (its vmapped graph trajectory)."""
    B = 4
    rng = np.random.default_rng(41)
    res = {}
    swept = topo == "feedback_swept"
    topo = "feedback" if swept else topo
    for pkg, fused in (("torch", True), ("torch", False), ("jax", "auto")):
        net, T, n_in = build(pkg, topo)
        ins = rng.normal(size=(B, T, n_in)) if not res else res["ins"]
        tgts = rng.normal(size=(B, T, net.n_out)) * 0.1 if "tgts" not in res else res["tgts"]
        res.setdefault("ins", ins)
        res.setdefault("tgts", tgts)
        kw = {}
        if swept:
            w = res.setdefault("w", np.eye(n_in) + rng.normal(size=(B, n_in, n_in)) * 0.1)
            kw["batch_vars"] = {("edge", "p1", "p2", "weights"): w}
        obs = net.fit_bptt_batch(ins, tgts, n_epochs=2, batch_size=2, optimizer="adam",
                                 lr=1e-2, seed=3, verbose=False, fused_bptt=fused, **kw)
        if pkg == "torch":
            assert net.last_fit["trajectory"] == ("graph" if fused else "autograd")
        res[(pkg, fused)] = (np.asarray(obs["train_loss"], dtype=float), _trained(net, topo))
    (lg, wg), (lp, wp), (lj, wj) = res[("torch", True)], res[("torch", False)], \
        res[("jax", "auto")]
    np.testing.assert_allclose(lg, lp, rtol=1e-8)
    np.testing.assert_allclose(lg, lj, rtol=1e-8)
    for path in wg:
        np.testing.assert_allclose(wg[path], wp[path], rtol=1e-6, atol=1e-10, err_msg=str(path))
        np.testing.assert_allclose(wg[path], wj[path], rtol=1e-5, atol=1e-9, err_msg=str(path))

