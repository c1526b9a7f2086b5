"""The port's ``BlockSparseSTDP`` edge and ``fit_stdp`` on block weights
against the JAX package (CPU, float64, inputs from numpy seeds; the block
cases of ``tests/test_stdp.py``).  Weights, traces and records within rtol
1e-10 of JAX's (the rule's functions within 1e-12), spike counts exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import BlockSparseCoupling as JBlockSparseCoupling
from rectipy_tpu import BlockSparseSTDP as JBlockSparseSTDP
from rectipy_tpu import FeedbackNetwork as JFeedbackNetwork
from rectipy_tpu.edges import STDP as JSTDP
from rectipy_tpu_torch import (BlockSparseCoupling, BlockSparseSTDP, FeedbackNetwork,
                               block_random_connectivity)
from rectipy_tpu_torch.ops.stdp import stdp_consts, stdp_update_plain

QIF = "rectipy_tpu.models.spiking_neurons.qif.qif"
TIGHT = dict(rtol=1e-10, atol=0.0)


def _numpy_stdp(W, spk_pre, spk_post, dt, tau_plus, tau_minus, a_plus, a_minus, w_min, w_max,
                soft=False):
    """The dense rule on a full matrix (an independent oracle)."""
    W = np.array(W, dtype=np.float64)
    x_pre, x_post = np.zeros(W.shape[1]), np.zeros(W.shape[0])
    for sp, so in zip(spk_pre, spk_post):
        x_pre *= np.exp(-dt / tau_plus)
        x_post *= np.exp(-dt / tau_minus)
        pot, dep = a_plus * np.outer(so, x_pre), a_minus * np.outer(x_post, sp)
        W = W + pot * (w_max - W) - dep * (W - w_min) if soft else W + pot - dep
        W = np.clip(W, w_min, w_max)
        x_pre += sp
        x_post += so
    return W, x_pre, x_post


def _toy(rng, nb=3, cb=2, bs=2, lo=0.2, hi=0.6, repeats=False):
    """A small coupling: distinct source blocks per row (or, ``repeats``,
    columns that may repeat within a row)."""
    cols = (rng.integers(0, nb, size=(nb, cb)) if repeats else
            np.stack([rng.choice(nb, size=cb, replace=False) for _ in range(nb)]))
    return rng.uniform(lo, hi, size=(nb, cb, bs, bs)), cols.astype(np.int32)


def _pair(blocks, cols):
    return BlockSparseCoupling(blocks, cols), JBlockSparseCoupling(blocks, cols)


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("repeats", [False, True])
def test_block_update_fn_follows_the_dense_rule_and_jax(soft, repeats):
    """Every stored entry follows the dense rule for its synapse (a numpy
    oracle on the full matrix; with repeated columns a synapse is stored
    twice and each copy follows it), and the update equals JAX's."""
    rng = np.random.default_rng(21 + repeats)
    nb, cb, bs, T, dt = 3, 2, 2, 80, 0.5
    n = nb * bs
    cfg = dict(tau_plus=6.0, tau_minus=9.0, a_plus=0.05, a_minus=0.04, w_min=0.1, w_max=0.9)
    blocks, cols = _toy(rng, nb, cb, bs, repeats=repeats)
    A, JA = _pair(blocks, cols)
    spk_pre = (rng.random((T, n)) < 0.2).astype(float)
    spk_post = (rng.random((T, n)) < 0.2).astype(float)
    edge = BlockSparseSTDP(n, n, weights=A, soft_bounds=soft, device="cpu", **cfg)
    jedge = JBlockSparseSTDP(n, n, weights=JA, dtype=jnp.float64, soft_bounds=soft, **cfg)
    upd, jupd = edge.update_fn(dt), jedge.update_fn(dt)
    W, xp, xs = edge.params["weights"], edge.x_pre, edge.x_post
    jW, jxp, jxs = jedge.params["weights"], jedge.x_pre, jedge.x_post
    for t in range(T):
        W, xp, xs = upd(W, xp, xs, torch.as_tensor(spk_pre[t]), torch.as_tensor(spk_post[t]))
        jW, jxp, jxs = jupd(jW, jxp, jxs, jnp.asarray(spk_pre[t]), jnp.asarray(spk_post[t]))
    for got, want in zip((W, xp, xs), (jW, jxp, jxs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    W = W.numpy()
    for r in range(nb):
        for c in range(cb):
            dense = np.zeros((n, n))
            dense[r * bs:(r + 1) * bs, cols[r, c] * bs:(cols[r, c] + 1) * bs] = \
                np.clip(blocks[r, c], cfg["w_min"], cfg["w_max"])
            ref = _numpy_stdp(dense, spk_pre, spk_post, dt, soft=soft, **cfg)[0]
            j = int(cols[r, c]) * bs
            np.testing.assert_allclose(W[r, c], ref[r * bs:(r + 1) * bs, j:j + bs],
                                       rtol=1e-12, err_msg=f"block ({r}, {c})")


def test_block_reward_update_matches_the_dense_rule_and_jax():
    rng = np.random.default_rng(22)
    nb, cb, bs, T, dt, tau_e = 2, 2, 3, 60, 0.5, 40.0
    n = nb * bs
    cfg = dict(tau_plus=6.0, tau_minus=9.0, a_plus=0.05, a_minus=0.04, w_min=-0.5, w_max=0.9)
    blocks, cols = _toy(rng, nb, cb, bs)
    A, JA = _pair(blocks, cols)
    spk_pre = (rng.random((T, n)) < 0.2).astype(float)
    spk_post = (rng.random((T, n)) < 0.2).astype(float)
    reward = rng.normal(size=T)
    edge = BlockSparseSTDP(n, n, weights=A, device="cpu", **cfg)
    jedge = JBlockSparseSTDP(n, n, weights=JA, dtype=jnp.float64, **cfg)
    upd, jupd = edge.reward_update_fn(dt, tau_e), jedge.reward_update_fn(dt, tau_e)
    W, xp, xs = edge.params["weights"], edge.x_pre, edge.x_post
    E = torch.zeros_like(W)
    jW, jxp, jxs = jedge.params["weights"], jedge.x_pre, jedge.x_post
    jE = jnp.zeros_like(jW)
    for t in range(T):
        W, E, xp, xs = upd(W, E, xp, xs, torch.as_tensor(spk_pre[t]),
                           torch.as_tensor(spk_post[t]), reward[t])
        jW, jE, jxp, jxs = jupd(jW, jE, jxp, jxs, jnp.asarray(spk_pre[t]),
                                jnp.asarray(spk_post[t]), jnp.asarray(reward[t]))
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), rtol=1e-12)
    np.testing.assert_allclose(E.numpy(), np.asarray(jE), rtol=1e-12)
    # the dense edge stores a square matrix transposed: pass it transposed
    dense = JSTDP(n, n, weights=np.clip(A.to_dense(), cfg["w_min"], cfg["w_max"]).T,
                  dtype=jnp.float64, **cfg)
    dupd = dense.reward_update_fn(dt, tau_e)
    Wd, xpd, xsd = dense.params["weights"], dense.x_pre, dense.x_post
    Ed = jnp.zeros_like(Wd)
    for t in range(T):
        Wd, Ed, xpd, xsd = dupd(Wd, Ed, xpd, xsd, jnp.asarray(spk_pre[t]),
                                jnp.asarray(spk_post[t]), jnp.asarray(reward[t]))
    W, Wd = W.numpy(), np.asarray(Wd)
    for r in range(nb):
        for c in range(cb):
            j = int(cols[r, c]) * bs
            np.testing.assert_allclose(W[r, c], Wd[r * bs:(r + 1) * bs, j:j + bs], rtol=1e-12)


def _block_net(cls, dt, blocks, cols, dense=False, **stdp_kw):
    """A QIF population with a plastic feedback self-edge: block-sparse, or
    its dense equivalent (the same initial synapses)."""
    A = (BlockSparseCoupling if cls is FeedbackNetwork else JBlockSparseCoupling)(blocks, cols)
    n = A.shape[0]
    rng = np.random.default_rng(4)
    net = (cls(dt, dtype=torch.float64, device="cpu") if cls is FeedbackNetwork
           else cls(dt, dtype=jnp.float64))
    net.add_diffeq_node(
        "qif", QIF, weights=np.zeros((n, n)), source_var="s", target_var="s_in",
        input_var="I_ext", output_var="s", spike_var="spike", reset_var="v", op="qif_op",
        spike_threshold=100.0, spike_reset=-100.0,
        node_vars={"all/qif_op/eta": rng.uniform(300.0, 500.0, n)})
    kw = dict(tau_plus=20e-3, tau_minus=20e-3, a_plus=5e-3, a_minus=4e-3, w_min=0.0, w_max=1.0)
    kw.update(stdp_kw)
    net.add_edge("qif", "qif", feedback=True, train="stdp",
                 weights=A.to_dense().T if dense else A, **kw)
    return net


def _weights(net):
    w = net.get_edge("qif", "qif").params["weights"]
    return w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def test_block_full_coverage_equals_dense_end_to_end_and_jax():
    """With every source block present the block edge stores the full matrix:
    the whole fit (projection, spikes, plasticity, homeostasis) equals the
    dense edge's, and JAX's block fit."""
    rng = np.random.default_rng(31)
    nb, bs, T, dt = 2, 3, 400, 1e-3
    n = nb * bs
    cols = np.stack([np.arange(nb, dtype=np.int32)] * nb)
    blocks = rng.uniform(0.1, 0.5, size=(nb, nb, bs, bs))
    x = (rng.random((T, n)) < 0.1) * 30.0
    for homeo in (None, 100):
        kw = {"homeostasis_steps": homeo} if homeo else {}
        blk = _block_net(FeedbackNetwork, dt, blocks, cols)
        dns = _block_net(FeedbackNetwork, dt, blocks, cols, dense=True)
        jblk = _block_net(JFeedbackNetwork, dt, blocks, cols)
        assert isinstance(blk.get_edge("qif", "qif"), BlockSparseSTDP)
        obs = [net.fit_stdp(x, sampling_steps=100, verbose=False, record_spikes=["qif"], **kw)
               for net in (blk, dns, jblk)]
        Wb, Wd = _weights(blk), _weights(dns)
        for r in range(nb):
            for c in range(nb):
                np.testing.assert_allclose(Wb[r, c], Wd[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs],
                                           **TIGHT)
        np.testing.assert_allclose(Wb, _weights(jblk), **TIGHT)
        for o in obs[1:]:
            np.testing.assert_allclose(obs[0].to_numpy("out"), o.to_numpy("out"), **TIGHT)
            np.testing.assert_allclose(np.asarray(obs[0]["w_mean"]), np.asarray(o["w_mean"]),
                                       **TIGHT)
            np.testing.assert_array_equal(obs[0].to_numpy(("qif", "spikes")),
                                          o.to_numpy(("qif", "spikes")))
        assert obs[0].to_numpy(("qif", "spikes")).sum() > 0


@pytest.mark.parametrize("chunks", [(90, 150), (128, 112)])
def test_block_chunked_with_homeostasis_equals_one_call_and_jax(chunks):
    """Chunked block fits (aligned to the period or not): W, traces, the
    scaling target and phase persist."""
    rng = np.random.default_rng(32)
    T, dt, h = sum(chunks), 1e-3, 64
    blocks, cols = _toy(rng, nb=3, cb=2, bs=2)
    x = (rng.random((T, 6)) < 0.12) * 30.0
    one = _block_net(FeedbackNetwork, dt, blocks, cols)
    one.fit_stdp(x, sampling_steps=40, homeostasis_steps=h, verbose=False)
    tnet, jnet = (_block_net(cls, dt, blocks, cols) for cls in (FeedbackNetwork,
                                                                 JFeedbackNetwork))
    t0 = 0
    for n in chunks:
        for net in (tnet, jnet):
            net.fit_stdp(x[t0:t0 + n], sampling_steps=40, homeostasis_steps=h, verbose=False)
        t0 += n
    for key in ("weights", "x_pre", "x_post"):
        got = tnet.get_edge("qif", "qif").params[key].numpy()
        np.testing.assert_allclose(got, one.get_edge("qif", "qif").params[key].numpy(),
                                   rtol=1e-12, err_msg=key)
        np.testing.assert_allclose(got, np.asarray(jnet.get_edge("qif", "qif").params[key]),
                                   err_msg=key, **TIGHT)


def test_block_homeostasis_pins_block_row_mass_and_matches_jax():
    """After an aligned scaling step every post-synaptic neuron's
    above-floor block-row mass (axes 1 and 3) is its initial mass."""
    rng = np.random.default_rng(33)
    T, dt, h = 200, 1e-3, 200
    blocks, cols = _toy(rng, nb=3, cb=2, bs=2)
    x = (rng.random((T, 6)) < 0.15) * 30.0
    tnet, jnet = (_block_net(cls, dt, blocks, cols) for cls in (FeedbackNetwork,
                                                                 JFeedbackNetwork))
    target0 = _weights(tnet).sum(axis=(1, 3)).ravel()
    for net in (tnet, jnet):
        net.fit_stdp(x, sampling_steps=50, homeostasis_steps=h, verbose=False)
    W = _weights(tnet)
    np.testing.assert_allclose(W.sum(axis=(1, 3)).ravel(), target0, rtol=1e-9)
    np.testing.assert_allclose(tnet.get_edge("qif", "qif")._homeo_target.numpy(), target0,
                               rtol=1e-12)
    assert np.abs(W - np.clip(blocks, 0.0, 1.0)).max() > 1e-5
    np.testing.assert_allclose(W, _weights(jnet), **TIGHT)


def test_block_reward_mode_end_to_end_matches_jax():
    rng = np.random.default_rng(34)
    T, dt = 300, 1e-3
    blocks, cols = _toy(rng, nb=3, cb=2, bs=2)
    x = (rng.random((T, 6)) < 0.15) * 30.0
    reward = rng.normal(size=T)
    tnet, jnet = (_block_net(cls, dt, blocks, cols) for cls in (FeedbackNetwork,
                                                                 JFeedbackNetwork))
    obs = [net.fit_stdp(x, sampling_steps=50, reward=reward, verbose=False,
                        homeostasis_steps=64) for net in (tnet, jnet)]
    edge = tnet.get_edge("qif", "qif")
    assert edge.params["elig"].shape == edge.params["weights"].shape
    W = _weights(tnet)
    assert np.all(np.isfinite(W)) and W.min() >= 0.0 and W.max() <= 1.0
    assert np.abs(W - np.clip(blocks, 0.0, 1.0)).max() > 1e-6
    for key in ("weights", "elig", "x_pre", "x_post"):
        np.testing.assert_allclose(edge.params[key].numpy(),
                                   np.asarray(jnet.get_edge("qif", "qif").params[key]),
                                   err_msg=key, **TIGHT)
    np.testing.assert_allclose(np.asarray(obs[0]["w_max"]), np.asarray(obs[1]["w_max"]),
                               **TIGHT)


def test_block_stream_bfloat16_reads_the_current_plastic_weights():
    """block_dtype='bfloat16': the projection streams the blocks at bfloat16,
    cast in the step from the weights current in the loop (the once-per-run
    prep never hands the loop a stale copy), as in JAX."""
    rng = np.random.default_rng(36)
    T, dt = 300, 1e-3
    blocks, cols = _toy(rng, nb=3, cb=2, bs=2, lo=0.5, hi=1.0)
    x = (rng.random((T, 6)) < 0.15) * 30.0
    kw = dict(a_plus=0.2, a_minus=0.05, block_dtype="bfloat16")
    tnet, jnet = (_block_net(cls, dt, blocks, cols, **kw) for cls in (FeedbackNetwork,
                                                                       JFeedbackNetwork))
    edge = tnet.get_edge("qif", "qif")
    assert edge.block_dtype == torch.bfloat16 and edge.params["weights"].dtype == torch.float64
    obs = [net.fit_stdp(x, sampling_steps=10, verbose=False, record_spikes=["qif"])
           for net in (tnet, jnet)]
    np.testing.assert_array_equal(obs[0].to_numpy(("qif", "spikes")),
                                  obs[1].to_numpy(("qif", "spikes")))
    np.testing.assert_allclose(obs[0].to_numpy("out"), obs[1].to_numpy("out"), **TIGHT)
    np.testing.assert_allclose(_weights(tnet), _weights(jnet), **TIGHT)
    # a run that reads a frozen copy of the initial blocks parts from it
    stale = _block_net(FeedbackNetwork, dt, blocks, cols, **kw)
    stale_edge = stale.get_edge("qif", "qif")
    frozen = stale_edge.prep_params(dict(stale_edge.params))["weights"]
    stale_edge.prep_params = lambda sub: {**sub, "weights": frozen}
    stale.run(x, sampling_steps=10, verbose=False)
    assert not np.allclose(stale.get_node("qif").y.numpy(), tnet.get_node("qif").y.numpy())


def test_block_plain_update_with_the_native_sampler_shape():
    """The plain update at a sampled coupling's shape (bs 128, fan-in 300,
    ``block_random_connectivity``'s columns) equals the dense rule on the
    stored entries in one step, float32."""
    n, bs = 1024, 128
    A = block_random_connectivity(n, n, 300, block_size=bs, seed=3)
    rng = np.random.default_rng(3)
    W = torch.as_tensor(A.blocks * 15.0, dtype=torch.float32)
    cols = torch.as_tensor(np.asarray(A.cols, dtype=np.int64))
    xp, xq = (torch.as_tensor(rng.random(n), dtype=torch.float32) for _ in range(2))
    sp, sq = (torch.as_tensor(rng.random(n) < 0.2, dtype=torch.float32) for _ in range(2))
    c = stdp_consts(torch.float32, "cpu", 1e-3, 1.2e-3, 0.0, 0.03)
    got, _ = stdp_update_plain(W, xp, xq, sp, sq, c, True, cols)
    n_br, cb = cols.shape
    for r, cc in ((0, 0), (n_br - 1, cb - 1), (n_br // 2, 1)):
        j = int(cols[r, cc]) * bs
        w = W[r, cc].double().numpy()
        pot = 1e-3 * np.outer(sq[r * bs:(r + 1) * bs], xp[j:j + bs])
        dep = 1.2e-3 * np.outer(xq[r * bs:(r + 1) * bs], sp[j:j + bs])
        ref = np.clip(w + pot * (0.03 - w) - dep * (w - 0.0), 0.0, 0.03)
        np.testing.assert_allclose(got[r, cc].numpy(), ref, rtol=1e-6, atol=1e-9)


def test_block_stdp_dispatch_and_errors():
    rng = np.random.default_rng(35)
    blocks, cols = _toy(rng, nb=3, cb=2, bs=2)
    A = BlockSparseCoupling(blocks, cols)
    net = _block_net(FeedbackNetwork, 1e-3, blocks, cols)
    assert isinstance(net.get_edge("qif", "qif"), BlockSparseSTDP)
    assert net._train_edge == ("qif", "qif")
    net2 = FeedbackNetwork(1e-3, dtype=torch.float64, device="cpu")
    net2.add_diffeq_node("qif", QIF, weights=np.zeros((6, 6)), source_var="s",
                         target_var="s_in", input_var="I_ext", output_var="s",
                         spike_var="spike", reset_var="v")
    with pytest.raises(ValueError, match="not supported on a plastic"):
        net2.add_edge("qif", "qif", feedback=True, train="stdp", weights=A,
                      delays=np.zeros((3, 2), dtype=int))
    with pytest.raises(ValueError, match="only optional per-block delays"):
        net2.add_edge("qif", "qif", feedback=True, train="stdp", weights=A, mask=np.ones((6, 6)))
    # the JAX package swallows rng here (its block weights need no draw)
    with pytest.raises(ValueError, match="no rng"):
        net2.add_edge("qif", "qif", feedback=True, train="stdp", weights=A,
                      rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="int8_master"):
        net2.add_edge("qif", "qif", feedback=True, train="stdp", weights=A,
                      block_dtype="int8_master")
    with pytest.raises(ValueError, match="floating"):
        net2.add_edge("qif", "qif", feedback=True, train="stdp", weights=A, w_dtype="int8")
    with pytest.raises(ValueError, match="tau_plus"):
        BlockSparseSTDP(6, 6, weights=A, tau_plus=0.0, device="cpu")
    with pytest.raises(ValueError, match="BlockSparseCoupling"):
        BlockSparseSTDP(6, 6, weights=np.ones((6, 6)), device="cpu")
    with pytest.raises(ValueError, match="no foo"):
        BlockSparseSTDP(6, 6, weights=A, device="cpu", foo=1)
    with pytest.raises(TypeError, match="DeviceMesh"):  # mesh= is ported: no DeviceMesh
        net.fit_stdp(np.zeros((5, 6)), verbose=False, mesh=object())
    # bf16 carry: the blocks and both traces at bfloat16
    edge = BlockSparseSTDP(6, 6, weights=A, w_dtype="bfloat16", device="cpu")
    assert {edge.params[k].dtype for k in ("weights", "x_pre", "x_post")} == {torch.bfloat16}
