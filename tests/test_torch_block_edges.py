"""The port's ``BlockSparseLinear`` against the JAX package's: the delayed
read against the densified delay matrix, validation, ``block_dtype``
(bfloat16 and ``int8_master``), the edge in ``FeedbackNetwork`` runs
(chunked runs continue the circular history bit for bit, ``run_batch``,
``fit_bptt``), ``add_edge``'s dispatch and error order, the frozen
``int8_master`` edge's straight-through source gradient, and
``convert.load_jax_params`` of the edge's blocks and ``(hist, t)`` state.

Mirrors ``test_block_sparse_linear_*`` in ``tests/test_edges.py:496-675``
and ``test_block_edge_int8_master_frozen_prep_equals_ste_step`` in
``tests/test_sparse.py``; float64 where those take it, the same seeded
numpy inputs through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rectipy_tpu.edges as jedges
import rectipy_tpu_torch.edges as tedges
import rectipy_tpu_torch.ops.quant as tquant
from rectipy_tpu import FeedbackNetwork as JFeedbackNetwork
from rectipy_tpu.ops.sparse import BlockSparseCoupling as JBlocks
from rectipy_tpu.ops.sparse import block_random_connectivity as jbrc
from rectipy_tpu_torch import BlockSparseCoupling, FeedbackNetwork, load_jax_params

PREFIX = {"jax": "rectipy_tpu.models.", "torch": "rectipy_tpu_torch.models."}
TANH = "rate_neurons.leaky_integrator.tanh"
QIF = "spiking_neurons.qif.qif"


def _small_block_coupling(rng, n_br=3, cb=2, bs=4, nb_in=4):
    # tests/test_edges.py:486: distinct cols per row
    blocks = rng.normal(size=(n_br, cb, bs, bs)) * 0.3
    cols = np.stack([rng.choice(nb_in, size=cb, replace=False)
                     for _ in range(n_br)]).astype(np.int32)
    return BlockSparseCoupling(blocks, cols)


def _pair(*args, **kw):
    """The same edge in both packages, float64 (the port's on the CPU)."""
    W = args[2]
    jw = JBlocks(W.blocks, W.cols)
    return (jedges.BlockSparseLinear(args[0], args[1], jw, dtype=jnp.float64, **kw),
            tedges.BlockSparseLinear(*args, dtype=torch.float64, device="cpu", **kw))


def test_block_sparse_linear_oracle():
    # test_edges.py:496 -- the delayed block edge == LinearMemoryMatrix on the
    # densified coupling with the block-expanded delays; the delay-free edge
    # == the dense matvec; both == the JAX edge
    rng = np.random.default_rng(5)
    n_br, cb, bs, nb_in = 3, 2, 4, 4
    n_out, n_in = n_br * bs, nb_in * bs
    W = _small_block_coupling(rng, n_br, cb, bs, nb_in)
    d_blk = rng.integers(0, 7, size=(n_br, cb))
    xs = rng.normal(size=(25, n_in))
    W_dense, D_dense = np.zeros((n_out, n_in)), np.zeros((n_out, n_in), dtype=int)
    for r in range(n_br):
        for c in range(cb):
            j = int(W.cols[r, c]) * bs
            W_dense[r * bs:(r + 1) * bs, j:j + bs] = W.blocks[r, c]
            D_dense[r * bs:(r + 1) * bs, j:j + bs] = d_blk[r, c]
    je, te = _pair(n_in, n_out, W, delays=d_blk)
    ref = tedges.LinearMemoryMatrix(n_in, n_out, delays=D_dense, weights=W_dense, mode="gather",
                                    dtype=torch.float64, device="cpu")
    for x in xs:
        got = te.forward(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, ref.forward(torch.as_tensor(x)).numpy(), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(got, np.asarray(je.forward(jnp.asarray(x))), rtol=1e-12,
                                   atol=1e-14)
    hist, t = te.init_state()
    assert hist.shape == (nb_in, int(d_blk.max()) + 1, bs) and int(t) == len(xs)
    np.testing.assert_allclose(hist.numpy(), np.asarray(je.init_state()[0]), rtol=0, atol=0)
    je0, te0 = _pair(n_in, n_out, W)
    assert te0.init_state() is None
    for x in xs[:5]:
        got = te0.forward(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, W_dense @ x, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got, np.asarray(je0.forward(jnp.asarray(x))), rtol=1e-12,
                                   atol=1e-14)


def test_block_sparse_linear_validation():
    # test_edges.py:535
    rng = np.random.default_rng(6)
    W = _small_block_coupling(rng)
    n_in, n_out = 16, 12
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="BlockSparseCoupling"):
        tedges.BlockSparseLinear(n_in, n_out, weights=np.zeros((n_out, n_in)), **kw)
    with pytest.raises(ValueError, match="n_out"):
        tedges.BlockSparseLinear(n_in, 8, weights=W, **kw)
    with pytest.raises(ValueError, match="multiple"):
        tedges.BlockSparseLinear(n_in + 2, n_out, weights=W, **kw)
    with pytest.raises(ValueError, match="outside"):
        tedges.BlockSparseLinear(8, n_out, weights=W, **kw)
    with pytest.raises(ValueError, match="Per-block"):
        tedges.BlockSparseLinear(n_in, n_out, weights=W, delays=np.zeros((2, 2), int), **kw)
    with pytest.raises(ValueError, match="non-negative"):
        tedges.BlockSparseLinear(n_in, n_out, weights=W, delays=np.full((3, 2), -1), **kw)
    with pytest.raises(ValueError, match="integer"):
        tedges.BlockSparseLinear(n_in, n_out, weights=W, delays=np.full((3, 2), 1.5), **kw)
    with pytest.raises(ValueError, match="floating"):
        tedges.BlockSparseLinear(n_in, n_out, weights=W, block_dtype=torch.int8, **kw)
    e = tedges.BlockSparseLinear(n_in, n_out, weights=W, delays=np.full((3, 2), 2.0), **kw)
    assert e.max_delay == 2 and e.train_keys == []
    assert tedges.BlockSparseLinear(n_in, n_out, weights=W, detach=False, **kw).train_keys \
        == ["weights"]
    with pytest.raises(ValueError, match="keep shape"):
        e.weights = np.zeros((3, 2, 4, 3))


def _pop(pkg, n, W=None, d_blk=None, train=None, **ekw):
    """test_edges.py:565's network: a tanh population with its whole
    coupling on a delayed block feedback self-edge (float64)."""
    net = (JFeedbackNetwork(1e-2, dtype=jnp.float64) if pkg == "jax"
           else FeedbackNetwork(1e-2, dtype=torch.float64, device="cpu"))
    net.add_diffeq_node("pop", PREFIX[pkg] + TANH, weights=np.zeros((n, n)),
                        source_var="tanh_op/r", target_var="li_op/r_in",
                        input_var="li_op/I_ext", output_var="li_op/v")
    if pkg == "jax":
        W = JBlocks(W.blocks, W.cols)
    net.add_edge("pop", "pop", weights=W, delays=d_blk, feedback=True, train=train, **ekw)
    net.compile()
    return net


def test_block_sparse_linear_network_run_and_fit():
    # test_edges.py:565 -- chunked runs continue the circular buffer exactly;
    # run_batch; fit_bptt trains the blocks (losses decrease); each against
    # the JAX package
    rng = np.random.default_rng(11)
    bs, n = 4, 8
    W = _small_block_coupling(rng, 2, 2, bs, 2)
    d_blk = rng.integers(1, 6, size=(2, 2))
    inp = rng.normal(size=(40, n))
    full = _pop("torch", n, W, d_blk).run(inp, sampling_steps=1, verbose=False).to_numpy("out")
    want = _pop("jax", n, W, d_blk).run(inp, sampling_steps=1, verbose=False).to_numpy("out")
    np.testing.assert_allclose(full, want, rtol=1e-12, atol=1e-14)
    net2 = _pop("torch", n, W, d_blk)
    a = net2.run(inp[:17], sampling_steps=1, verbose=False).to_numpy("out")
    b = net2.run(inp[17:], sampling_steps=1, verbose=False).to_numpy("out")
    np.testing.assert_array_equal(np.concatenate([a, b]), full)
    assert int(net2.get_edge("pop", "pop").init_state()[1]) == 40
    trials = rng.normal(size=(3, 20, n))
    res = _pop("torch", n, W, d_blk).run_batch(trials, sampling_steps=1, verbose=False)
    res_j = _pop("jax", n, W, d_blk).run_batch(trials, sampling_steps=1, verbose=False)
    assert res["out"].shape == (3, 20, n)
    np.testing.assert_allclose(res["out"], np.asarray(res_j["out"]), rtol=1e-12, atol=1e-14)
    # teacher-student: the port's plain-autograd fit against JAX's
    losses = {}
    for pkg in ("torch", "jax"):
        net_t = _pop(pkg, n, W, d_blk, train="gd")
        tgt = np.asarray(net_t.run(inp, verbose=False, sampling_steps=1).to_numpy("out"))
        edge = net_t.get_edge("pop", "pop")
        edge.weights = np.asarray(edge.weights) * 1.3
        obs = net_t.fit_bptt([inp] * 8, [tgt] * 8, optimizer="adam", lr=1e-2, verbose=False)
        losses[pkg] = np.asarray([float(v) for v in obs["epoch_loss"]])
    assert losses["torch"][-1] < losses["torch"][0]
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-8)


def test_block_sparse_linear_block_dtype():
    # test_edges.py:612 -- bfloat16 blocks: once-per-run prep cast, the f32
    # edge's outputs to bf16 tolerance, the master stays and still trains
    rng = np.random.default_rng(23)
    n_br, cb, bs, nb = 3, 2, 4, 3
    n_in, n_out = nb * bs, n_br * bs
    W = _small_block_coupling(rng, n_br, cb, bs, nb)
    d_blk = rng.integers(1, 6, size=(n_br, cb))
    xs = rng.normal(size=(30, n_in))
    e32 = tedges.BlockSparseLinear(n_in, n_out, weights=W, delays=d_blk, device="cpu",
                                   dtype=torch.float64)
    je16, e16 = _pair(n_in, n_out, W, delays=d_blk, block_dtype="bfloat16")
    sub = e16.prep_params(dict(e16.params))
    assert sub["weights"].dtype == torch.bfloat16
    assert e16.params["weights"].dtype == torch.float64
    assert tedges.BlockSparseLinear(n_in, n_out, weights=W, dtype=torch.float32,
                                    block_dtype=torch.float32, device="cpu").block_dtype is None
    got32 = np.stack([e32.forward(torch.as_tensor(x)).numpy() for x in xs])
    got16 = np.stack([e16.forward(torch.as_tensor(x)).numpy() for x in xs])
    np.testing.assert_allclose(got16, got32, rtol=3e-2, atol=3e-2)
    assert np.corrcoef(got16.ravel(), got32.ravel())[0, 1] > 0.999
    want16 = np.stack([np.asarray(je16.forward(jnp.asarray(x))) for x in xs])
    np.testing.assert_allclose(got16, want16, rtol=1e-12, atol=1e-14)  # exact bf16 products
    Wsq = _small_block_coupling(rng, n_br, cb, bs, n_br)
    inp = rng.normal(size=(25, n_out))
    o32 = _pop("torch", n_out, Wsq, d_blk).run(inp, sampling_steps=1,
                                                verbose=False).to_numpy("out")
    net16 = _pop("torch", n_out, Wsq, d_blk, block_dtype="bfloat16")
    o16 = net16.run(inp, sampling_steps=1, verbose=False).to_numpy("out")
    np.testing.assert_allclose(o16, o32, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(
        o16, _pop("jax", n_out, Wsq, d_blk, block_dtype="bfloat16").run(
            inp, sampling_steps=1, verbose=False).to_numpy("out"), rtol=1e-12, atol=1e-14)
    net_t = _pop("torch", n_out, Wsq, d_blk, train="gd", block_dtype="bfloat16")
    tgt = net_t.run(inp, verbose=False, sampling_steps=1).to_numpy("out")
    edge = net_t.get_edge("pop", "pop")
    edge.weights = edge.weights * 1.3
    obs = net_t.fit_bptt([inp] * 8, [tgt] * 8, optimizer="adam", lr=1e-2, verbose=False)
    losses = [float(v) for v in obs["epoch_loss"]]
    assert losses[-1] < losses[0]
    assert net_t.get_edge("pop", "pop").weights.dtype == torch.float64


def _qif_fb(pkg, A, train, eta, w_in, dtype):
    """test_sparse.py:228's network: an input node into a QIF population
    whose coupling is an int8_master block feedback self-edge."""
    N = eta.shape[0]
    net = (JFeedbackNetwork(1e-3, dtype=jnp.float32 if dtype == "float32" else jnp.float64)
           if pkg == "jax" else FeedbackNetwork(1e-3, dtype=getattr(torch, dtype), device="cpu"))
    net.add_func_node("inp", 1, activation_function="identity")
    net.add_diffeq_node("qif", PREFIX[pkg] + QIF, n=N, input_var="I_ext", output_var="s",
                        spike_var="spike", spike_def="v", op="qif_op", spike_threshold=1e2,
                        spike_reset=-1e2, node_vars={"all/qif_op/eta": eta})
    net.add_edge("inp", "qif", weights=w_in)
    if pkg == "jax":
        A = JBlocks(A.blocks, A.cols)
    net.add_edge("qif", "qif", weights=A, feedback=True, train=train, block_dtype="int8_master")
    net.compile()
    return net


def test_block_edge_int8_master_frozen_prep_equals_ste_step():
    # test_sparse.py:228 -- the frozen edge's once-per-run quantization and
    # the trainable edge's in-step STE apply give the same trajectory, and
    # each equals the JAX package's (the int8 sums and scales are exact)
    N, BS, T = 64, 16, 300
    A = jbrc(N, N, 8, block_size=BS, seed=3)
    eta = 800.0 + 100.0 * np.random.default_rng(1).standard_normal(N)
    w_in = np.random.default_rng(7).normal(size=(N, 1)).astype(np.float32)
    ins = np.zeros((T, 1), dtype=np.float32)
    ins[T // 4:, 0] = 3.0
    out = {}
    for pkg in ("torch", "jax"):
        for train in (None, "gd"):
            net = _qif_fb(pkg, BlockSparseCoupling(A.blocks, A.cols), train, eta, w_in,
                          "float32")
            out[pkg, train] = np.asarray(net.run(ins, verbose=False).to_numpy("out"))
    np.testing.assert_allclose(out["torch", "gd"], out["torch", None], rtol=1e-6, atol=1e-8)
    assert np.abs(out["torch", None]).max() > 0
    np.testing.assert_allclose(out["torch", None], out["jax", None], rtol=1e-5, atol=1e-6)


def test_frozen_int8_master_edge_passes_ste_source_gradients():
    # the JAX package's frozen int8_master block edge gives exactly zero
    # source gradients through plain autodiff (ROADMAP Queue 3); the port's
    # prepped contraction carries the stack form's STE gradient, equal to
    # make_block_int8_stack_apply's source gradient, and nonzero
    rng = np.random.default_rng(9)
    W = _small_block_coupling(rng, n_br=4, cb=2, bs=8, nb_in=4)
    d_blk = rng.integers(0, 4, size=(4, 2))
    e = tedges.BlockSparseLinear(32, 32, weights=W, delays=d_blk, block_dtype="int8_master",
                                 dtype=torch.float32, device="cpu")
    params = e.prep_params(dict(e.params))
    assert isinstance(params["weights"], tuple)
    step = e.make_step()
    xs = torch.as_tensor(rng.normal(size=(6, 32)).astype(np.float32)).requires_grad_(True)
    gs = torch.as_tensor(rng.normal(size=(6, 32)).astype(np.float32))

    def loss(prm):
        state, total = e.init_state(), 0.0
        for x, g in zip(xs, gs):
            state, y = step(state, prm, x)
            total = total + (y * g).sum()
        return total

    (g_prepped,) = torch.autograd.grad(loss(params), xs)
    # the raw master takes make_block_int8_stack_apply in the step
    (g_ste,) = torch.autograd.grad(loss(dict(e.params)), xs)
    assert float(g_prepped.abs().max()) > 0, "the frozen edge's source gradient vanished"
    np.testing.assert_array_equal(g_prepped.numpy(), g_ste.numpy())
    # and the stack form's mv_t is that gradient for one step from a zero history
    s_blk = torch.as_tensor(rng.normal(size=(4, 2, 8)).astype(np.float32)).requires_grad_(True)
    g = torch.as_tensor(rng.normal(size=32).astype(np.float32))
    (ds,) = torch.autograd.grad((tquant.block_int8_stack_prepped(params["weights"], s_blk)
                                 * g).sum(), s_blk)
    _, _, mv_t, _ = tquant.make_block_int8_stack_ops()
    np.testing.assert_array_equal(ds.numpy(), mv_t(params["weights"], g).numpy())


@pytest.mark.parametrize("case", ["stp_first", "mask", "filter", "stdp", "dispatch"])
def test_add_edge_block_dispatch_and_errors(case):
    # rectipy_tpu/network.py:529-543: the STP combination check comes first,
    # then a block coupling with a mask or filter; stdp makes a
    # BlockSparseSTDP edge and refuses per-block delays
    rng = np.random.default_rng(3)
    W = _small_block_coupling(rng, 2, 2, 4, 2)
    net = FeedbackNetwork(1e-2, dtype=torch.float64, device="cpu")
    net.add_diffeq_node("pop", PREFIX["torch"] + TANH, weights=np.zeros((8, 8)),
                        source_var="tanh_op/r", target_var="li_op/r_in",
                        input_var="li_op/I_ext", output_var="li_op/v")
    kw = dict(weights=W, feedback=True)
    if case == "stp_first":
        with pytest.raises(ValueError, match="Short-term plasticity"):
            net.add_edge("pop", "pop", tau_depress=5.0, mask=np.ones((8, 8)), **kw)
    elif case == "mask":
        with pytest.raises(ValueError, match="per-block"):
            net.add_edge("pop", "pop", mask=np.ones((8, 8)), **kw)
    elif case == "filter":
        with pytest.raises(ValueError, match="per-block"):
            net.add_edge("pop", "pop", filter_weights=np.eye(8), **kw)
    elif case == "stdp":
        with pytest.raises(ValueError, match="not supported on a plastic"):
            net.add_edge("pop", "pop", train="stdp", delays=np.ones((2, 2), dtype=int), **kw)
        e = net.add_edge("pop", "pop", train="stdp", **kw)
        assert isinstance(e, tedges.BlockSparseSTDP) and net._train_edge == ("pop", "pop")
    else:
        e = net.add_edge("pop", "pop", delays=np.ones((2, 2), dtype=int), **kw)
        assert isinstance(e, tedges.BlockSparseLinear) and e.max_delay == 1
        assert e.dtype == torch.float64


def test_load_jax_params_carries_block_edge_and_state():
    # the edge's blocks and its (hist, t) state cross from a JAX network that
    # ran 13 steps; both networks then continue equal; a state of another
    # shape raises KeyError
    rng = np.random.default_rng(12)
    n = 8
    W = _small_block_coupling(rng, 2, 2, 4, 2)
    d_blk = rng.integers(1, 6, size=(2, 2))
    inp = rng.normal(size=(30, n))
    jnet = _pop("jax", n, W, d_blk)
    jnet.run(inp[:13], sampling_steps=1, verbose=False)
    edge = jnet.get_edge("pop", "pop")
    edge.weights = np.asarray(edge.weights) * 0.9
    params = jax.tree.map(np.asarray, jnet.parameters_pytree())
    state = jax.tree.map(lambda a: None if a is None else np.asarray(a), jnet.init_state(),
                         is_leaf=lambda a: a is None)
    tnet = _pop("torch", n, W, d_blk)
    load_jax_params(tnet, params, state)
    hist, t = tnet.get_edge("pop", "pop").init_state()
    assert int(t) == 13 and t.dtype == torch.int32
    np.testing.assert_array_equal(hist.numpy(), np.asarray(edge.init_state()[0]))
    got = tnet.run(inp[13:], sampling_steps=1, verbose=False).to_numpy("out")
    want = jnet.run(inp[13:], sampling_steps=1, verbose=False).to_numpy("out")
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    bad = dict(state)
    bad["edges"] = {k: (v[0][:, :2], v[1]) for k, v in state["edges"].items()}
    with pytest.raises(KeyError, match="pop->pop"):
        load_jax_params(_pop("torch", n, W, d_blk), params, bad)
