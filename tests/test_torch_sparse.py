"""The port's block-sparse couplings against the JAX package: the samplers
(numpy and native, bit for bit), ``block_sparse_matvec``, the int8 block
ops and their kernel's plain version, block-coupled nodes in ``run`` and
``run_batch`` at every coupling type, the int4 refusal and the fused
kernels' refusals, ``convert.load_jax_params`` of block nodes, and the
native C++ sampler behind ``random_connectivity``.

Mirrors ``tests/test_sparse.py`` (except the sharded case), the block case
of ``tests/test_dsl.py:606`` and ``tests/test_native.py``.  The same seeded
numpy inputs go through both packages, float64 where the reference tests
take it, with the reference tests' tolerances; the samplers, the
quantization and the int8 products agree bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rectipy_tpu.ops.quant as jquant
import rectipy_tpu.ops.sparse as jsparse
import rectipy_tpu.utility as jutility
import rectipy_tpu_torch.ops.quant as tquant
import rectipy_tpu_torch.ops.sparse as tsparse
import rectipy_tpu_torch.utility as tutility
from rectipy_tpu import Network as JNetwork
from rectipy_tpu.native import sample_fixed_fanin as jsample
from rectipy_tpu_torch import (BlockSparseCoupling, Network, attach_fused_qif_step,
                               attach_generic_fused_step, block_random_connectivity,
                               load_jax_params, lower)
from rectipy_tpu_torch.native import load_native, sample_fixed_fanin

PREFIX = {"jax": "rectipy_tpu.models.", "torch": "rectipy_tpu_torch.models."}
QIF_SFA = "spiking_neurons.qif.qif_sfa"
TANH = "rate_neurons.leaky_integrator.tanh"
JTYPE = {"float64": jnp.float64, "float32": jnp.float32}
TTYPE = {"float64": torch.float64, "float32": torch.float32}


def _qif(pkg, weights, n, dtype="float64", coupling_dtype=None, scale=1.0, etas=None, **kw):
    """tests/test_sparse.py's ``_build_qif`` in either package."""
    if etas is None:
        etas = -5.0 + np.tan((np.pi / 2) * (2.0 * np.arange(1, n + 1) - n - 1) / (n + 1))
    net = (JNetwork(1e-3, dtype=JTYPE[dtype]) if pkg == "jax"
           else Network(1e-3, dtype=TTYPE[dtype], device="cpu"))
    if scale != 1.0:
        weights = jsparse.BlockSparseCoupling(weights.blocks * scale, weights.cols)
    net.add_diffeq_node("qif", PREFIX[pkg] + QIF_SFA, weights=weights, source_var="s",
                        target_var="s_in", input_var="I_ext", output_var="s", op="qif_sfa_op",
                        spike_var="spike", spike_def="v", spike_threshold=1e2,
                        spike_reset=-1e2,
                        node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/alpha": 0.05,
                                   "all/qif_sfa_op/k": 15.0},
                        coupling_dtype=coupling_dtype, **kw)
    return net


def _run(net, inp, **kw):
    obs = net.run(inp, sampling_steps=10, verbose=False,
                  record_vars=[("qif", "v", False)], **kw)
    return obs.to_numpy("out"), obs.to_numpy(("qif", "v"))


# ------------------------------------------------------------------ samplers
def test_generator_invariants():
    # test_sparse.py:19
    n, fan_in, bs = 256, 24, 32
    A = block_random_connectivity(n, n, fan_in, block_size=bs, seed=3)
    W = A.to_dense()
    assert W.shape == (n, n)
    np.testing.assert_array_equal((W != 0).sum(axis=1), fan_in)
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-6)
    for r in range(n // bs):
        used = {int(c) for c in np.nonzero(W[r * bs:(r + 1) * bs].any(axis=0))[0] // bs}
        assert used <= set(int(c) for c in A.cols[r])
    with pytest.raises(ValueError, match="multiples"):
        block_random_connectivity(100, 100, 8, block_size=32)
    with pytest.raises(ValueError, match="candidate pool"):
        block_random_connectivity(64, 64, 70, block_size=32)


def test_generator_backends_share_contract():
    # test_sparse.py:33
    n, fan_in, bs = 256, 24, 32
    A_auto = block_random_connectivity(n, n, fan_in, block_size=bs, seed=9)
    assert block_random_connectivity.last_backend == "native"
    A_np = block_random_connectivity(n, n, fan_in, block_size=bs, seed=9, backend="numpy")
    assert block_random_connectivity.last_backend == "numpy"
    np.testing.assert_array_equal(A_auto.cols, A_np.cols)
    for A in (A_auto, A_np):
        W = A.to_dense()
        np.testing.assert_array_equal((W != 0).sum(axis=1), fan_in)
        np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-6)
    again = block_random_connectivity(n, n, fan_in, block_size=bs, seed=9)
    np.testing.assert_array_equal(A_auto.blocks, again.blocks)
    other = block_random_connectivity(n, n, fan_in, block_size=bs, seed=10)
    assert not np.array_equal(A_auto.blocks, other.blocks)
    # float64 blocks take numpy on auto, as in the JAX package
    block_random_connectivity(64, 64, 8, block_size=32, seed=1, dtype=np.float64)
    assert block_random_connectivity.last_backend == "numpy"


@pytest.mark.parametrize("backend", ["numpy", "auto"])
@pytest.mark.parametrize("shape", [(256, 256, 24, 32, None), (192, 128, 17, 32, 3),
                                   (64, 64, 5, 16, 4)])
def test_generator_equals_jax_bit_for_bit(backend, shape):
    n, m, fan_in, bs, sb = shape
    kw = dict(block_size=bs, source_blocks=sb, seed=5, backend=backend)
    got = block_random_connectivity(n, m, fan_in, **kw)
    want = jsparse.block_random_connectivity(n, m, fan_in, **kw)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.blocks, want.blocks)
    assert got.blocks.dtype == want.blocks.dtype and got.shape == want.shape


def test_coupling_validation_and_dense_form():
    rng = np.random.default_rng(2)
    with pytest.raises(ValueError, match="n_br, cb"):
        BlockSparseCoupling(np.zeros((2, 2, 4, 3)), np.zeros((2, 2)))
    with pytest.raises(ValueError, match="n_br, cb"):
        BlockSparseCoupling(np.zeros((2, 2, 4, 4)), np.zeros((2, 3)))
    blocks, cols = rng.normal(size=(3, 2, 4, 4)), np.asarray([[0, 2], [1, 1], [2, 0]])
    A, J = BlockSparseCoupling(blocks, cols), jsparse.BlockSparseCoupling(blocks, cols)
    assert A.shape == J.shape == (12, 12) and A.ndim == 2 and A.bs == 4
    np.testing.assert_array_equal(A.to_dense(), J.to_dense())  # repeated cols add up
    # the (n, max(m, n)) quirk: a coupling of fewer source blocks is square
    assert BlockSparseCoupling(blocks, np.zeros((3, 2))).shape == (12, 12)
    s = torch.as_tensor(rng.normal(size=12))
    np.testing.assert_allclose(A.matvec(s).numpy(), (A.to_dense() @ s.numpy()).astype(np.float32),
                               rtol=0, atol=0)


# ----------------------------------------------------------- the contraction
def test_matvec_matches_dense():
    # test_sparse.py:53
    n, fan_in, bs = 192, 17, 32
    rng = np.random.default_rng(0)
    A = block_random_connectivity(n, n, fan_in, block_size=bs, seed=1)
    s = rng.normal(size=n).astype(np.float32)
    ours = tsparse.block_sparse_matvec(torch.as_tensor(A.blocks), torch.as_tensor(A.cols),
                                       torch.as_tensor(s)).numpy()
    np.testing.assert_allclose(ours, A.to_dense() @ s, rtol=1e-5, atol=1e-6)
    jax_out = np.asarray(jsparse.block_sparse_matvec(jnp.asarray(A.blocks),
                                                     jnp.asarray(A.cols), jnp.asarray(s)))
    np.testing.assert_allclose(ours, jax_out, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cast", [None, "bfloat16"])
def test_matvec_float64_is_rounded_to_float32_like_jax(cast):
    # at float64 the JAX function returns float64 values rounded once to
    # float32 (preferred_element_type=float32): the port returns the same
    # bits; bf16 operands multiply exactly with float32 sums
    rng = np.random.default_rng(3)
    A = block_random_connectivity(128, 128, 12, block_size=32, seed=2)
    blocks = rng.normal(size=A.blocks.shape)
    s = rng.normal(size=(3, 128))
    got = tsparse.block_sparse_matvec(torch.as_tensor(blocks), torch.as_tensor(A.cols),
                                      torch.as_tensor(s),
                                      cast_dtype=None if cast is None else torch.bfloat16)
    want = jax.vmap(lambda x: jsparse.block_sparse_matvec(
        jnp.asarray(blocks), jnp.asarray(A.cols), x,
        cast_dtype=None if cast is None else jnp.bfloat16))(jnp.asarray(s))
    assert got.dtype == torch.float64
    if cast is None:
        dense = np.zeros((128, 128))
        for r in range(4):
            for c, col in enumerate(A.cols[r]):
                dense[r * 32:(r + 1) * 32, col * 32:(col + 1) * 32] += blocks[r, c]
        np.testing.assert_array_equal(got.numpy(), (s @ dense.T).astype(np.float32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:  # float32 sums in another order
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_quantize_blocks_equals_jax_and_chunks(monkeypatch):
    rng = np.random.default_rng(4)
    blocks = rng.normal(size=(6, 3, 16, 16)).astype(np.float32)
    blocks[2, :, 5] = 0.0  # an all-zero row: the 1e-30 floor
    bq_j, s_j = jquant.quantize_blocks(jnp.asarray(blocks))
    bq, s = tquant.quantize_blocks(torch.as_tensor(blocks))
    np.testing.assert_array_equal(bq.numpy(), np.asarray(bq_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    host = tquant.quantize_blocks_host(blocks, torch.device("cpu"))
    monkeypatch.setattr(tsparse, "CHUNK_ELEMS", 16 * 16 * 3 * 2)  # two block rows a pass
    chunked = tquant.quantize_blocks(torch.as_tensor(blocks))
    chunked_host = tquant.quantize_blocks_host(blocks, torch.device("cpu"))
    for q, sc in (host, chunked, chunked_host):
        np.testing.assert_array_equal(q.numpy(), bq.numpy())
        np.testing.assert_array_equal(sc.numpy(), s.numpy())
    # a per-trial stack quantizes each trial's rows
    stack = np.stack([blocks, 2.0 * blocks])
    bq2, s2 = tquant.quantize_blocks(torch.as_tensor(stack))
    assert bq2.shape == stack.shape and s2.shape == (2, 6, 16)
    np.testing.assert_array_equal(bq2[1].numpy(), bq.numpy())


def _int64_model(bq, row_scale, xq, idx):
    """A numpy int64 model of block_int8_mv: exact sums, float32 epilogue."""
    n_br, cb, bs, _ = bq.shape
    out = np.zeros((xq.shape[0], n_br * bs), dtype=np.float32)
    for b in range(xq.shape[0]):
        for r in range(n_br):
            acc = np.zeros(bs, dtype=np.int64)
            for c in range(cb):
                acc += bq[r, c].astype(np.int64) @ xq[b, idx[r, c]].astype(np.int64)
            out[b, r * bs:(r + 1) * bs] = acc.astype(np.float32) * row_scale[r]
    return out


@pytest.mark.parametrize("B,n_br,cb,bs,n_src", [(1, 3, 2, 16, 4), (3, 2, 4, 20, 5),
                                                (16, 2, 3, 4, 3), (2, 1, 1, 7, 2)])
def test_block_int8_mv_plain_matches_int64_model(B, n_br, cb, bs, n_src):
    rng = np.random.default_rng(B * 100 + bs)
    bq = rng.integers(-127, 128, size=(n_br, cb, bs, bs)).astype(np.int8)
    xq = rng.integers(-127, 128, size=(B, n_src, bs)).astype(np.int8)
    idx = rng.integers(0, n_src, size=(n_br, cb)).astype(np.int32)
    scale = rng.random((n_br, bs)).astype(np.float32)
    want = _int64_model(bq, scale, xq, idx)
    got = tquant.block_int8_mv(torch.as_tensor(bq), torch.as_tensor(scale), torch.as_tensor(xq),
                               torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tquant.block_int8_mv.launches == 0  # the CPU takes the plain version
    # the flat history form: idx = arange(n_br * cb) over a gathered stack
    stack = np.stack([xq[:, idx[r, c]] for r in range(n_br) for c in range(cb)], axis=1)
    flat = np.arange(n_br * cb, dtype=np.int32).reshape(n_br, cb)
    np.testing.assert_array_equal(
        tquant.block_int8_mv(torch.as_tensor(bq), torch.as_tensor(scale),
                             torch.as_tensor(stack), torch.as_tensor(flat)).numpy(), want)


def test_block_int8_ops_equal_jax():
    # block_int8_mv (the JAX op) from the prepped pair, for a vector and for
    # trials under vmap: bit for bit; the stack form too
    rng = np.random.default_rng(5)
    A = block_random_connectivity(128, 128, 40, block_size=32, seed=4)  # 3 source blocks
    blocks = rng.normal(size=A.blocks.shape).astype(np.float32)
    wp_j = jquant.quantize_blocks(jnp.asarray(blocks))
    wp_t = tquant.quantize_blocks(torch.as_tensor(blocks))
    cols = torch.as_tensor(A.cols)
    for src in (rng.normal(size=128).astype(np.float32),
                rng.normal(size=(3, 128)).astype(np.float32)):
        fn = lambda x: jquant.block_int8_mv(wp_j, jnp.asarray(A.cols), x)  # noqa: E731
        want = fn(jnp.asarray(src)) if src.ndim == 1 else jax.vmap(fn)(jnp.asarray(src))
        got = tquant.block_int8_matvec(wp_t, cols, torch.as_tensor(src))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, jmv, jmv_t, jgw = jquant.make_block_int8_stack_ops()
    _, tmv, tmv_t, tgw = tquant.make_block_int8_stack_ops()
    s_blk = rng.normal(size=A.cols.shape + (32,)).astype(np.float32)
    np.testing.assert_array_equal(tmv(wp_t, torch.as_tensor(s_blk)).numpy(),
                                  np.asarray(jmv(wp_j, jnp.asarray(s_blk))))
    d = rng.normal(size=128).astype(np.float32)
    np.testing.assert_array_equal(tmv_t(wp_t, torch.as_tensor(d)).numpy(),
                                  np.asarray(jmv_t(wp_j, jnp.asarray(d))))
    D, S = rng.normal(size=(5, 128)), rng.normal(size=(5,) + A.cols.shape + (32,))
    np.testing.assert_allclose(tgw(torch.as_tensor(D), torch.as_tensor(S)).numpy(),
                               np.asarray(jgw(jnp.asarray(D), jnp.asarray(S))), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["scatter", "gather", "onehot"])
def test_transposed_matvec_modes_match_dense(mode, monkeypatch):
    # test_sparse.py:177 -- every RECTIPY_SPARSE_BWD mode of A^T @ delta, for
    # the float path and the int8_master path, against the densified oracle
    # and the JAX package's ops; the env var is read when the ops are built
    monkeypatch.setenv("RECTIPY_SPARSE_BWD", mode)
    n, fan_in, bs = 128, 24, 16
    A = block_random_connectivity(n, n, fan_in, block_size=bs, seed=5)
    delta = np.random.default_rng(6).normal(size=n)
    from rectipy_tpu.ops.bptt import _make_sparse_matvec as jmake

    from rectipy_tpu_torch.ops.bptt import _make_sparse_matvec

    mv_t = _make_sparse_matvec(None, torch.as_tensor(A.cols))[2]
    got = mv_t(torch.as_tensor(A.blocks, dtype=torch.float64), torch.as_tensor(delta)).numpy()
    np.testing.assert_allclose(got, A.to_dense().astype(np.float64).T @ delta, rtol=3e-5,
                               atol=1e-7)
    want = jmake(None, jnp.asarray(A.cols))[2](jnp.asarray(A.blocks, dtype=jnp.float64),
                                               jnp.asarray(delta))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-8)
    # the int8_master ops: the exact quantized oracle, and JAX's
    wp = tquant.quantize_blocks(torch.as_tensor(A.blocks, dtype=torch.float32))
    got_q = tquant.make_block_int8_ops(A.cols)[2](wp, torch.as_tensor(delta, dtype=torch.float32))
    bq, scale = (t.numpy() for t in wp)
    n_br = A.cols.shape[0]
    v = (scale.reshape(n_br, bs) * delta.reshape(n_br, bs)).reshape(-1).astype(np.float32)
    vq, vs = (t.numpy() for t in tquant.quant_vec(torch.as_tensor(v)))
    Bq = np.zeros((n, n))
    for r in range(n_br):
        for j, c in enumerate(A.cols[r]):
            Bq[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] += bq[r, j].astype(np.float64)
    np.testing.assert_allclose(got_q.numpy(), (Bq.T @ vq.astype(np.float64)) * float(vs),
                               rtol=1e-5, atol=1e-5)
    want_q = jquant.make_block_int8_ops(np.asarray(A.cols))[2](
        jquant.quantize_blocks(jnp.asarray(A.blocks, dtype=jnp.float32)),
        jnp.asarray(delta, dtype=jnp.float32))
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-6, atol=1e-6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RECTIPY_SPARSE_BWD", "sideways")
        with pytest.raises(ValueError, match="RECTIPY_SPARSE_BWD"):
            _make_sparse_matvec(None, torch.as_tensor(A.cols))


# --------------------------------------------------------------- the nodes
def test_network_trajectory_matches_densified_and_jax():
    # test_sparse.py:78 -- float64; the coupling scaled x30 so that it moves
    # v (at the reference's scale the spike times, hence s, do not change)
    n, fan_in, bs = 128, 12, 32
    A = jsparse.block_random_connectivity(n, n, fan_in, block_size=bs, seed=2)
    inp = np.zeros((400, n))
    inp[100:, :] = 3.0
    o_sparse = _run(_qif("torch", A, n), inp)[0]
    o_dense = _run(_qif("torch", A.to_dense().astype(np.float64), n), inp)[0]
    assert o_sparse.max() > 0, "no activity -> test is vacuous"
    np.testing.assert_allclose(o_sparse, o_dense, rtol=1e-9, atol=1e-12)
    got = _run(_qif("torch", A, n, scale=30.0), inp)
    want = _run(_qif("jax", A, n, scale=30.0), inp)
    free = _run(_qif("torch", A, n, scale=0.0), inp)
    assert np.abs(got[1] - free[1]).max() > 1.0, "the coupling does not act"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * np.abs(w).max())


@pytest.mark.parametrize("coupling", ["int8", "int8_master", "bfloat16_master"])
def test_quantized_block_couplings_match_jax(coupling):
    # float64 in both packages, the coupling scaled x30 so that it moves v:
    # the int8 sums and scales are exact and equal, bf16 products exact with
    # float32 sums in another order
    n = 128
    A = jsparse.block_random_connectivity(n, n, 12, block_size=32, seed=8)
    inp = np.full((400, n), 5.0)
    tnet = _qif("torch", A, n, coupling_dtype=coupling, scale=30.0)
    got = _run(tnet, inp)
    want = _run(_qif("jax", A, n, coupling_dtype=coupling, scale=30.0), inp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-7 * np.abs(w).max())
    w = tnet.get_node("qif")["weights"]
    assert w.dim() == 4 and (w.dtype == torch.int8) == (coupling == "int8")
    assert tnet.get_node("qif")._args["weights__cols"].dtype == torch.int32


def test_sparse_int8_matches_f32_dynamics():
    # test_sparse.py:133
    n, bs = 128, 32
    A = block_random_connectivity(n, n, 12, block_size=bs, seed=8)
    inp = np.full((800, n), 5.0, dtype=np.float32)
    o32 = _qif("torch", A, n, dtype="float32").run(inp, sampling_steps=10,
                                                    verbose=False).to_numpy("out")
    net8 = _qif("torch", A, n, dtype="float32", coupling_dtype="int8")
    w = net8.get_node("qif")["weights"]
    assert w.dtype == torch.int8 and w.dim() == 4
    o8 = net8.run(inp, sampling_steps=10, verbose=False).to_numpy("out")
    assert o32.max() > 0
    assert np.corrcoef(o32.ravel(), o8.ravel())[0, 1] > 0.999
    with pytest.raises(ValueError):  # the frozen int8 blocks do not train
        _qif("torch", A, n, dtype="float32", coupling_dtype="int8", train_params=["weights"])


def test_sparse_bf16_master_casts_matvec():
    # test_sparse.py:159
    n, bs = 128, 32
    A = block_random_connectivity(n, n, 12, block_size=bs, seed=6)
    inp = np.full((800, n), 5.0, dtype=np.float32)
    o32 = _qif("torch", A, n, dtype="float32").run(inp, sampling_steps=10,
                                                    verbose=False).to_numpy("out")
    net16 = _qif("torch", A, n, dtype="float32", coupling_dtype="bfloat16_master")
    assert net16.get_node("qif")["weights"].dtype == torch.float32  # the master stays
    o16 = net16.run(inp, sampling_steps=10, verbose=False).to_numpy("out")
    assert np.corrcoef(o32.ravel(), o16.ravel())[0, 1] > 0.999
    prepped = net16.get_node("qif").prep_params(net16.get_node("qif").args)
    assert prepped["weights__bf16"].dtype == torch.bfloat16


def test_sparse_refuses_fused_kernels_and_int4():
    # test_sparse.py:122 and test_dsl.py:606
    n, bs = 128, 32
    A = block_random_connectivity(n, n, 8, block_size=bs, seed=5)
    for attach in (attach_generic_fused_step, attach_fused_qif_step):
        net = _qif("torch", A, n, dtype="float32")
        net.compile()
        with pytest.raises(ValueError):
            attach(net.get_node("qif"))
    for coupling in ("int4", "int4_master"):
        with pytest.raises(NotImplementedError, match="dense-only"):
            lower(PREFIX["torch"] + TANH, weights=A, source_var="tanh_op/r",
                  target_var="li_op/r_in", coupling_dtype=coupling, device="cpu")


@pytest.mark.parametrize("coupling", [None, "int8"])
def test_run_batch_sweeps_a_block_coupled_node(coupling):
    # an eta sweep over 3 trials, and a swept block coupling (B, n_br, cb,
    # bs, bs), each trial against its single-trial run (float64)
    n = 64
    A = jsparse.block_random_connectivity(n, n, 8, block_size=16, seed=3)
    inp = np.full((120, 1), 4.0)
    net = _qif("torch", A, n, coupling_dtype=coupling, scale=20.0)
    net.add_func_node("inp", 1, activation_function="identity")
    net.add_edge("inp", "qif", weights=np.ones((n, 1)))
    net.compile()
    base = net.get_node("qif")["qif_sfa_op/eta"].numpy()
    offsets = np.asarray([-1.0, 0.0, 2.0])
    res = net.run_batch(inp, batch_vars={("qif", "eta"): offsets[:, None] + base},
                        record_vars=[("qif", "v", False)], sampling_steps=5)
    for b in (0, 2):
        one = _qif("torch", A, n, coupling_dtype=coupling, scale=20.0, etas=offsets[b] + base)
        one.add_func_node("inp", 1, activation_function="identity")
        one.add_edge("inp", "qif", weights=np.ones((n, 1)))
        want = one.run(inp, sampling_steps=5, verbose=False,
                       record_vars=[("qif", "v", False)]).to_numpy(("qif", "v"))
        np.testing.assert_allclose(res[("qif", "v")][b], want, rtol=1e-9, atol=1e-9)
    if coupling is None:  # a swept coupling: trial 1 at twice the weights
        w = net.get_node("qif")["weights"]
        res = net.run_batch(inp, batch_vars={("qif", "weights"): torch.stack([w, 2 * w])},
                            record_vars=[("qif", "v", False)], sampling_steps=5)
        two = _qif("torch", A, n, scale=40.0)
        two.add_func_node("inp", 1, activation_function="identity")
        two.add_edge("inp", "qif", weights=np.ones((n, 1)))
        want = two.run(inp, sampling_steps=5, verbose=False,
                       record_vars=[("qif", "v", False)]).to_numpy(("qif", "v"))
        np.testing.assert_allclose(res[("qif", "v")][1], want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("coupling", [None, "int8"])
def test_load_jax_params_carries_block_nodes(coupling):
    # the blocks, weights__cols and a frozen int8 coupling's weights__scale
    # cross as they are; a block tensor of another shape raises KeyError
    n = 64
    A = jsparse.block_random_connectivity(n, n, 8, block_size=16, seed=7)
    jnet = _qif("jax", A, n, coupling_dtype=coupling)
    jnet.compile()
    params = jax.tree.map(np.asarray, jnet.parameters_pytree())
    sub = params["nodes"]["qif"]
    sub["weights"] = (sub["weights"] * 3 // 2).astype(sub["weights"].dtype) \
        if coupling == "int8" else sub["weights"] * 1.5
    sub["weights__cols"] = sub["weights__cols"][::-1].copy()
    tnet = _qif("torch", A, n, coupling_dtype=coupling)
    load_jax_params(tnet, params)
    args = tnet.get_node("qif").args
    for key in ("weights", "weights__cols") + (("weights__scale",) if coupling else ()):
        np.testing.assert_array_equal(args[key].numpy(), sub[key])
    inp = np.full((100, n), 5.0)
    jnet2 = _qif("jax", A, n, coupling_dtype=coupling)
    jnet2.compile()
    jnet2.get_node("qif")._args.update({k: jnp.asarray(v) for k, v in sub.items()})
    np.testing.assert_allclose(_run(tnet, inp)[1], _run(jnet2, inp)[1], rtol=1e-9, atol=1e-9)
    bad = jax.tree.map(np.asarray, jnet.parameters_pytree())
    bad["nodes"]["qif"]["weights"] = bad["nodes"]["qif"]["weights"][:2]
    with pytest.raises(KeyError, match="shape"):
        load_jax_params(_qif("torch", A, n, coupling_dtype=coupling), bad)


# -------------------------------------------------------------- the native sampler
def test_native_compiles_and_samples():
    # test_native.py:8; the port builds into its own _build/ directory
    lib = load_native("connectivity")
    if lib is None:
        pytest.skip("no C++ toolchain in this environment")
    from rectipy_tpu_torch.native.build import BUILD_DIR

    assert os.path.dirname(lib._name) == BUILD_DIR
    n, m, k = 50, 200, 20
    cols = sample_fixed_fanin(n, m, k, seed=7)
    assert cols.shape == (n, k) and cols.min() >= 0 and cols.max() < m
    for row in cols:
        assert len(set(row.tolist())) == k
    np.testing.assert_array_equal(cols, sample_fixed_fanin(n, m, k, seed=7))
    assert not np.array_equal(cols, sample_fixed_fanin(n, m, k, seed=8))
    counts = np.bincount(sample_fixed_fanin(2000, m, k, seed=1).ravel(), minlength=m)
    assert counts.min() > 0
    for force in (False, True):  # the same sample as the JAX package's
        np.testing.assert_array_equal(sample_fixed_fanin(n, m, k, seed=3, force_numpy=force),
                                      jsample(n, m, k, seed=3, force_numpy=force))


def test_numpy_fallback_matches_contract():
    # test_native.py:31
    cols = sample_fixed_fanin(10, 50, 5, seed=3, force_numpy=True)
    assert cols.shape == (10, 5)
    for row in cols:
        assert len(set(row.tolist())) == 5
    with pytest.raises(ValueError):  # test_native.py:45
        sample_fixed_fanin(4, 3, 5)


def test_random_connectivity_native_backend(monkeypatch):
    # test_native.py:38; a user rng seeds the native sampler from its stream,
    # as in the JAX package, so both give the same matrix
    C = tutility.random_connectivity(64, 64, 0.25, normalize=True, backend="native")
    assert C.shape == (64, 64)
    np.testing.assert_allclose(C.sum(axis=1), 1.0)
    assert ((C > 0).sum(axis=1) == 16).all()
    for backend in ("native", "numpy", "auto"):
        np.testing.assert_array_equal(
            tutility.random_connectivity(40, 30, 0.2, rng=np.random.default_rng(4),
                                         backend=backend),
            jutility.random_connectivity(40, 30, 0.2, rng=np.random.default_rng(4),
                                         backend=backend))
    # auto takes the native sampler for n*m >= 1e7 without an rng
    from rectipy_tpu_torch import native

    calls = []
    real = native.sample_fixed_fanin
    monkeypatch.setattr(native, "sample_fixed_fanin",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    C = tutility.random_connectivity(3200, 3200, 0.002)
    assert len(calls) == 1 and ((C > 0).sum(axis=1) == 6).all()
    tutility.random_connectivity(3200, 3200, 0.002, rng=np.random.default_rng(0))
    tutility.random_connectivity(100, 100, 0.1)
    assert len(calls) == 1
