"""The port's int4 couplings (``'int4'``, ``'int4_master'``) and the
``'bfloat16_master'`` coupling against the JAX package, and its packed int4
matvec against the packed-int4 Pallas kernel of
``benchmarks/i4pack_microbench.py``.  CPU, float64 unless stated, inputs from
numpy seeds; the CUDA kernels' plain versions run here.  The cases mirror
``tests/test_dsl.py`` and ``tests/test_bptt_fast.py``."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.dsl.lower import lower as j_lower
from rectipy_tpu.ops import quant as jq
from rectipy_tpu.ops.bptt import make_coupled_traj as j_make_traj
from rectipy_tpu_torch import Network, RateNet, load_jax_params
from rectipy_tpu_torch.dsl.lower import lower
from rectipy_tpu_torch.ops import quant as tq
from rectipy_tpu_torch.ops.bptt import make_coupled_traj

J, T_ = "neuron_model_templates.", "rectipy_tpu_torch.models."
TANH = "rate_neurons.leaky_integrator.tanh"
QIF = "spiking_neurons.qif.qif"
MICROBENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "benchmarks", "i4pack_microbench.py")


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)


def _jnp_tree(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def _i4pack_pallas():
    """``make_i4pack_matvec`` taken out of the microbenchmark with ``ast``:
    importing the file would run the benchmark."""
    with open(MICROBENCH) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "make_i4pack_matvec")
    ns = {"jax": jax, "jnp": jnp, "np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), MICROBENCH, "exec"), ns)
    return ns["make_i4pack_matvec"]


# ------------------------------------------------------------------ kernels
def test_pallas_i4pack_matvec_equals_the_ports_packed_matvec():
    # the TPU kernel in interpret mode at n=1024, tile 256, on the
    # microbenchmark's own inputs (weights in [-8, 7], x in [-127, 127], seed
    # 0): its sums are exact, and so are the port's, so they are equal; and
    # the port's packing is the Pallas packing transposed, byte for byte
    n = 1024
    mv, pack = _i4pack_pallas()(n, 256, interpret=True)
    rng = np.random.default_rng(0)
    wt = rng.integers(-8, 8, size=(n, n)).astype(np.int32)
    x = rng.integers(-127, 128, size=n).astype(np.int32)
    got = np.asarray(mv(jnp.asarray(x[0::2]), jnp.asarray(x[1::2]), jnp.asarray(pack(wt))))
    wp = tq.pack_int4(_t(wt.T).to(torch.int8))
    port = _np(tq.int4_dot_plain(wp, _t(x).to(torch.int8)))
    np.testing.assert_array_equal(port, got)
    np.testing.assert_array_equal(got, x.astype(np.float64) @ wt.astype(np.float64))
    assert wp.shape == (n, tq.int4_stride(n)) and wp.dtype == torch.uint8
    np.testing.assert_array_equal(_np(wp)[:, :n // 2], pack(wt).T)
    # the plain transposed product of the same packed weights
    np.testing.assert_array_equal(_np(tq.int4_dot_t_plain(wp, _t(x).to(torch.int8), n)),
                                  x.astype(np.float64) @ wt.T.astype(np.float64))


@pytest.mark.parametrize("n_out,n_in", [(7, 9), (5, 1), (3, 32), (4, 10_000)])
def test_pack_int4_layout_and_padding(n_out, n_in):
    # rows padded to a multiple of 16 bytes with zero weights (nibbles 8);
    # unpack inverts pack over the full nibble range
    rng = np.random.default_rng(n_in)
    w = rng.integers(-8, 8, size=(n_out, n_in)).astype(np.int8)
    wp = tq.pack_int4(_t(w))
    stride = tq.int4_stride(n_in)
    assert wp.shape == (n_out, stride) and stride % 16 == 0 and stride >= (n_in + 1) // 2
    np.testing.assert_array_equal(_np(tq.unpack_int4(wp, n_in)), w)
    full = _np(tq.unpack_int4(wp, 2 * stride))
    assert np.all(full[:, n_in:] == 0)
    lo, hi = _np(wp)[0, 0] & 15, _np(wp)[0, 0] >> 4
    assert lo == w[0, 0] + 8 and hi == (w[0, 1] + 8 if n_in > 1 else 8)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_quantize_rows_i4_and_int4_products_match_jax(dtype):
    # quantize_rows_i4: int8 carriers and float32 scales equal (the same
    # casts, round half to even); the int4 sums are exact on both sides and
    # the epilogues multiply in float32 in the same order: all equal
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(23, 40)) * 0.3).astype(dtype)
    w[3] = 0.0  # an all-zero row takes the 1e-30 floor
    x, d = rng.normal(size=40).astype(dtype), rng.normal(size=23).astype(dtype)
    jwq, jws = jq.quantize_rows_i4(jnp.asarray(w))
    twq, tws = tq.quantize_rows_i4(_t(w))
    np.testing.assert_array_equal(_np(twq), np.asarray(jwq))
    np.testing.assert_array_equal(_np(tws), np.asarray(jws))
    assert twq.dtype == torch.int8 and tws.dtype == torch.float32
    assert int(twq.abs().max()) <= 7
    jp = jq._i4_prep(jnp.asarray(w))
    tp = tq._i4_prep(_t(w))
    np.testing.assert_array_equal(_np(tq.unpack_int4(tp[0], 40)), np.asarray(jp[0], np.int8))
    jxq = jq.quant_vec(jnp.asarray(x))[0]
    np.testing.assert_array_equal(_np(tq.int4_dot_plain(tp[0], _t(np.asarray(jxq)))),
                                  np.asarray(jq.int4_dot(jp[0], jxq)))
    jvq = jq.quant_vec(jnp.asarray(d))[0]
    np.testing.assert_array_equal(_np(tq.int4_dot_t_plain(tp[0], _t(np.asarray(jvq)), 40)),
                                  np.asarray(jq.int4_dot_t(jp[0], jvq)))
    np.testing.assert_array_equal(_np(tq._mv4_prepped(tp, _t(x))),
                                  np.asarray(jq._mv4_prepped(jp, jnp.asarray(x))))
    np.testing.assert_array_equal(_np(tq._mv4_t_prepped(tp, _t(d))),
                                  np.asarray(jq._mv4_t_prepped(jp, jnp.asarray(d))))


def test_int4_wrappers_on_cpu_take_the_plain_version():
    # no launch is counted for CPU tensors; the epilogue is JAX's order
    rng = np.random.default_rng(8)
    wp = tq.pack_int4(_t(rng.integers(-8, 8, size=(6, 11))).to(torch.int8))
    xq = _t(rng.integers(-127, 128, size=11)).to(torch.int8)
    vq = _t(rng.integers(-127, 128, size=6)).to(torch.int8)
    rs, s = _t(rng.random(6)).float(), torch.tensor(0.37, dtype=torch.float32)
    before = (tq.int4_mv.launches, tq.int4_mv_t.launches)
    assert torch.equal(tq.int4_mv(wp, xq, rs, s), (tq.int4_dot_plain(wp, xq) * rs) * s)
    assert torch.equal(tq.int4_mv_t(wp, vq, s, 11), tq.int4_dot_t_plain(wp, vq, 11) * s)
    assert (tq.int4_mv.launches, tq.int4_mv_t.launches) == before


def test_int4_fan_in_guards(monkeypatch):
    # test_dsl.py:664: the couplings' [-7, 7] bound as in JAX, the kernels'
    # [-8, 7] bound below it; the lowering refuses a fan-in at the bound
    assert tq.INT4_DOT_MAX_FAN_IN == jq.INT4_DOT_MAX_FAN_IN == (2**31 - 1) // (7 * 127)
    assert tq.INT4_MV_MAX_FAN_IN == (2**31 - 1) // (8 * 127) < tq.INT4_DOT_MAX_FAN_IN
    # the plain sums stay exact past 2^24, where float32 accumulation rounds
    n_in = 20_000
    wp = tq.pack_int4(torch.full((2, n_in), -8, dtype=torch.int8))
    xq = torch.full((n_in,), -127, dtype=torch.int8)
    xq[0] = 126
    exact = 8 * 127 * (n_in - 1) - 8 * 126
    assert exact > 2 ** 24
    assert float(tq.int4_dot_plain(wp, xq)[0]) == float(np.float32(exact))
    n = 32
    W = np.ones((n, n), dtype=np.float32) * 0.1
    monkeypatch.setattr(tq, "INT4_DOT_MAX_FAN_IN", n)
    for cd in ("int4", "int4_master"):
        with pytest.raises(ValueError, match="overflow"):
            lower(T_ + TANH, weights=W, source_var="tanh_op/r", target_var="li_op/r_in",
                  coupling_dtype=cd, device="cpu")


# ----------------------------------------------------------------- couplings
def _lower_pair(coupling, W, dtype, seed_dtype=None):
    kw = dict(weights=W, source_var="tanh_op/r", target_var="li_op/r_in")
    vj = j_lower(J + TANH, dtype=jnp.float64 if dtype == torch.float64 else jnp.float32,
                 coupling_dtype=coupling, **kw)
    vt = lower(T_ + TANH, dtype=dtype, coupling_dtype=coupling, device="cpu", **kw)
    return vj, vt


def test_frozen_int4_coupling_matches_jax():
    # test_dsl.py:545: an int8 carrier of [-7, 7] plus row scales; prep_args
    # packs it; the lowered field equals JAX's at float64 from the same
    # carrier and scales (exact integer sums, the same casts), prepped and
    # unprepped alike
    n = 16
    rng = np.random.default_rng(30)
    W = rng.normal(size=(n, n)) * 0.2
    vj, vt = _lower_pair("int4", W, torch.float64)
    assert vt.args["weights"].dtype == torch.int8 and int(vt.args["weights"].abs().max()) <= 7
    np.testing.assert_array_equal(_np(vt.args["weights"]), np.asarray(vj.args["weights"]))
    # the build-time quantization of the float32 weights: scales within one
    # float32 ulp (XLA's compiled division by 7 may round otherwise)
    np.testing.assert_allclose(_np(vt.args["weights__scale"]),
                               np.asarray(vj.args["weights__scale"]), rtol=2.0 ** -23, atol=0)
    args = dict(vt.args, weights__scale=_t(vj.args["weights__scale"]))
    prepped = vt.prep_args(args)
    assert prepped["weights__q4"].dtype == torch.uint8
    assert torch.equal(prepped["weights__q4"], tq.pack_int4(vt.args["weights"]))
    y = rng.normal(size=(n,))
    d_j = np.asarray(vj.func(0.0, jnp.asarray(y), vj.prep_args(vj.args)))
    d_t = _np(vt.func(0.0, _t(y), args))  # in-body packing
    d_tp = _np(vt.func(0.0, _t(y), prepped))
    np.testing.assert_array_equal(d_t, d_tp)
    np.testing.assert_allclose(d_tp, d_j, rtol=1e-12, atol=1e-15)
    assert vt.coupling_cast is None


def test_frozen_int4_source_gradient_matches_jax():
    # the straight-through source gradient (_int4_matvec's JVP) against
    # jax.grad.  float32: JAX's custom JVP refuses float64 sources (its
    # tangent is float64 where the int32 sum's float32 primal wants float32),
    # so this is float32 on both sides; the float32 sums of W^T @ g run in
    # another order: rtol 1e-6
    n = 16
    rng = np.random.default_rng(31)
    W = rng.normal(size=(n, n)) * 0.2
    vj, vt = _lower_pair("int4", W, torch.float32)
    args = vt.prep_args(dict(vt.args, weights__scale=_t(vj.args["weights__scale"])))
    y = rng.normal(size=(n,)).astype(np.float32)
    g_j = np.asarray(jax.grad(lambda yy: jnp.sum(vj.func(0.0, yy, vj.prep_args(vj.args)) ** 2))(
        jnp.asarray(y)))
    yt = _t(y).requires_grad_(True)
    (g_t,) = torch.autograd.grad((vt.func(0.0, yt, args) ** 2).sum(), yt)
    assert np.abs(g_j).max() > 0, "gradient vanished through the int4 coupling"
    np.testing.assert_allclose(_np(g_t), g_j, rtol=1e-6, atol=1e-6 * np.abs(g_j).max())


def test_frozen_int4_refusals():
    # training the frozen weights is refused with guidance (test_dsl.py:596);
    # an int4 block-sparse coupling is refused as dense-only (test_dsl.py:606)
    from rectipy_tpu.ops.sparse import BlockSparseCoupling

    W = np.eye(8) * 0.5
    with pytest.raises(ValueError, match="quantized"):
        RateNet.from_pyrates(T_ + TANH, weights=W, source_var="tanh_op/r",
                             target_var="li_op/r_in", input_var="li_op/I_ext",
                             output_var="li_op/v", coupling_dtype="int4",
                             train_params=["weights"], device="cpu")
    blocks = np.random.default_rng(0).normal(size=(2, 1, 4, 4)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="dense-only"):
        lower(T_ + TANH, weights=BlockSparseCoupling(blocks, np.asarray([[0], [1]])),
              source_var="tanh_op/r", target_var="li_op/r_in", coupling_dtype="int4",
              device="cpu")


def _rate_net(cls, prefix, coupling, W, dtype, train=True):
    net = cls(1e-2, dtype=dtype, **({"device": "cpu"} if cls is Network else {}))
    net.add_diffeq_node("rnn", prefix + TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r", target_var="li_op/r_in",
                        train_params=["weights"] if train else None, coupling_dtype=coupling)
    net.compile()
    return net


def test_int4_master_run_prep_hoisted_bit_identical():
    # test_dsl.py:618: run() packs the quantized master once (prep_params);
    # the prepped matvec is bit-identical to the per-step STE matvec of the
    # unprepped step; the frozen int4 network follows the same trajectory up
    # to its float64 activation scale (quant_vec rounds its scale to float32),
    # rtol 1e-5 as the JAX test allows; and the run equals JAX's (the same
    # integers, float64 dynamics in another order)
    n = 32
    rng = np.random.default_rng(31)
    W = rng.normal(size=(n, n)) / np.sqrt(n)
    inp = rng.normal(size=(40, 1))
    net = _rate_net(Network, T_, "int4_master", W, torch.float64, train=False)
    calls = []
    orig = tq.quantize_rows_i4
    tq.quantize_rows_i4 = lambda w: calls.append(tuple(w.shape)) or orig(w)
    try:
        out = net.run(inp, record_output=True, verbose=False).to_numpy("out")
    finally:
        tq.quantize_rows_i4 = orig
    assert calls == [(n, n)]
    node = _rate_net(Network, T_, "int4_master", W, torch.float64, train=False).get_node("rnn")
    step = node.make_step()
    y, args = node.y, dict(node.args)
    ref = []
    for t in range(inp.shape[0]):
        y, o = step(y, args, _t(inp[t]).expand(n))
        ref.append(_np(o))
    np.testing.assert_array_equal(out, np.stack(ref))
    frozen = _rate_net(Network, T_, "int4", W, torch.float64, train=False)
    out_frozen = frozen.run(inp, record_output=True, verbose=False).to_numpy("out")
    np.testing.assert_allclose(out_frozen, out, rtol=1e-5, atol=1e-7)
    j_out = _rate_net(JNetwork, J, "int4_master", W, jnp.float64, train=False).run(
        inp, record_output=True, verbose=False).to_numpy("out")
    np.testing.assert_allclose(out, j_out, rtol=1e-12, atol=1e-14)


def test_int4_master_traj_forward_and_grad_parity():
    # test_bptt_fast.py:1100: the deferred trajectory's quantized forward is
    # bit-identical to the composed step and equal to JAX's to float64
    # rounding; its gradients match JAX's trajectory (both round dW to
    # float32: 2e-7 of the largest entry, as the int8_master case of
    # test_torch_bptt.py) and the port's plain autograd through the same STE
    # (the JAX test's 2e-5 of the largest entry)
    n, T = 12, 300
    rng = np.random.default_rng(34)
    W0 = rng.normal(size=(n, n)) * 0.3
    xs_np, tgt_np = rng.normal(size=(T, n)), rng.normal(size=(T, n))
    jnet = _rate_net(JNetwork, J, "int4_master", W0, jnp.float64)
    tnet = _rate_net(Network, T_, "int4_master", W0, torch.float64)
    jtraj, wkeys = j_make_traj(jnet.get_node("rnn"))
    jargs = jnet.parameters_pytree()["nodes"]["rnn"]
    jrest = {k: v for k, v in jargs.items() if k not in wkeys}
    jy0 = jnet.init_state()["nodes"]["rnn"]

    def jloss(Wd):
        return jnp.mean((jtraj(Wd, jrest, jy0, jnp.asarray(xs_np))[1] - tgt_np) ** 2)

    j_outs = np.asarray(jtraj({k: jargs[k] for k in wkeys}, jrest, jy0, jnp.asarray(xs_np))[1])
    jg = jax.grad(jloss)({k: jargs[k] for k in wkeys})

    traj, twkeys = make_coupled_traj(tnet.get_node("rnn"))
    assert twkeys == wkeys
    targs = tnet.parameters_pytree()["nodes"]["rnn"]
    assert all(targs[k].dtype == torch.float64 for k in wkeys), "int4_master stores the master"
    rest = {k: v for k, v in targs.items() if k not in wkeys}
    Wd = {k: targs[k].clone().requires_grad_(True) for k in wkeys}
    y0, xs, tgt = tnet.init_state()["nodes"]["rnn"], _t(xs_np), _t(tgt_np)
    _, outs = traj(Wd, rest, y0, xs)
    g = torch.autograd.grad(torch.mean((outs - tgt) ** 2), list(Wd.values()))
    step = tnet.make_step()
    st, p, outs_std = {"nodes": {"rnn": y0}, "edges": {}}, {"nodes": {"rnn": {**rest, **Wd}},
                                                            "edges": {}}, []
    for x in xs.unbind(0):
        st, out, _ = step(st, p, x)
        outs_std.append(out)
    outs_std = torch.stack(outs_std)
    g_std = torch.autograd.grad(torch.mean((outs_std - tgt) ** 2), list(Wd.values()))
    assert torch.equal(outs.detach(), outs_std.detach())
    np.testing.assert_allclose(_np(outs), j_outs, rtol=1e-9, atol=1e-12)
    for i, wk in enumerate(wkeys):
        a, b, c = _np(g[i]), np.asarray(jg[wk]), _np(g_std[i])
        assert np.abs(b).max() > 0, "zero weight gradient -> test is vacuous"
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-7 * np.abs(b).max())
        np.testing.assert_allclose(a, c, rtol=0, atol=2e-5 * np.abs(c).max())


def _fit(net, inp, tgt, epochs, **kw):
    obs = net.fit_bptt([inp] * epochs, [tgt] * epochs, verbose=False, **kw)
    return np.asarray(obs["epoch_loss"]), np.asarray(net.get_node("rnn")["weights"])


def test_fit_bptt_int4_master_matches_jax():
    # test_bptt_fast.py:1170 against JAX, under test_torch_fit_bptt.py's
    # tolerances (losses rtol 1e-9, weights rtol 1e-6, atol 1e-10: dW's
    # float32 rounding over the adam steps); the port's chain trajectory and
    # plain autograd as the JAX test holds its two paths
    n, T = 10, 150
    rng = np.random.default_rng(35)
    W0 = rng.normal(size=(n, n)) * 0.3
    inp, tgt = rng.normal(size=(T, n)), rng.normal(size=(T, n)) * 0.2
    kw = dict(optimizer="adam", lr=1e-2)
    l_j, w_j = _fit(_rate_net(JNetwork, J, "int4_master", W0, jnp.float64), inp, tgt, 10, **kw)
    tnet = _rate_net(Network, T_, "int4_master", W0, torch.float64)
    l_t, w_t = _fit(tnet, inp, tgt, 10, **kw)
    assert tnet.last_fit == {"trajectory": "chain", "fused_adam": False}
    pnet = _rate_net(Network, T_, "int4_master", W0, torch.float64)
    l_p, w_p = _fit(pnet, inp, tgt, 10, fused_bptt=False, **kw)
    assert pnet.last_fit["trajectory"] == "autograd"
    np.testing.assert_allclose(l_t, l_j, rtol=1e-9)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(l_t, l_p, rtol=1e-7)
    np.testing.assert_allclose(w_t, w_p, rtol=1e-4, atol=1e-8)
    assert l_t[-1] < l_t[0], "int4_master training did not reduce the loss"
    assert np.abs(w_t - W0).max() > 1e-5, "master weights did not move"


def test_bfloat16_master_coupling_matches_jax():
    # test_dsl.py:354: the float32 master stays float32 and trains; the
    # forward is the bf16 matvec with float32 sums (equal to JAX's up to the
    # order of the float32 sums, rtol 2e-6 as test_torch_dsl.py's bf16
    # case); its master gradient against jax.grad, and the prepped run form
    # equal to the cast in the body
    n = 8
    rng = np.random.default_rng(12)
    W = rng.normal(size=(n, n)) * 0.2
    vj, vt = _lower_pair("bfloat16_master", W, torch.float32)
    assert vt.args["weights"].dtype == torch.float32 and vt.coupling_cast == "bf16"
    y = rng.normal(size=(n,)).astype(np.float32)
    d_j = np.asarray(vj.func(0.0, jnp.asarray(y), vj.args))
    d_t = _np(vt.func(0.0, _t(y), vt.args))
    np.testing.assert_allclose(d_t, d_j, rtol=2e-6, atol=1e-7)
    assert torch.equal(vt.func(0.0, _t(y), vt.prep_args(vt.args)), _t(d_t))

    def jloss(w):
        return jnp.sum(vj.func(0.0, jnp.asarray(y), dict(vj.args, weights=w)) ** 2)

    g_j = np.asarray(jax.grad(jloss)(vj.args["weights"]))
    w = vt.args["weights"].clone().requires_grad_(True)
    (g_t,) = torch.autograd.grad((vt.func(0.0, _t(y), dict(vt.args, weights=w)) ** 2).sum(), w)
    assert g_t.dtype == torch.float32 and float(g_t.abs().max()) > 0
    # the gradient reaches the master through the bf16 cast: both round the
    # outer product to bf16, whose ulp bounds the difference
    np.testing.assert_allclose(_np(g_t), g_j, rtol=2.0 ** -7, atol=1e-6)
    vf32 = lower(T_ + TANH, weights=W, source_var="tanh_op/r", target_var="li_op/r_in",
                 dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(d_t, _np(vf32.func(0.0, _t(y), vf32.args)), rtol=3e-2, atol=3e-2)


def test_fit_bptt_bfloat16_master_matches_jax():
    # a short bfloat16_master fit through both packages' trajectories (bf16
    # matvecs, dW on bf16-rounded deltas and sources with float32 sums),
    # under test_torch_fit_bptt.py's tolerances (losses rtol 1e-9, weights
    # rtol 1e-6, atol 1e-10)
    n, T = 10, 120
    rng = np.random.default_rng(37)
    W0 = rng.normal(size=(n, n)) * 0.3
    inp, tgt = rng.normal(size=(T, n)), rng.normal(size=(T, n)) * 0.2
    kw = dict(optimizer="adam", lr=1e-2)
    l_j, w_j = _fit(_rate_net(JNetwork, J, "bfloat16_master", W0, jnp.float64), inp, tgt, 6,
                    **kw)
    tnet = _rate_net(Network, T_, "bfloat16_master", W0, torch.float64)
    l_t, w_t = _fit(tnet, inp, tgt, 6, **kw)
    assert tnet.last_fit["trajectory"] == "chain"
    np.testing.assert_allclose(l_t, l_j, rtol=1e-9)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-6, atol=1e-10)
    assert l_t[-1] < l_t[0], "bfloat16_master training did not reduce the loss"


@pytest.mark.parametrize("coupling", ["int4", "int4_master", "bfloat16_master"])
def test_load_jax_params_carries_the_coupling(coupling):
    # the carrier and its scales (int4) or the float master: copied as they
    # are, so the port's run from them equals JAX's (float64; the integer
    # sums exact, the bf16 products exact, float32 sums in another order)
    n = 12
    rng = np.random.default_rng(40)
    W = rng.normal(size=(n, n)) * 0.3
    jnet = _rate_net(JNetwork, J, coupling, W, jnp.float64, train=False)
    tnet = _rate_net(Network, T_, coupling, rng.normal(size=(n, n)), torch.float64, train=False)
    jparams = _jnp_tree(jnet.parameters_pytree())
    load_jax_params(tnet, jparams, _jnp_tree(jnet.init_state()))
    targs = tnet.parameters_pytree()["nodes"]["rnn"]
    for key in ("weights", "weights__scale") if coupling == "int4" else ("weights",):
        np.testing.assert_array_equal(_np(targs[key]), jparams["nodes"]["rnn"][key])
    assert targs["weights"].dtype == (torch.int8 if coupling == "int4" else torch.float64)
    # a prepped key is never copied
    with_prep = {"nodes": {"rnn": dict(jparams["nodes"]["rnn"], weights__q=np.zeros(1))}}
    load_jax_params(tnet, with_prep)
    assert "weights__q" not in tnet.get_node("rnn").args
    inp = rng.normal(size=(60, n))
    kw = dict(record_output=True, sampling_steps=3, verbose=False)
    rtol = 1e-6 if coupling == "bfloat16_master" else 1e-12
    np.testing.assert_allclose(tnet.run(inp, **kw).to_numpy("out"),
                               jnet.run(inp, **kw).to_numpy("out"), rtol=rtol, atol=1e-12)
