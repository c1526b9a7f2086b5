"""The port's int8 coupling (``ops/quant.py``), fused adam + requantize
(``ops/fused_opt.py``) and the int8 couplings of ``Network.run`` against the
JAX package.  CPU, float64 unless stated, inputs from numpy seeds; the CUDA
kernels' plain versions run here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.ops import fused_opt as jfo
from rectipy_tpu.ops import quant as jq
from rectipy_tpu_torch import Network, load_jax_params
from rectipy_tpu_torch.ops import fused_opt as tfo
from rectipy_tpu_torch.ops import quant as tq

QIF_J = "neuron_model_templates.spiking_neurons.qif.qif"
QIF_T = "rectipy_tpu_torch.models.spiking_neurons.qif.qif"


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_quantizers_and_int8_products_match_jax(dtype):
    # quantize_rows/quant_vec: int8 values and float32 scales equal (the same
    # casts, round half to even); the int8 products sum exactly on both sides,
    # and _mv(_t)_prepped multiply in float32 in the same order: all equal
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(23, 40)) * 0.3).astype(dtype)
    w[3] = 0.0  # an all-zero row takes the 1e-30 floor
    x = rng.normal(size=40).astype(dtype)
    d = rng.normal(size=23).astype(dtype)
    jwq, jws = jq.quantize_rows(jnp.asarray(w))
    twq, tws = tq.quantize_rows(_t(w))
    np.testing.assert_array_equal(_np(twq), np.asarray(jwq))
    np.testing.assert_array_equal(_np(tws), np.asarray(jws))
    assert twq.dtype == torch.int8 and tws.dtype == torch.float32
    jxq, jxs = jq.quant_vec(jnp.asarray(x))
    txq, txs = tq.quant_vec(_t(x))
    np.testing.assert_array_equal(_np(txq), np.asarray(jxq))
    assert float(txs) == float(jxs) and txs.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq.int8_dot(twq, txq)), np.asarray(jq.int8_dot(jwq, jxq)))
    jvq = jq.quant_vec(jnp.asarray(d))[0]
    np.testing.assert_array_equal(_np(tq.int8_dot_t(twq, _t(np.asarray(jvq)))),
                                  np.asarray(jq.int8_dot_t(jwq, jvq)))
    np.testing.assert_array_equal(_np(tq._mv_prepped((twq, tws), _t(x))),
                                  np.asarray(jq._mv_prepped((jwq, jws), jnp.asarray(x))))
    np.testing.assert_array_equal(_np(tq._mv_t_prepped((twq, tws), _t(d))),
                                  np.asarray(jq._mv_t_prepped((jwq, jws), jnp.asarray(d))))
    assert tq._mv_prepped((twq, tws), _t(x)).dtype == _t(x).dtype


def test_int8_dot_plain_is_exact_at_the_fan_in_limit_scale():
    # sums past 2^24 (where float32 accumulation would round) stay exact
    n_in = 4096
    wq = torch.full((3, n_in), 127, dtype=torch.int8)
    xq = torch.full((n_in,), 127, dtype=torch.int8)
    xq[0] = 126
    exact = 127 * 127 * (n_in - 1) + 127 * 126
    assert exact > 2 ** 24
    assert float(tq.int8_dot_plain(wq, xq)[0]) == float(np.float32(exact))
    assert tq.INT8_DOT_MAX_FAN_IN == jq.INT8_DOT_MAX_FAN_IN


def test_int8_master_matvec_gradients_match_jax():
    # the STE custom VJP: dW = outer(g, src), dsrc = _mv_t(W, g)
    rng = np.random.default_rng(1)
    w, src, c = rng.normal(size=(12, 9)), rng.normal(size=9), rng.normal(size=12)
    jg = jax.grad(lambda w_, s_: jnp.sum(jq.int8_master_matvec(w_, s_) * c),
                  argnums=(0, 1))(jnp.asarray(w), jnp.asarray(src))
    tw, ts = _t(w).requires_grad_(True), _t(src).requires_grad_(True)
    out = tq.int8_master_matvec(tw, ts)
    np.testing.assert_array_equal(_np(out), np.asarray(jq.int8_master_matvec(
        jnp.asarray(w), jnp.asarray(src))))
    gw, gs = torch.autograd.grad((out * _t(c)).sum(), (tw, ts))
    np.testing.assert_array_equal(_np(gw), np.asarray(jg[0]))
    np.testing.assert_array_equal(_np(gs), np.asarray(jg[1]))


@pytest.mark.parametrize("count", [1, 7])
def test_adam_requant_plain_matches_jax_xla(count):
    # the one-pass adam + requantize against adam_requant_xla, bias
    # corrections from the same float32 formula on both sides: equal
    rng = np.random.default_rng(2)
    w, m, g = (rng.normal(size=(9, 14)) * s for s in (0.1, 0.01, 1.0))
    v = rng.random((9, 14)) * 1e-2
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    bc1, bc2 = tfo.bias_corrections(count, 0.9, 0.999)
    cf = jnp.float32(count)
    assert (bc1, bc2) == (float(1.0 - 0.9 ** cf), float(1.0 - 0.999 ** cf))
    ref = jfo.adam_requant_xla(*(jnp.asarray(a) for a in (w, m, v, g)), jnp.float32(bc1),
                               jnp.float32(bc2), jnp.float64(1e-3), **kw)
    got = tfo.adam_requant_plain(*(_t(a) for a in (w, m, v, g)), bc1, bc2, 1e-3, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # the wrapper takes the plain version for CPU tensors (no launch counted)
    before = tfo.adam_requant.launches
    for a, b in zip(tfo.adam_requant(*(_t(a) for a in (w, m, v, g)), bc1, bc2, 1e-3, **kw),
                    got):
        assert torch.equal(a, b)
    assert tfo.adam_requant.launches == before


def _qif_pair(coupling, n=24, seed=3, f32=False, train_params=None):
    rng = np.random.default_rng(seed)
    W = np.abs(rng.normal(size=(n, n))) * 0.5
    etas = (2.0 + rng.random(n) * 4.0).astype(np.float32 if f32 else np.float64)
    nets = []
    for cls, tmpl, kw in ((JNetwork, QIF_J, dict(dtype=jnp.float32 if f32 else jnp.float64)),
                          (Network, QIF_T, dict(dtype=torch.float32 if f32 else torch.float64,
                                                device="cpu"))):
        net = cls(5e-3, **kw)
        net.add_diffeq_node("rnn", tmpl, weights=W, input_var="I_ext", output_var="s",
                            source_var="s", target_var="s_in", op="qif_op", spike_var="spike",
                            spike_def="v", spike_threshold=100.0, spike_reset=-100.0,
                            node_vars={"all/qif_op/eta": etas}, coupling_dtype=coupling,
                            train_params=train_params, dtype=kw["dtype"])
        net.compile()
        nets.append(net)
    return nets


def _jnp_tree(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


@pytest.mark.parametrize("coupling", ["int8", "int8_master"])
def test_int8_coupled_run_matches_jax(coupling):
    # a short spiking run: frozen int8 (quantized at build, scaled by JAX's
    # own activation-scale casts) and int8_master (quantized once per run by
    # prep_params); float64 on both sides, the int8 sums exact: equal to
    # rounding of the elementwise float64 arithmetic
    jnet, tnet = _qif_pair(coupling)
    jparams, tparams = jnet.parameters_pytree(), tnet.parameters_pytree()
    if coupling == "int8":
        # the build-time quantization of the float32 weights: int8 values
        # equal, scales within one float32 ulp (XLA's compiled division by
        # 127 rounds differently from the eager division now and then)
        np.testing.assert_array_equal(_np(tparams["nodes"]["rnn"]["weights"]),
                                      np.asarray(jparams["nodes"]["rnn"]["weights"]))
        np.testing.assert_allclose(_np(tparams["nodes"]["rnn"]["weights__scale"]),
                                   np.asarray(jparams["nodes"]["rnn"]["weights__scale"]),
                                   rtol=2.0 ** -23, atol=0.0)
        assert tparams["nodes"]["rnn"]["weights"].dtype == torch.int8
        load_jax_params(tnet, _jnp_tree(jparams))  # run from the same scales
    else:
        assert tparams["nodes"]["rnn"]["weights"].dtype == torch.float64
    inp = np.random.default_rng(4).normal(size=(300, 24)) * 3.0
    kw = dict(sampling_steps=3, record_vars=[("rnn", "v", False)], verbose=False)
    jo, to = jnet.run(inp, **kw), tnet.run(inp, **kw)
    assert jo.to_numpy("out").max() > 0.0, "no spikes -- weak test"
    np.testing.assert_allclose(to.to_numpy("out"), jo.to_numpy("out"), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(to.to_numpy(("rnn", "v")), jo.to_numpy(("rnn", "v")),
                               rtol=1e-9, atol=1e-9)
    # load_jax_params carries the int8 pair / the master across
    _, tnet2 = _qif_pair(coupling, seed=5)
    load_jax_params(tnet2, _jnp_tree(jparams), _jnp_tree(jnet.init_state()))
    for key, val in tnet.parameters_pytree()["nodes"]["rnn"].items():
        assert torch.equal(tnet2.parameters_pytree()["nodes"]["rnn"][key], val)


def test_int8_master_run_quantizes_once_per_run():
    _, tnet = _qif_pair("int8_master", n=8)
    calls = []
    orig = tq.quantize_rows

    def counting(w):
        calls.append(tuple(w.shape))
        return orig(w)

    tq.quantize_rows = counting
    try:
        tnet.run(np.ones((50, 8)), verbose=False)
    finally:
        tq.quantize_rows = orig
    assert calls == [(8, 8)]


def test_frozen_int8_coupling_refuses_training():
    # the frozen int8 weights cannot train; eta trains through the coupling
    # with the JAX package's straight-through source gradient, through plain
    # autograd on both sides (the trajectory takes no frozen coupling).
    # float32: JAX's custom JVP refuses float64 sources; the float32 sums run
    # in other orders, so the losses and the trained eta agree to rtol 1e-6
    _, tnet = _qif_pair("int8", n=8)
    with pytest.raises(ValueError, match="frozen-quantized"):
        tnet.add_diffeq_node("q2", QIF_T, weights=np.eye(8), input_var="I_ext", output_var="s",
                             source_var="s", target_var="s_in", op="qif_op",
                             spike_var="spike", spike_def="v", coupling_dtype="int8",
                             train_params=["weights"])
    jnet, tnet = _qif_pair("int8", n=8, f32=True, train_params=["eta"])
    load_jax_params(tnet, _jnp_tree(jnet.parameters_pytree()))  # the same int8 scales
    rng = np.random.default_rng(9)
    inp = (rng.normal(size=(300, 8)) + 10.0).astype(np.float32)
    tgt = (rng.normal(size=(300, 8)) * 0.1).astype(np.float32)
    res = {}
    for net in (jnet, tnet):
        obs = net.fit_bptt([inp] * 3, [tgt] * 3, optimizer="adam", lr=1e-2, verbose=False)
        res[net is tnet] = (np.asarray(obs["epoch_loss"]),
                            np.asarray(net.get_node("rnn")["eta"], dtype=np.float64))
    assert tnet.last_fit["trajectory"] == "autograd"
    (l_j, eta_j), (l_t, eta_t) = res[False], res[True]
    assert jnet.run(inp, verbose=False).to_numpy("out").max() > 0.0, "no spikes -- weak test"
    np.testing.assert_allclose(l_t, l_j, rtol=1e-6)
    np.testing.assert_allclose(eta_t, eta_j, rtol=1e-6)
    assert np.abs(eta_t - _np(_qif_pair("int8", n=8, f32=True)[1].get_node("rnn")["eta"])).max() \
        > 1e-4, "eta did not train through the frozen int8 coupling"


@pytest.mark.parametrize("coupling", ["int4", "int4_master", "bfloat16_master"])
def test_unported_couplings_raise(coupling):
    # these couplings are ported now (tests/test_torch_int4.py): a short
    # spiking run of each equals JAX's as test_int8_coupled_run_matches_jax
    # holds int8 (float64, exact integer sums; bf16 products exact, their
    # float32 sums in another order: rtol 1e-6)
    jnet, tnet = _qif_pair(coupling)
    jparams = _jnp_tree(jnet.parameters_pytree())
    load_jax_params(tnet, jparams)  # the same scales (int4) or master
    inp = np.random.default_rng(4).normal(size=(300, 24)) * 3.0
    kw = dict(sampling_steps=3, record_vars=[("rnn", "v", False)], verbose=False)
    jo, to = jnet.run(inp, **kw), tnet.run(inp, **kw)
    assert jo.to_numpy("out").max() > 0.0, "no spikes -- weak test"
    tol = dict(rtol=1e-6, atol=1e-6) if coupling == "bfloat16_master" else dict(rtol=1e-9,
                                                                                atol=1e-9)
    np.testing.assert_allclose(to.to_numpy("out"), jo.to_numpy("out"), **tol)
    np.testing.assert_allclose(to.to_numpy(("rnn", "v")), jo.to_numpy(("rnn", "v")), **tol)
