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
from rectipy_tpu_torch.testing import mma_m16n8k32 as _mma_m16n8k32
from rectipy_tpu_torch.testing import quant_scales, reciprocal_rows

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


def test_quantization_scales_divide_like_numpy_float32():
    # the four scales of the port (quantize_rows, quantize_rows_i4, quant_vec
    # and the frozen coupling's source scale) are max|w| / d divided exactly,
    # as numpy divides float32, also on rows where a product by the
    # reciprocal of d would differ (reciprocal_rows asserts that such rows
    # are in the case): the contract test_torch_gpu.py holds the card to
    w = reciprocal_rows()
    amax = np.maximum(np.abs(w).max(axis=-1), np.float32(1e-30))
    got = quant_scales(_t(w))
    for name, d, lim in (("quantize_rows", 127, 127), ("quantize_rows_i4", 7, 7),
                         ("quant_vec", 127, 127), ("source_scale", 127, None)):
        scale = amax / np.float32(d)
        assert scale.dtype == np.float32
        np.testing.assert_array_equal(_np(got[name][-1]).reshape(-1), scale)
        if lim is not None:
            wq = np.clip(np.round(w / scale[:, None]), -lim, lim)
            np.testing.assert_array_equal(_np(got[name][0]), wq.astype(np.int8))


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


# ------------------------------------------- int8_mm_t on the tensor cores
@pytest.mark.parametrize("n_in, wq_ptr, route", [
    (10_000, 4096, "mma"),  # the training path's N = 10,000 (B = 32 or any B)
    (1_000, 4096 + 8, "mma"),  # 8-byte aligned is enough
    (1_004, 4096, "vec"),  # n_in % 8 == 4: __dp4a on 4-byte loads
    (1_000, 4096 + 4, "vec"),  # weights only 4-byte aligned
    (999, 4096, "scalar"),  # odd n_in
    (1_002, 4096, "scalar"),
    (1_000, 4096 + 2, "scalar"),  # weights not 4-byte aligned
    (1_000, 4096 + 1, "scalar"),
])
def test_int8_mm_t_route(n_in, wq_ptr, route):
    # int8_mm_t's instance is a pure function of the weights' width and
    # address: the tensor cores where 8-byte loads of W fit, __dp4a elsewhere
    assert tq.int8_mm_t_route(n_in, wq_ptr) == route


@pytest.mark.parametrize("B", [1, 7, 33])
@pytest.mark.parametrize("n_in", [999, 1000])
def test_int8_mm_t_plain_matches_jax_vmap(B, n_in):
    # the kernel's plain version with its epilogue against the JAX package's
    # transposed int8 dot under vmap, times the same per-trial scales: both
    # sum exactly and multiply once in float32, so bit for bit
    n_out = 1003
    rng = np.random.default_rng(90 + B)
    wq = rng.integers(-127, 128, size=(n_out, n_in)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(B, n_out)).astype(np.int8)
    act = (rng.random(B) + 0.5).astype(np.float32)
    ref = jax.vmap(jq.int8_dot_t, in_axes=(None, 0))(jnp.asarray(wq), jnp.asarray(vq)) \
        * jnp.asarray(act)[:, None]
    got = tq.int8_mm_t(_t(wq), _t(vq), _t(act))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, n_in)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


# A numpy model of int8_mm_t_mma_kernel (csrc/int8_matvec.cu): the chunks
# and passes of rows, the stage of vq, which bytes each lane loads, the
# transpose4 byte permutes, the mma.sync m16n8k32 fragment layouts of the
# PTX ISA, and the C fragments' (trial, column) in the sums' buffer that the
# cluster adds up.  Each tile product runs as a dense integer matmul.
_KTRIALS, _WARPS, _WARP_COLS, _STEP = 32, 4, 64, 32
_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3  # the fragments' group and thread in group


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte n of the result is byte
    (sel >> 4n) & 7 of the 8 bytes y:x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        out |= ((both >> np.uint64(8 * k)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _transpose4(r0, r1, r2, r3):
    lo01, hi01 = _byte_perm(r0, r1, 0x5140), _byte_perm(r0, r1, 0x7362)
    lo23, hi23 = _byte_perm(r2, r3, 0x5140), _byte_perm(r2, r3, 0x7362)
    return [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
            _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]


def _word(b):
    """(32, 4) int8 bytes -> (32,) uint32, little-endian."""
    return np.ascontiguousarray(b.astype(np.int8)).view("<u4").reshape(-1)


def _passes(n_out, rows_per_chunk, pass_rows):
    """(first row, rows) of every pass of every chunk of rows."""
    for c0 in range(0, n_out, rows_per_chunk):
        rows = min(n_out, c0 + rows_per_chunk) - c0
        for p0 in range(0, rows, pass_rows):
            yield c0 + p0, min(pass_rows, rows - p0)


def _mma_t_model(wq, vq, act, rows_per_chunk, pass_rows=2048):
    n_out, n_in = wq.shape
    n_rows = vq.shape[0]
    acc = np.zeros((n_rows, n_in), np.int64)  # the sum over chunks (the cluster's reduce)
    wpad = np.zeros((n_out + 2 * _STEP, n_in + 2 * _WARPS * _WARP_COLS), np.int8)
    wpad[:n_out, :n_in] = wq
    for b0 in range(0, n_rows, _KTRIALS):
        nb = min(_KTRIALS, n_rows - b0)
        ntiles = (nb + 7) // 8
        for r0, rows in _passes(n_out, rows_per_chunk, pass_rows):
            steps = -(-rows // _STEP)
            stage = np.zeros((_KTRIALS, steps * _STEP), np.int8)
            stage[:nb, :rows] = vq[b0:b0 + nb, r0:r0 + rows]
            for jw in range(0, n_in, _WARP_COLS):  # each warp of each strip
                col_ok = (jw + 8 * _G < n_in)[:, None]
                c = np.zeros((4, 4, 4, 32), np.int64)  # u, nt, i, lane
                for s in range(steps):
                    w = []  # w[r]: (32, 8) bytes of row 8t + r, columns 8g..8g+7
                    for r in range(8):
                        k = s * _STEP + 8 * _T + r
                        cols = jw + 8 * _G[:, None] + np.arange(8)
                        ok = col_ok & (k < rows)[:, None]
                        w.append(np.where(ok, wpad[(r0 + k)[:, None], cols], 0))
                    lo = _transpose4(*[_word(w[r][:, :4]) for r in range(4)]) \
                        + _transpose4(*[_word(w[r][:, 4:]) for r in range(4)])
                    hi = _transpose4(*[_word(w[r][:, :4]) for r in range(4, 8)]) \
                        + _transpose4(*[_word(w[r][:, 4:]) for r in range(4, 8)])
                    for nt in range(ntiles):
                        bv = stage[8 * nt + _G[:, None], s * _STEP + 8 * _T[:, None]
                                   + np.arange(8)]
                        bx, by = _word(bv[:, :4]), _word(bv[:, 4:])
                        for u in range(4):
                            d = _mma_m16n8k32((lo[2 * u], lo[2 * u + 1], hi[2 * u],
                                               hi[2 * u + 1]), (bx, by))
                            for i in range(4):
                                c[u, nt, i] += d[i]
                red = np.zeros((_KTRIALS, _WARP_COLS), np.int64)
                for u in range(4):
                    for nt in range(4):
                        for i in range(4):
                            red[8 * nt + 2 * _T + (i & 1), 8 * _G + 2 * u + (i >> 1)] = c[u, nt, i]
                width = min(_WARP_COLS, n_in - jw)
                acc[b0:b0 + nb, jw:jw + width] += red[:nb, :width]
    return acc.astype(np.float32) * act[:, None]


@pytest.mark.parametrize("B, n_out, n_in, rows_per_chunk, pass_rows", [
    (7, 70, 136, 64, 2048),  # a K tail in the second chunk; 7 trials pad one n-tile
    (33, 45, 264, 32, 2048),  # two trial groups (the second of one trial); a column tail
    (16, 96, 64, 96, 2048),  # one chunk of three full k-steps, two n-tiles
    (1, 3, 8, 32, 2048),  # one trial, one short k-step, one lane group's columns
    (9, 150, 72, 128, 64),  # chunks of two passes, the last pass of a chunk short
])
def test_int8_mm_t_fragment_model_equals_plain(B, n_out, n_in, rows_per_chunk, pass_rows):
    # the tensor-core kernel's index mapping, modelled lane by lane, gives
    # int8_mm_t's plain result bit for bit (an index error shows here)
    rng = np.random.default_rng(B + n_out)
    wq = rng.integers(-127, 128, size=(n_out, n_in)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(B, n_out)).astype(np.int8)
    act = (rng.random(B) + 0.5).astype(np.float32)
    got = _mma_t_model(wq, vq, act, rows_per_chunk, pass_rows)
    ref = tq.int8_mm_t_plain(_t(wq), _t(vq)) * _t(act)[:, None]
    np.testing.assert_array_equal(got, _np(ref))


# --------------------------------------------- int8_mm on the tensor cores
@pytest.mark.parametrize("n_in, wq_ptr, route", [
    (10_000, 4096, "mma"),  # the batched paths' N = 10,000: 16-byte loads of W
    (1_000, 4096, "mma"),  # n_in % 16 == 8: two 8-byte loads where one 16-byte load goes
    (10_000, 4096 + 8, "mma"),  # 8-byte aligned is enough
    (8, 4096, "mma"),
    (1_004, 4096, "scalar"),  # n_in % 8 == 4
    (999, 4096, "scalar"),  # odd n_in
    (10_000, 4096 + 4, "scalar"),  # weights only 4-byte aligned
    (1_000, 4096 + 1, "scalar"),
])
def test_int8_mm_route(n_in, wq_ptr, route):
    # int8_mm's instance is a pure function of the weights' width and address:
    # the tensor cores where 8-byte loads of W fit, __dp4a elsewhere
    assert tq.int8_mm_route(n_in, wq_ptr) == route


@pytest.mark.parametrize("B", [1, 7, 33])
@pytest.mark.parametrize("n_in", [999, 1000])
def test_int8_mm_plain_matches_jax_vmap(B, n_in):
    # the kernel's plain version with its epilogue against the JAX package's
    # int8 dot under vmap, times the same row and per-trial scales in the
    # same order: both sum exactly and multiply twice in float32, so bit for bit
    n_out = 1003
    rng = np.random.default_rng(80 + B)
    wq = rng.integers(-127, 128, size=(n_out, n_in)).astype(np.int8)
    xq = rng.integers(-127, 128, size=(B, n_in)).astype(np.int8)
    rs = (rng.random(n_out) + 0.5).astype(np.float32)
    act = (rng.random(B) + 0.5).astype(np.float32)
    ref = (jax.vmap(jq.int8_dot, in_axes=(None, 0))(jnp.asarray(wq), jnp.asarray(xq))
           * jnp.asarray(rs)) * jnp.asarray(act)[:, None]
    got = tq.int8_mm(_t(wq), _t(xq), _t(rs), _t(act))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, n_out)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


# A numpy model of int8_mm_mma_kernel (csrc/int8_matvec.cu; its k loop is
# csrc/mma_s8.cuh's rows_mma_sums): the chunks of
# columns (one cluster) and their passes, the stage of xq, the 16 bytes of
# rows g and g + 8 of each m-tile that lane (g, t) loads per 64-column
# sub-block of a 128-column k-block, the A and B fragments of its two
# k-steps, and the C fragments' (trial, row) in the sums' buffer that the
# cluster adds up.
_MA_TILES, _MA_BLOCK_K = 2, 128
_MA_ROWS = _WARPS * 16 * _MA_TILES


def _mma_model(wq, xq, rs, act, cols_per_chunk, pass_cols=2048):
    n_out, n_in = wq.shape
    n_rows = xq.shape[0]
    acc = np.zeros((n_rows, n_out), np.int64)  # the sum over chunks (the cluster's reduce)
    wpad = np.zeros((n_out + _MA_ROWS, n_in + 2 * _MA_BLOCK_K), np.int8)
    wpad[:n_out, :n_in] = wq
    col = 16 * _T[:, None] + np.arange(16)  # (32, 16): the lane's columns of a k-block
    for b0 in range(0, n_rows, _KTRIALS):
        nb = min(_KTRIALS, n_rows - b0)
        ntiles = (nb + 7) // 8
        for c0 in range(0, n_in, cols_per_chunk):
            cols = min(n_in, c0 + cols_per_chunk) - c0
            for p0 in range(0, cols, pass_cols):
                pcols = min(pass_cols, cols - p0)
                blocks = -(-pcols // _MA_BLOCK_K)
                stage = np.zeros((_KTRIALS, blocks * _MA_BLOCK_K), np.int8)
                stage[:nb, :pcols] = xq[b0:b0 + nb, c0 + p0:c0 + p0 + pcols]
                for row0 in range(0, n_out, 16 * _MA_TILES):  # each warp of each strip
                    c = np.zeros((_MA_TILES, 4, 4, 32), np.int64)  # u, nt, i, lane
                    for kb, h in np.ndindex(blocks, _MA_BLOCK_K // 64):
                        k = kb * _MA_BLOCK_K + 64 * h + col
                        w = []  # w[m]: (32, 16) bytes of row g + 8 (m % 2) of m-tile m // 2
                        for m in range(2 * _MA_TILES):
                            r = row0 + 16 * (m >> 1) + 8 * (m & 1) + _G
                            ok = (r < n_out)[:, None] & (k < pcols)
                            w.append(np.where(ok, wpad[r[:, None], c0 + p0 + k], 0))
                        for nt in range(ntiles):
                            bv = stage[8 * nt + _G[:, None], k]
                            for step in range(2):
                                lo, hi = 8 * step, 8 * step + 4
                                b = (_word(bv[:, lo:lo + 4]), _word(bv[:, hi:hi + 4]))
                                for u in range(_MA_TILES):
                                    a = (_word(w[2 * u][:, lo:lo + 4]),
                                         _word(w[2 * u + 1][:, lo:lo + 4]),
                                         _word(w[2 * u][:, hi:hi + 4]),
                                         _word(w[2 * u + 1][:, hi:hi + 4]))
                                    d = _mma_m16n8k32(a, b)
                                    for i in range(4):
                                        c[u, nt, i] += d[i]
                    red = np.zeros((_KTRIALS, 16 * _MA_TILES), np.int64)
                    for u in range(_MA_TILES):
                        for nt in range(4):
                            for i in range(4):
                                red[8 * nt + 2 * _T + (i & 1), 16 * u + _G + 8 * (i >> 1)] = \
                                    c[u, nt, i]
                    height = min(16 * _MA_TILES, n_out - row0)
                    acc[b0:b0 + nb, row0:row0 + height] += red[:nb, :height]
    return (acc.astype(np.float32) * rs) * act[:, None]


@pytest.mark.parametrize("B, n_out, n_in, cols_per_chunk, pass_cols", [
    (7, 70, 400, 128, 2048),  # a K tail of 16 bytes (400 = 3 x 128 + 16); 7 trials, one n-tile
    (33, 45, 136, 128, 2048),  # two trial groups (the second of one trial); n_out % 16 != 0
    (1, 37, 384, 384, 2048),  # one trial, one chunk of three full k-blocks
    (16, 129, 200, 128, 2048),  # n_in % 16 == 8: the last chunk is 72 columns; a row past a block
    (9, 20, 656, 512, 256),  # chunks of two passes, the last pass of a chunk short
])
def test_int8_mm_fragment_model_equals_plain(B, n_out, n_in, cols_per_chunk, pass_cols):
    # the tensor-core kernel's index mapping, modelled lane by lane, gives
    # int8_mm's plain result with its epilogue bit for bit
    rng = np.random.default_rng(B + n_in)
    wq = rng.integers(-127, 128, size=(n_out, n_in)).astype(np.int8)
    xq = rng.integers(-127, 128, size=(B, n_in)).astype(np.int8)
    rs = (rng.random(n_out) + 0.5).astype(np.float32)
    act = (rng.random(B) + 0.5).astype(np.float32)
    got = _mma_model(wq, xq, rs, act, cols_per_chunk, pass_cols)
    ref = (tq.int8_mm_plain(_t(wq), _t(xq)) * _t(rs)) * _t(act)[:, None]
    np.testing.assert_array_equal(got, _np(ref))
