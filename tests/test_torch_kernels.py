"""The port's fused QIF+SFA step against the JAX package's Pallas kernel.

On the CPU, ``qif_sfa_step`` takes its plain PyTorch version; the JAX Pallas
kernel runs in interpret mode, as ``tests/test_kernels.py`` runs it.  The
CUDA kernel itself runs only on a GPU: ``tests/test_torch_gpu.py`` holds it
against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.ops.kernels import attach_fused_qif_step as j_attach
from rectipy_tpu.ops.kernels import make_qif_sfa_pallas_step, pad_coupling
from rectipy_tpu.ops.kernels import qif_sfa_reference_step as j_reference_step
from rectipy_tpu_torch import Network
from rectipy_tpu_torch.ops.kernels import (attach_fused_qif_step, qif_sfa_reference_step,
                                           qif_sfa_step, rows_route)

PARAMS = dict(dt=1e-4, tau=1.0, tau_s=1.0, tau_x=10.0, k=15.0, alpha=0.05,
              thresh=10.0, v_reset=-10.0)
QIF_SFA = "rectipy_tpu.models.spiking_neurons.qif.qif_sfa"


def _inputs(n, seed, v_scale=8.0):
    rng = np.random.default_rng(seed)
    W = (rng.random((n, n)) < 0.1).astype(np.float32) * 0.01
    vecs = [rng.normal(size=n) * v_scale, rng.random(n), rng.random(n), rng.normal(size=n),
            rng.normal(size=n)]
    return W, [v.astype(np.float32) for v in vecs]  # v (some above thresh), s, x, eta, inp


def _torch(W, vecs, w_dtype=torch.float32):
    return (torch.as_tensor(W).to(w_dtype), *[torch.as_tensor(v) for v in vecs])


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_plain_step_matches_pallas_interpret(w_dtype):
    # same arithmetic as the TPU kernel (bf16: s rounded to bf16, products
    # summed in f32); sums run in another order -> the JAX test's 1e-5
    n, tile = 300, 128  # not a multiple of the tile: the Pallas side pads
    W, (v, s, x, eta, inp) = _inputs(n, 0)
    jd = jnp.float32 if w_dtype == "float32" else jnp.bfloat16
    step = make_qif_sfa_pallas_step(n, tile=tile, interpret=True, weights_dtype=jd, **PARAMS)
    jv, js, jx = step(*[jnp.asarray(a) for a in (v, s, x)], pad_coupling(W, tile, jd),
                      jnp.asarray(eta), jnp.asarray(inp))
    Wt, vt, st, xt, et, it = _torch(W, (v, s, x, eta, inp), getattr(torch, w_dtype))
    out = qif_sfa_step(vt, st, xt, Wt, et, it, **PARAMS)
    assert out.shape == (3, n) and out.dtype == torch.float32
    for got, ref in zip(out, (jv, js, jx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the reset mask comes from the input v alone: identical on both sides
    reset = out[0].numpy() == PARAMS["v_reset"]
    assert reset.any()
    np.testing.assert_array_equal(reset, np.asarray(jv) == PARAMS["v_reset"])


def test_plain_step_matches_jax_reference():
    # the same formula as the JAX oracle; f32 sums in another order
    n = 300
    W, (v, s, x, eta, inp) = _inputs(n, 1)
    ref = j_reference_step(*[jnp.asarray(a) for a in (v, s, x)], jnp.asarray(W),
                           jnp.asarray(eta), jnp.asarray(inp), **PARAMS)
    got = qif_sfa_reference_step(*_torch(W, (v, s, x, eta, inp))[1:4], torch.as_tensor(W),
                                 torch.as_tensor(eta), torch.as_tensor(inp), **PARAMS)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)


def test_plain_step_multi_step_trajectory():
    # 50 steps of the uncoupled population from tests/test_kernels.py
    n = 128
    W = np.zeros((n, n), dtype=np.float32)
    v0, eta0 = np.full(n, -2.0, np.float32), np.full(n, 8.0, np.float32)
    z = np.zeros(n, np.float32)
    tv, ts, tx = (torch.as_tensor(a) for a in (v0, z, z))
    jv, js, jx = (jnp.asarray(a) for a in (v0, z, z))
    for _ in range(50):
        tv, ts, tx = qif_sfa_step(tv, ts, tx, torch.as_tensor(W), torch.as_tensor(eta0),
                                  torch.as_tensor(z), **PARAMS)
        jv, js, jx = j_reference_step(jv, js, jx, jnp.asarray(W), jnp.asarray(eta0),
                                      jnp.asarray(z), **PARAMS)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_are_not_counted():
    n = 40
    W, vecs = _inputs(n, 2)
    before = qif_sfa_step.launches
    out = qif_sfa_step(*_torch(W, vecs)[1:4], torch.as_tensor(W), *_torch(W, vecs)[4:], **PARAMS)
    ref = torch.stack(qif_sfa_reference_step(*_torch(W, vecs)[1:4], torch.as_tensor(W),
                                             *_torch(W, vecs)[4:], **PARAMS))
    assert torch.equal(out, ref)
    assert qif_sfa_step.launches == before


def test_non_cpu_non_cuda_tensors_raise():
    # no fallback: a tensor that is not on the CPU either launches or raises
    n = 8
    meta = [torch.empty(n, device="meta") for _ in range(5)]
    with pytest.raises(ValueError, match="CUDA"):
        qif_sfa_step(*meta[:3], torch.empty(n, n, device="meta"), *meta[3:], **PARAMS)


@pytest.mark.parametrize("w_dtype, n, ld_s, w_ptr, s_ptr, route", [
    (torch.bfloat16, 10_000, 30_000, 4096, 4096 + 40_000, "mma"),  # a node's (B, 3n) state
    (torch.bfloat16, 1_000, 0, 256, 512, "mma"),  # one s row shared by every trial
    (torch.float32, 10_000, 30_000, 4096, 4096 + 40_000, "tiled"),  # f32: the CUDA cores
    (torch.float32, 1_000, 0, 256, 512, "tiled"),  # one s row shared by every trial
    (torch.float32, 1_004, 3_012, 4096, 4096 + 4_016, "tiled"),  # n % 4 == 0 is enough for f32
    (torch.bfloat16, 1_004, 3_012, 4096, 4096 + 4_016, "scalar"),  # n % 8 != 0
    (torch.bfloat16, 1_003, 3_009, 4096, 4096 + 4_012, "scalar"),
    (torch.bfloat16, 1_000, 3_002, 4096, 4096 + 4_000, "scalar"),  # ld_s % 4 != 0
    (torch.bfloat16, 1_000, 3_000, 4096 + 8, 4096 + 4_000, "scalar"),  # W not 16-byte aligned
    (torch.bfloat16, 1_000, 3_000, 4096, 4096 + 4_004, "scalar"),  # s not 16-byte aligned
    (torch.float32, 1_002, 3_006, 4096, 4096 + 4_008, "scalar"),  # n % 4 != 0
    (torch.float32, 1_000, 3_002, 4096, 4096 + 4_000, "scalar"),  # ld_s % 4 != 0
    (torch.float32, 1_000, 3_000, 4096 + 4, 4096 + 4_000, "scalar"),  # W not 16-byte aligned
    (torch.float32, 1_000, 3_000, 4096, 4096 + 4_008, "scalar"),  # s not 16-byte aligned
])
def test_rows_route(w_dtype, n, ld_s, w_ptr, s_ptr, route):
    # the B-row kernel's instance is a pure function of the operands' shapes
    # and addresses: aligned bf16 takes the tensor cores, aligned f32 the
    # tiled kernel on the CUDA cores, everything else the scalar loads
    assert rows_route(w_dtype, n, ld_s, w_ptr, s_ptr) == route


def test_rows_route_of_a_node_state_view():
    # the fused node's s is the view y[:, n:2n] of its (B, 3n) state: the
    # route follows n (through the view's offset and row stride)
    for w_dtype, n, route in (
            (torch.bfloat16, 1_000, "mma"), (torch.bfloat16, 1_024, "mma"),
            (torch.bfloat16, 1_004, "scalar"), (torch.bfloat16, 1_003, "scalar"),
            (torch.float32, 1_000, "tiled"), (torch.float32, 1_004, "tiled"),
            (torch.float32, 1_002, "scalar"), (torch.float32, 1_003, "scalar")):
        y = torch.zeros((4, 3 * n), dtype=torch.float32)
        W = torch.zeros((n, n), dtype=w_dtype)
        s = y[:, n:2 * n]
        assert rows_route(W.dtype, n, s.stride(0), W.data_ptr(), s.data_ptr()) == route


# ------------------------------------------------------------- node attach


def _nets(n, W, etas, fused_jax, fused_port, dtype="float32", extra=None):
    kw = dict(weights=W, source_var="s", target_var="s_in", input_var="I_ext",
              output_var="s", op="qif_sfa_op", spike_var="spike", spike_def="v",
              spike_threshold=30.0, spike_reset=-30.0,
              node_vars={"all/qif_sfa_op/eta": etas, **(extra or {})})
    jnet = JNetwork(1e-3, dtype=getattr(jnp, dtype))
    jnet.add_diffeq_node("qif", QIF_SFA, dtype=getattr(jnp, dtype), **kw)
    jnet.compile()
    tnet = Network(1e-3, device="cpu", dtype=getattr(torch, dtype))
    tnet.add_diffeq_node("qif", QIF_SFA, **kw)
    tnet.compile()
    if fused_jax:
        j_attach(jnet.get_node("qif"), tile=128, interpret=True)
    if fused_port:
        attach_fused_qif_step(tnet.get_node("qif"))
    return jnet, tnet


def test_attached_port_matches_attached_jax():
    # both run the fused step (JAX: Pallas, interpret mode; port: the plain
    # version behind the wrapper) in f32 over 600 steps; tolerance of
    # tests/test_kernels.py's attach test
    n = 64
    rng = np.random.default_rng(3)
    W = (rng.random((n, n)) < 0.2).astype(np.float64) * 0.02
    etas = rng.normal(size=n) + 100.0
    inp = rng.normal(size=(600, n)).astype(np.float32)
    jnet, tnet = _nets(n, W, etas, fused_jax=True, fused_port=True)
    ref = jnet.run(inp, verbose=False).to_numpy("out")
    got = tnet.run(inp, verbose=False).to_numpy("out")
    assert np.any(ref > 0), "no spiking activity -- weak test"
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # the final state is the unpadded [v | s | x] layout on the port side
    jy = np.asarray(jnet.get_node("qif")._fused_unpad(jnet.get_node("qif").y))
    np.testing.assert_allclose(tnet.get_node("qif").y.numpy(), jy, rtol=1e-4, atol=1e-3)


def test_attached_port_matches_plain_port():
    # fused vs the lowered plain path of the port itself (f32, 300 steps):
    # the same functions, summed in another order
    n = 48
    rng = np.random.default_rng(4)
    W = (rng.random((n, n)) < 0.2) * 0.02
    etas = rng.normal(size=n) + 100.0
    inp = rng.normal(size=(300, n))
    _, plain = _nets(n, W, etas, False, False)
    _, fused = _nets(n, W, etas, False, True)
    kw = dict(sampling_steps=7, record_vars=[("qif", "v", False), ("qif", "x", True)],
              verbose=False)
    a, b = plain.run(inp, **kw), fused.run(inp, **kw)
    for key in ("out", ("qif", "v"), ("qif", "x")):
        np.testing.assert_allclose(b.to_numpy(key), a.to_numpy(key), rtol=1e-4, atol=1e-4)
    assert fused.get_node("qif")["v"].shape == (n,)


def test_attach_keeps_reset_get_var_and_refreshes_params():
    n = 32
    rng = np.random.default_rng(5)
    W = (rng.random((n, n)) < 0.2) * 0.02
    etas = rng.normal(size=n) + 100.0
    inp = rng.normal(size=(50, n))
    _, plain = _nets(n, W, etas, False, False)
    _, fused = _nets(n, W, etas, False, True)
    y0 = rng.normal(size=3 * n)
    for net in (plain, fused):
        net.get_node("qif").reset(y0)  # unpadded (3n,) state
        net.set_var("qif", "eta", etas - 90.0)
        net.set_var("qif", "weights", W * 3.0)
    a = plain.run(inp, verbose=False).to_numpy("out")
    b = fused.run(inp, verbose=False).to_numpy("out")
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    node = fused.get_node("qif")
    np.testing.assert_array_equal(node["eta"].numpy(), node.args["__eta_fused__"].numpy())
    np.testing.assert_array_equal(node["weights"].numpy(), node.args["__w_fused__"].numpy())
    with pytest.raises(ValueError, match="rebuild"):
        fused.set_var("qif", "tau", 2.0)
    fused.reset()
    assert torch.count_nonzero(node.y) == 0


def test_attach_rejections():
    n = 16
    etas = np.zeros(n)
    W = np.zeros((n, n))
    with pytest.raises(ValueError, match="scalar"):
        _nets(n, W, etas, False, True, extra={"all/qif_sfa_op/tau": np.ones(n)})
    _, tnet = _nets(n, W, etas, False, True)
    with pytest.raises(ValueError, match="already attached"):
        attach_fused_qif_step(tnet.get_node("qif"))
    _, t64 = _nets(n, W, etas, False, False, dtype="float64")
    with pytest.raises(ValueError, match="float32"):
        attach_fused_qif_step(t64.get_node("qif"))
    _, t32 = _nets(n, W, etas, False, False)
    with pytest.raises(ValueError, match="bfloat16"):
        attach_fused_qif_step(t32.get_node("qif"), weights_dtype=torch.float16)
    net = Network(1e-3, device="cpu")
    net.add_diffeq_node("qif", QIF_SFA, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="v", op="qif_sfa_op",
                        spike_var="spike", spike_def="v")
    with pytest.raises(ValueError, match="output_var='s'"):
        attach_fused_qif_step(net.get_node("qif"))


def test_attach_bf16_weights_on_plain_qif_without_adaptation():
    # qif (no x): the kernel's x row is unused; bf16 kernel copy of an f32
    # coupling against the lowered bf16 coupling of the port (same rounding)
    n = 40
    rng = np.random.default_rng(6)
    W = (rng.random((n, n)) < 0.3) * 0.05
    inp = rng.normal(size=(300, n))

    def build(fused):
        net = Network(1e-3, device="cpu")
        net.add_diffeq_node("qif", "rectipy_tpu.models.spiking_neurons.qif.qif", weights=W,
                            source_var="s", target_var="s_in", input_var="I_ext",
                            output_var="s", op="qif_op", spike_var="spike", spike_def="v",
                            spike_threshold=30.0, spike_reset=-30.0,
                            node_vars={"all/qif_op/eta": np.linspace(150.0, 250.0, n)},
                            coupling_dtype=None if fused else "bfloat16")
        if fused:
            attach_fused_qif_step(net.get_node("qif"), weights_dtype="bfloat16")
        return net

    a = build(False).run(inp, verbose=False).to_numpy("out")
    b = build(True).run(inp, verbose=False).to_numpy("out")
    assert np.any(a > 0)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
