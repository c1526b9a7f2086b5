"""The port's CUDA kernels on the card, against their plain PyTorch versions.

The ``gpu``-marked tests need a CUDA device and skip without one.  The file
imports neither JAX nor the JAX package, so it also runs where only PyTorch
is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from rectipy_tpu_torch import (RLS, FeedbackNetwork, Network, attach_fused_qif_step,
                               attach_generic_fused_step)
from rectipy_tpu_torch.ops.fused_opt import adam_requant, adam_requant_plain
from rectipy_tpu_torch.ops.generic_fused import (generic_fused_rows, generic_fused_rows_plain,
                                                 generic_fused_step, generic_fused_step_plain,
                                                 generic_rows_route)
from rectipy_tpu_torch.ops.kernels import qif_sfa_reference_step, qif_sfa_step, rows_route
from rectipy_tpu_torch.ops.quant import (int4_dot_plain, int4_dot_t_plain, int4_mm,
                                         int4_mm_plain, int4_mm_route, int4_mm_t,
                                         int4_mm_t_plain, int4_mm_t_route, int4_mv, int4_mv_t,
                                         int4_vector_path,
                                         int8_dot_plain,
                                         int8_dot_t_plain,
                                         int8_mm, int8_mm_plain, int8_mm_route, int8_mm_t,
                                         int8_mm_t_plain, int8_mm_t_route, int8_mv, int8_mv_t,
                                         pack_int4,
                                         quant_vec, quantize_rows)
from rectipy_tpu_torch.testing import (ADAM_KW, GENERIC_CASES, adam_inputs, check_adam_requant,
                                       check_generic, generic_case_net, generic_inputs,
                                       generic_rows_instance, generic_rows_operands,
                                       lost_eighth_margin, qif_rows_instance, quant_scales,
                                       reciprocal_rows)

PARAMS = dict(dt=1e-4, tau=1.0, tau_s=1.0, tau_x=10.0, k=15.0, alpha=0.05,
              thresh=10.0, v_reset=-10.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


# Inputs on which the coupling sets v': a dense row-normalised W, k = 1/dt and
# v, eta, x, inp of order 1e-3, all below the threshold, so that
# v' = s_in + O(1e-3) with s_in ~ 0.5 (W averages s).  Both W types sum
# exact f32 (or exact bf16 x bf16) products in f32 on both sides, in
# another order, so 1e-6 + 1e-5*|v'| (~6e-6 on s_in, 1.2e-5 of it) holds;
# test_coupling_tolerance_fails_a_lost_eighth_of_the_row_sum shows it is
# tight enough to see a lost partial sum.
COUPLING_PARAMS = dict(PARAMS, k=1.0 / PARAMS["dt"])
COUPLING_TOL = dict(rtol=1e-5, atol=1e-6)


def _on(device, w_dtype, W, vecs):
    return (torch.as_tensor(W, dtype=torch.float32, device=device).to(w_dtype),
            *[torch.as_tensor(a, dtype=torch.float32, device=device) for a in vecs])


def _inputs(n, seed, device, w_dtype):
    """v spread across the threshold: for the reset mask and the epilogue."""
    rng = np.random.default_rng(seed)
    W = (rng.random((n, n)) < 0.1) * 0.01
    vecs = [rng.normal(size=n) * 12.0, rng.random(n), rng.random(n), rng.normal(size=n),
            rng.normal(size=n)]
    return _on(device, w_dtype, W, vecs)


def _coupling_inputs(n, seed, device, w_dtype):
    rng = np.random.default_rng(seed)
    W = rng.random((n, n))
    W /= W.sum(axis=1, keepdims=True)
    vecs = [rng.normal(size=n) * 1e-3, rng.random(n), rng.random(n) * 1e-3,
            rng.normal(size=n) * 1e-3, rng.normal(size=n) * 1e-3]
    return _on(device, w_dtype, W, vecs)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 1003, 37])  # 16-byte vector loop / scalar loop
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(cuda, n, w_dtype):
    # the reset case: the same f32 arithmetic in another summation order,
    # 1e-5 relative; the coupling term here is below atol
    W, v, s, x, eta, inp = _inputs(n, 7, cuda, w_dtype)
    before = qif_sfa_step.launches
    out = qif_sfa_step(v, s, x, W, eta, inp, **PARAMS)
    torch.cuda.synchronize()
    assert qif_sfa_step.launches == before + 1
    ref = qif_sfa_reference_step(v, s, x, W, eta, inp, **PARAMS)
    for got, r in zip(out, ref):
        torch.testing.assert_close(got, r, rtol=1e-5, atol=1e-4)
    assert torch.equal(out[0] == PARAMS["v_reset"], ref[0] == PARAMS["v_reset"])
    assert bool((out[0] == PARAMS["v_reset"]).any())
    # the coupling case: v' carries the matvec
    W, v, s, x, eta, inp = _coupling_inputs(n, 7, cuda, w_dtype)
    out = qif_sfa_step(v, s, x, W, eta, inp, **COUPLING_PARAMS)
    ref = qif_sfa_reference_step(v, s, x, W, eta, inp, **COUPLING_PARAMS)
    for got, r in zip(out, ref):
        torch.testing.assert_close(got, r, **COUPLING_TOL)


@pytest.mark.gpu
def test_cuda_kernel_misaligned_s_takes_the_scalar_loop(cuda):
    n = 1000
    W, v, s, x, eta, inp = _coupling_inputs(n, 8, cuda, torch.float32)
    s_off = torch.cat((torch.zeros(1, device=cuda), s))[1:]  # 4 bytes past an aligned base
    assert s_off.data_ptr() % 16 != 0
    out = qif_sfa_step(v, s_off, x, W, eta, inp, **COUPLING_PARAMS)
    ref = qif_sfa_reference_step(v, s, x, W, eta, inp, **COUPLING_PARAMS)
    for got, r in zip(out, ref):
        torch.testing.assert_close(got, r, **COUPLING_TOL)


@pytest.mark.parametrize("n", [1000, 1003, 37])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_coupling_tolerance_fails_a_lost_eighth_of_the_row_sum(n, w_dtype):
    # needs no card: the plain version against itself with every eighth
    # entry of s zeroed, as a kernel that dropped the partial sum of one of
    # its eight warps would lose terms; COUPLING_TOL must fail every row
    W, v, s, x, eta, inp = _coupling_inputs(n, 7, "cpu", w_dtype)
    ref = qif_sfa_reference_step(v, s, x, W, eta, inp, **COUPLING_PARAMS)[0]
    s_cut = s.clone()
    s_cut[::8] = 0.0
    cut = qif_sfa_reference_step(v, s_cut, x, W, eta, inp, **COUPLING_PARAMS)[0]
    bound = COUPLING_TOL["atol"] + COUPLING_TOL["rtol"] * ref.abs()
    assert bool(((cut - ref).abs() > bound).all())


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    n = 64
    W, v, s, x, eta, inp = _inputs(n, 9, cuda, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qif_sfa_step(v, s, x, W.double(), eta, inp, **PARAMS)
    with pytest.raises(ValueError, match="contiguous"):
        qif_sfa_step(v, s, x, W.t(), eta, inp, **PARAMS)
    with pytest.raises(ValueError, match="shape"):
        qif_sfa_step(v, s[:-1], x, W, eta, inp, **PARAMS)
    with pytest.raises(ValueError, match="on cpu"):
        qif_sfa_step(v, s, x.cpu(), W, eta, inp, **PARAMS)


@pytest.mark.gpu
@pytest.mark.parametrize("coupling", ["float32", "bfloat16"])
def test_fused_network_on_card_matches_plain_network_on_cpu(cuda, coupling):
    # 400 steps of the bench network at n=512: kernel on the card vs the
    # plain lowered path on the CPU; f32 sums in other orders
    n = 512
    rng = np.random.default_rng(10)
    W = (rng.random((n, n)) < 0.1) / (0.1 * n)
    etas = rng.normal(size=n) * 50.0 + 20000.0
    inp = np.zeros((400, 1))
    inp[100:300] = 3.0
    obs = {}
    for device in (cuda, "cpu"):
        net = Network(1e-4, device=device)
        net.add_diffeq_node(
            "qif", "rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa", weights=W,
            source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
            spike_var="spike", spike_def="v", op="qif_sfa_op",
            node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/k": 15.0},
            coupling_dtype=coupling)
        net.add_func_node("inp", 1, activation_function="tanh")
        net.add_edge("inp", "qif", weights=np.ones((n, 1)))
        if device is cuda:
            attach_fused_qif_step(net.get_node("qif"))
        obs[str(device)] = net.run(inp, sampling_steps=10, record_vars=[("qif", "v", False)],
                                   verbose=False)
    a, b = obs["cpu"], obs[str(cuda)]
    assert a.to_numpy("out").max() > 0.0, "no spiking activity -- weak test"
    np.testing.assert_allclose(b.to_numpy("out"), a.to_numpy("out"), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b.to_numpy(("qif", "v")), a.to_numpy(("qif", "v")),
                               rtol=1e-4, atol=1e-3)


# ------------------------------------------------------ int8 matvecs
def _int8_inputs(n_out, n_in, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    W = torch.randn((n_out, n_in), generator=gen, device=device) * (
        torch.rand((n_out, n_in), generator=gen, device=device) < 0.3)
    wq, ws = quantize_rows(W)
    xq, xs = quant_vec(torch.randn(n_in, generator=gen, device=device))
    vq, vs = quant_vec(torch.randn(n_out, generator=gen, device=device))
    return wq, ws, xq, xs, vq, vs


@pytest.mark.gpu
@pytest.mark.parametrize("n_out,n_in", [(37, 37), (1000, 1000), (1003, 1003), (64, 1003),
                                        (1003, 64)])
def test_int8_matvecs_bit_identical_to_plain(cuda, n_out, n_in):
    # integer sums are exact in any order, so the kernels must agree bit for
    # bit with the float64-summed plain version, epilogue included
    wq, ws, xq, xs, vq, vs = _int8_inputs(n_out, n_in, 11, cuda)
    before = (int8_mv.launches, int8_mv_t.launches)
    out = int8_mv(wq, xq, ws, xs)
    out_t = int8_mv_t(wq, vq, vs)
    torch.cuda.synchronize()
    assert (int8_mv.launches, int8_mv_t.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out, (int8_dot_plain(wq, xq) * ws) * xs)
    assert torch.equal(out_t, int8_dot_t_plain(wq, vq) * vs)
    assert bool((out != 0).any()) and bool((out_t != 0).any())


@pytest.mark.gpu
def test_int8_matvec_misaligned_vector_takes_the_scalar_loop(cuda):
    wq, ws, xq, xs, vq, vs = _int8_inputs(256, 1024, 12, cuda)
    x_off = torch.cat((torch.zeros(1, dtype=torch.int8, device=cuda), xq))[1:]
    assert x_off.data_ptr() % 16 != 0
    assert torch.equal(int8_mv(wq, x_off, ws, xs), (int8_dot_plain(wq, xq) * ws) * xs)


@pytest.mark.gpu
def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    wq, ws, xq, xs, vq, vs = _int8_inputs(64, 64, 13, cuda)
    with pytest.raises(ValueError, match="int8 matrix"):
        int8_mv(wq.float(), xq, ws, xs)
    with pytest.raises(ValueError, match="contiguous"):
        int8_mv(wq.t(), xq, ws, xs)
    with pytest.raises(ValueError, match="vector"):
        int8_mv(wq, xq[:-1], ws, xs)
    with pytest.raises(ValueError, match="row scale"):
        int8_mv(wq, xq, ws.double(), xs)
    with pytest.raises(ValueError, match="vector"):
        int8_mv_t(wq, vq.cpu(), vs)
    with pytest.raises(ValueError, match="activation scale"):
        int8_mv_t(wq, vq, vs.cpu())


# ------------------------------------------------------ int4 matvecs
def _int4_inputs(n_out, n_in, seed, device, tight=False):
    """Packed weights over the full nibble range [-8, 7] (``tight``: rows of
    ceil(n_in / 2) bytes, unpadded), the activations and the scales."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randint(-8, 8, (n_out, n_in), generator=gen, device=device, dtype=torch.int8)
    wp = pack_int4(w)
    if tight:
        wp = wp[:, :(n_in + 1) // 2].contiguous()
    xq, xs = quant_vec(torch.randn(n_in, generator=gen, device=device))
    vq, vs = quant_vec(torch.randn(n_out, generator=gen, device=device))
    ws = torch.rand(n_out, generator=gen, device=device) + 0.5
    return wp, ws, xq, xs, vq, vs


@pytest.mark.gpu
@pytest.mark.parametrize("n_out,n_in,tight", [
    (64, 1024, False), (37, 1000, False),  # 16-byte aligned rows, a tail of 8 weights
    (16, 10_000, True),  # 5,000-byte rows (8 mod 16): the scalar path
    (16, 10_000, False), (1003, 999, False), (999, 1003, True),  # odd n_in
    (33, 1, False), (1, 33, False)])  # n_in = 1, n_out = 1
def test_int4_matvecs_bit_identical_to_plain(cuda, n_out, n_in, tight):
    # integer sums are exact in any order: the kernels must agree bit for
    # bit with the float64-summed plain versions, epilogue included
    wp, ws, xq, xs, vq, vs = _int4_inputs(n_out, n_in, 14, cuda, tight)
    assert int4_vector_path(wp, xq) == (not tight)
    before = (int4_mv.launches, int4_mv_t.launches)
    out = int4_mv(wp, xq, ws, xs)
    out_t = int4_mv_t(wp, vq, vs, n_in)
    torch.cuda.synchronize()
    assert (int4_mv.launches, int4_mv_t.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out, (int4_dot_plain(wp, xq) * ws) * xs)
    assert torch.equal(out_t, int4_dot_t_plain(wp, vq, n_in) * vs)
    assert bool((out != 0).any()) and bool((out_t != 0).any())


@pytest.mark.gpu
def test_int4_matvec_misaligned_vector_takes_the_scalar_loop(cuda):
    wp, ws, xq, xs, vq, vs = _int4_inputs(256, 1024, 15, cuda)
    x_off = torch.cat((torch.zeros(1, dtype=torch.int8, device=cuda), xq))[1:]
    assert not int4_vector_path(wp, x_off)
    assert torch.equal(int4_mv(wp, x_off, ws, xs), (int4_dot_plain(wp, xq) * ws) * xs)


@pytest.mark.gpu
def test_int4_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    wp, ws, xq, xs, vq, vs = _int4_inputs(64, 64, 16, cuda)
    with pytest.raises(ValueError, match="packed int4"):
        int4_mv(wp.to(torch.int8), xq, ws, xs)
    with pytest.raises(ValueError, match="contiguous"):
        int4_mv(wp[:, :8], xq, ws, xs)
    with pytest.raises(ValueError, match="cannot hold"):
        int4_mv(wp[:, :16].contiguous(), torch.zeros(64, dtype=torch.int8, device=cuda)
                .repeat(2), ws, xs)
    with pytest.raises(ValueError, match="row scale"):
        int4_mv(wp, xq, ws.double(), xs)
    with pytest.raises(ValueError, match="vector"):
        int4_mv_t(wp, vq.cpu(), vs, 64)
    with pytest.raises(ValueError, match="activation scale"):
        int4_mv_t(wp, vq, vs.cpu(), 64)


@pytest.mark.gpu
@pytest.mark.parametrize("coupling", ["int4", "int4_master"])
def test_int4_network_on_card_matches_plain_network_on_cpu(cuda, coupling):
    # 400 steps of the bench network at n=512 through Network.run: the int4
    # kernel every step on the card, the plain version on the CPU.  The
    # integer sums are exact on both sides; the float32 amax and dynamics can
    # round otherwise and flip an activation's int8 rounding now and then
    n, steps = 512, 400
    rng = np.random.default_rng(17)
    W = (rng.random((n, n)) < 0.1) / (0.1 * n)
    etas = rng.normal(size=n) * 50.0 + 20000.0
    inp = np.zeros((steps, 1))
    inp[100:300] = 3.0
    obs, launches = {}, {}
    for device in (cuda, "cpu"):
        net = Network(1e-4, device=device)
        net.add_diffeq_node(
            "qif", "rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa", weights=W,
            source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
            spike_var="spike", spike_def="v", op="qif_sfa_op",
            node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/k": 15.0},
            coupling_dtype=coupling)
        net.add_func_node("inp", 1, activation_function="tanh")
        net.add_edge("inp", "qif", weights=np.ones((n, 1)))
        before = int4_mv.launches
        obs[str(device)] = net.run(inp, sampling_steps=10, record_vars=[("qif", "v", False)],
                                   verbose=False)
        launches[str(device)] = int4_mv.launches - before
    assert launches == {str(cuda): steps, "cpu": 0}
    a, b = obs["cpu"], obs[str(cuda)]
    assert a.to_numpy("out").max() > 0.0, "no spiking activity -- weak test"
    np.testing.assert_allclose(b.to_numpy("out"), a.to_numpy("out"), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b.to_numpy(("qif", "v")), a.to_numpy(("qif", "v")),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_int4_master_fit_on_card_matches_plain_fit_on_cpu(cuda):
    # the int4_master training path on the card (int4_mv and int4_mv_t every
    # step) against the same float32 fit on the CPU, as the int8_master fit
    # test holds its own: losses within rtol 1e-4
    n, T = 64, 120
    rng = np.random.default_rng(31)
    W = rng.normal(size=(n, n)) / np.sqrt(n)
    etas = rng.uniform(5.0, 15.0, n)
    inp, tgt = rng.normal(size=(T, 1)) * 5 + 10, rng.normal(size=(T, n)) * 0.1
    res = {}
    for device in (cuda, "cpu"):
        net = Network(5e-3, device=device)
        net.add_diffeq_node(
            "rnn", "rectipy_tpu_torch.models.spiking_neurons.qif.qif", weights=W,
            input_var="I_ext", output_var="s", source_var="s", target_var="s_in", op="qif_op",
            spike_var="spike", spike_def="v", spike_threshold=100.0, spike_reset=-100.0,
            node_vars={"all/qif_op/eta": etas}, coupling_dtype="int4_master",
            train_params=["weights"])
        before = (int4_mv.launches, int4_mv_t.launches)
        obs = net.fit_bptt([inp] * 3, [tgt] * 3, optimizer="adam", lr=1e-2, verbose=False)
        after = (int4_mv.launches, int4_mv_t.launches)
        assert net.last_fit == {"trajectory": "chain", "fused_adam": False}
        res[str(device)] = (np.asarray(obs["epoch_loss"]),
                            net.get_node("rnn")["weights"].cpu().numpy(),
                            tuple(a - b for a, b in zip(after, before)))
    card = res[str(cuda)]
    assert card[2] == (3 * T, 3 * T) and res["cpu"][2] == (0, 0)
    np.testing.assert_allclose(card[0], res["cpu"][0], rtol=1e-4)
    np.testing.assert_allclose(card[1], res["cpu"][1], rtol=1e-3, atol=1e-4)
    assert not np.array_equal(card[1], W.astype(np.float32)), "nothing trained"


# ---------------------------------------------------- fused adam + requant
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(37, 1003), (1000, 1000), (16, 38)])
@pytest.mark.parametrize("count", [1, 7])
def test_adam_requant_kernel_matches_plain(cuda, shape, count):
    w, m, v, g, bc1, bc2, lr = adam_inputs(*shape, count, 21, cuda)
    before = adam_requant.launches
    got = adam_requant(w, m, v, g, bc1, bc2, lr, **ADAM_KW)
    torch.cuda.synchronize()
    assert adam_requant.launches == before + 1
    ref = adam_requant_plain(w, m, v, g, bc1, bc2, lr, **ADAM_KW)
    check_adam_requant(got, ref, w)


@pytest.mark.gpu
def test_adam_requant_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    w, m, v, g, bc1, bc2, lr = adam_inputs(8, 16, 1, 22, cuda)
    with pytest.raises(ValueError, match="float32"):
        adam_requant(w.double(), m, v, g, bc1, bc2, lr, **ADAM_KW)
    with pytest.raises(ValueError, match="contiguous"):
        adam_requant(w, m.t().contiguous().t(), v, g, bc1, bc2, lr, **ADAM_KW)
    with pytest.raises(ValueError, match="on cpu"):
        adam_requant(w, m, v, g.cpu(), bc1, bc2, lr, **ADAM_KW)
    with pytest.raises(TypeError, match="Python number"):
        adam_requant(w, m, v, g, torch.tensor(bc1), bc2, lr, **ADAM_KW)


@pytest.mark.gpu
def test_fit_bptt_on_card_matches_plain_fit_on_cpu(cuda, monkeypatch):
    # the training path on the card (int8 kernels every step, the fused adam
    # kernel every epoch) against the same float32 fit on the CPU through the
    # plain versions.  The int8 sums are exact on both sides; the float32
    # means and the dW matmul sum in other orders, which can flip an int8
    # rounding now and then: losses within rtol 1e-4
    n, T = 64, 120
    rng = np.random.default_rng(30)
    W = rng.normal(size=(n, n)) / np.sqrt(n)
    etas = rng.uniform(5.0, 15.0, n)
    inp, tgt = rng.normal(size=(T, 1)) * 5 + 10, rng.normal(size=(T, n)) * 0.1
    res = {}
    monkeypatch.setenv("RECTIPY_FUSED_ADAM", "on")
    for device in (cuda, "cpu"):
        net = Network(5e-3, device=device)
        net.add_diffeq_node(
            "rnn", "rectipy_tpu_torch.models.spiking_neurons.qif.qif", weights=W,
            input_var="I_ext", output_var="s", source_var="s", target_var="s_in", op="qif_op",
            spike_var="spike", spike_def="v", spike_threshold=100.0, spike_reset=-100.0,
            node_vars={"all/qif_op/eta": etas}, coupling_dtype="int8_master",
            train_params=["weights"])
        before = (adam_requant.launches, int8_mv.launches, int8_mv_t.launches)
        obs = net.fit_bptt([inp] * 3, [tgt] * 3, optimizer="adam", lr=1e-2, verbose=False)
        after = (adam_requant.launches, int8_mv.launches, int8_mv_t.launches)
        assert net.last_fit == {"trajectory": "chain", "fused_adam": True}
        res[str(device)] = (np.asarray(obs["epoch_loss"]), net.get_node("rnn")["weights"].cpu().numpy(),
                     tuple(a - b for a, b in zip(after, before)))
    card = res[str(cuda)]
    assert card[2] == (3, 3 * T, 3 * T) and res["cpu"][2] == (0, 0, 0)
    np.testing.assert_allclose(card[0], res["cpu"][0], rtol=1e-4)
    np.testing.assert_allclose(card[1], res["cpu"][1], rtol=1e-3, atol=1e-4)
    assert not np.array_equal(card[1], W.astype(np.float32)), "nothing trained"


@pytest.mark.parametrize("fault", ["no_bias_correction", "no_update"])
def test_adam_check_fails_a_kernel_that_drops_part_of_the_step(fault):
    # needs no card: the plain version against a faulty copy of itself; the
    # check the card's kernel is held to must refuse it
    w, m, v, g, bc1, bc2, lr = adam_inputs(16, 38, 7, 23, "cpu")
    ref = adam_requant_plain(w, m, v, g, bc1, bc2, lr, **ADAM_KW)
    if fault == "no_bias_correction":
        bad = adam_requant_plain(w, m, v, g, 1.0, 1.0, lr, **ADAM_KW)
    else:
        bad = adam_requant_plain(w, m, v, g, bc1, bc2, 0.0, **ADAM_KW)
    check_adam_requant(ref, ref, w)
    with pytest.raises(AssertionError):
        check_adam_requant(bad, ref, w)


# ------------------------------------------------------ generic fused step
def _generic_node(case, n, device, coupling_dtype="float32", attach=True):
    """``GENERIC_CASES[case]`` at n with a dense row-normalised W, so that a
    coupling sum averages its source (about 0.5 for a U(0, 1) source)."""
    rng = np.random.default_rng(40)
    W = rng.random((n, n))
    W /= W.sum(axis=1, keepdims=True)
    return generic_case_net(case, W, device, coupling_dtype=coupling_dtype, attach=attach)


def _generic_launch(node, w_dtype, inputs):
    """The kernel (or, on CPU tensors, its plain version) and the plain
    version on the same inputs, with W in ``w_dtype``."""
    step, srcs, drive, states, vecs = inputs
    Ws = [node.args[f"__w_fused_{c}__"].to(w_dtype) for c in range(len(step.targets))]
    before = generic_fused_step.launches
    got = generic_fused_step(step, srcs, Ws, drive, states, vecs)
    if got.is_cuda:
        torch.cuda.synchronize()
        assert generic_fused_step.launches == before + 1
    ref = generic_fused_step_plain(step, srcs, Ws, drive, states, vecs)
    return got, ref, Ws


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 1003, 37])  # 16-byte vector loop / scalar loop
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(GENERIC_CASES))
def test_generic_kernel_matches_plain_version(cuda, case, n, w_dtype):
    # every node class and mode: spike-tested states spread across the
    # threshold, so the reset masks must be equal and some neurons reset
    _, node = _generic_node(case, n, cuda)
    inputs = generic_inputs(node, seed=1)
    got, ref, _ = _generic_launch(node, w_dtype, inputs)
    _, resets = check_generic(got, ref, inputs[0])
    if any(hard for _, _, hard, _ in inputs[0].spike_specs):
        assert resets > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 1003, 37])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_generic_kernel_coupling_case(cuda, n, w_dtype):
    # v' = s_in + O(1e-3): the check sees the matvec
    _, node = _generic_node("qif_sfa", n, cuda)
    inputs = generic_inputs(node, seed=2, coupling=True)
    got, ref, Ws = _generic_launch(node, w_dtype, inputs)
    check_generic(got, ref, inputs[0], case="coupling")
    assert lost_eighth_margin(*inputs[:2], Ws, *inputs[2:], ref) > 1.0


@pytest.mark.parametrize("n", [1000, 1003, 37])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_generic_coupling_tolerance_fails_a_lost_eighth_of_the_row_sum(n, w_dtype):
    # needs no card: the plain version on CPU tensors; the coupling case's
    # tolerance must fail every row if every eighth term of the sums is lost
    _, node = _generic_node("qif_sfa", n, "cpu")
    inputs = generic_inputs(node, seed=2, coupling=True)
    got, ref, Ws = _generic_launch(node, w_dtype, inputs)
    check_generic(got, ref, inputs[0], case="coupling")
    assert lost_eighth_margin(*inputs[:2], Ws, *inputs[2:], ref) > 1.0


@pytest.mark.parametrize("fault", ["reset_value", "no_drive", "no_coupling"])
def test_generic_check_fails_a_kernel_that_drops_part_of_the_step(fault):
    # needs no card: a faulty copy of the plain step must fail the check
    _, node = _generic_node("lif", 64, "cpu")
    step, srcs, drive, states, vecs = generic_inputs(node, seed=5)
    Ws = [node.args["__w_fused_0__"]]
    ref = generic_fused_step_plain(step, srcs, Ws, drive, states, vecs)
    if fault == "reset_value":
        bad_step = dataclasses.replace(step, reset_val=step.reset_val + 1.0)
        bad = generic_fused_step_plain(bad_step, srcs, Ws, drive, states, vecs)
    elif fault == "no_drive":
        bad = generic_fused_step_plain(step, srcs, Ws, torch.zeros_like(drive), states, vecs)
    else:
        bad = generic_fused_step_plain(step, [torch.zeros_like(srcs[0])], Ws, drive, states,
                                       vecs)
    check_generic(ref, ref, step)
    with pytest.raises(AssertionError):
        check_generic(bad, ref, step)


@pytest.mark.gpu
def test_generic_kernel_misaligned_source_takes_the_scalar_loop(cuda):
    _, node = _generic_node("qif_sfa", 1000, cuda)
    step, srcs, drive, states, vecs = generic_inputs(node, seed=3, coupling=True)
    off = torch.cat((torch.zeros(1, device=cuda), srcs[0]))[1:]  # 4 bytes past an aligned base
    assert off.data_ptr() % 16 != 0
    Ws = [node.args["__w_fused_0__"]]
    got = generic_fused_step(step, [off], Ws, drive, states, vecs)
    ref = generic_fused_step_plain(step, srcs, Ws, drive, states, vecs)
    check_generic(got, ref, step, case="coupling")


@pytest.mark.gpu
def test_generic_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    _, node = _generic_node("lif", 64, cuda)
    step, srcs, drive, states, vecs = generic_inputs(node, seed=4)
    W = node.args["__w_fused_0__"]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        generic_fused_step(step, srcs, [W.double()], drive, states, vecs)
    with pytest.raises(ValueError, match="contiguous"):
        generic_fused_step(step, srcs, [W.t()], drive, states, vecs)
    with pytest.raises(ValueError, match="shape"):
        generic_fused_step(step, [srcs[0][:-1]], [W], drive, states, vecs)
    with pytest.raises(ValueError, match="on cpu"):
        generic_fused_step(step, srcs, [W], drive, [states[0].cpu()] + states[1:], vecs)
    with pytest.raises(ValueError, match="float32"):
        generic_fused_step(step, srcs, [W], drive.double(), states, vecs)
    with pytest.raises(ValueError, match="expected 1 couplings"):
        generic_fused_step(step, srcs * 2, [W, W], drive, states, vecs)


@pytest.mark.gpu
@pytest.mark.parametrize("coupling", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["lif", "tanh_heun"])
def test_generic_fused_network_on_card_matches_plain_network_on_cpu(cuda, case, coupling):
    # 300 steps through Network.run: the kernel on the card against the
    # plain lowered step on the CPU (f32 sums in other orders); a spiking
    # case and Heun's two derivative-mode launches per step
    n, steps = 128, 300
    inp = np.random.default_rng(41).normal(size=(steps, n))
    outs = {}
    for device in (cuda, "cpu"):
        net, node = _generic_node(case, n, device, coupling_dtype=coupling,
                                  attach=device is cuda)
        before = generic_fused_step.launches
        obs = net.run(inp, sampling_steps=10, record_output=True, verbose=False)
        launches = generic_fused_step.launches - before
        assert launches == (0 if device == "cpu" else steps * (2 if case == "tanh_heun" else 1))
        outs[str(device)] = (obs.to_numpy("out"), node.y.cpu().numpy())
    card, cpu = outs[str(cuda)], outs["cpu"]
    if case == "lif":
        assert cpu[0].max() > 0.0, "no spikes -- weak test"
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-4, atol=1e-3)


# ---------------------------------------------------- trainers and feedback


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(1000, 1), (333, 3)])
def test_rls_update_on_card_matches_cpu_float64(cuda, n, m):
    # 20 RLS updates in float64 on the card against the same updates on the
    # CPU (the same formula, matvec sums in another order); the card's
    # update never waits on the host (sync debug mode raises on a sync)
    rng = np.random.default_rng(50)
    xs, ys = rng.normal(size=(20, n)), rng.normal(size=(20, m))
    edges = {str(d): RLS(n, m, beta=0.99, alpha=2.0, device=d) for d in (cuda, "cpu")}
    for x, y in zip(xs, ys):
        for dev, e in edges.items():
            xt, yt = (torch.as_tensor(a, device=e.device) for a in (x, y))
            y_hat = e.forward(xt)
            if dev != "cpu":
                torch.cuda.set_sync_debug_mode("error")
            try:
                e.update(xt, yt, y_hat)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    card, cpu = edges[str(cuda)], edges["cpu"]
    assert card.P.dtype == torch.float64 and card.P.device.type == "cuda"
    np.testing.assert_allclose(card.weights.cpu().numpy(), cpu.weights.numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(card.P.cpu().numpy(), cpu.P.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(card.loss), float(cpu.loss), rtol=1e-10)


@pytest.mark.gpu
@pytest.mark.parametrize("coupling", ["float32", "int8_master"])
def test_step_mode_fit_on_card_matches_cpu(cuda, coupling):
    # truncated BPTT, three chunks of a tanh population through the chain
    # trajectory: on the card (int8_master: the int8 kernels every step)
    # against the same float32 fit on the CPU
    n, u = 64, 40
    rng = np.random.default_rng(51)
    W = rng.normal(size=(n, n)) / np.sqrt(n)
    inp, tgt = rng.normal(size=(3 * u, n)), rng.normal(size=(3 * u, n)) * 0.5
    res = {}
    for device in (cuda, "cpu"):
        net = Network(1e-1, device=device)
        net.add_diffeq_node("rnn", "rectipy_tpu_torch.models.rate_neurons.leaky_integrator.tanh",
                            weights=W, input_var="li_op/I_ext", output_var="tanh_op/r",
                            source_var="tanh_op/r", target_var="li_op/r_in",
                            coupling_dtype=coupling, train_params=["weights"])
        before = (int8_mv.launches, int8_mv_t.launches)
        obs = net.fit_bptt(inp, tgt, optimizer="adam", lr=1e-2, update_steps=u,
                           sampling_steps=5, verbose=False)
        launches = (int8_mv.launches - before[0], int8_mv_t.launches - before[1])
        assert net.last_fit == {"trajectory": "chain", "fused_adam": False}
        res[str(device)] = (obs.to_numpy("loss"), obs.to_numpy("out"),
                            net.get_node("rnn")["weights"].cpu().numpy(), launches)
    card, cpu = res[str(cuda)], res["cpu"]
    on_card = 3 * u if coupling == "int8_master" else 0
    assert card[3] == (on_card, on_card) and cpu[3] == (0, 0)
    assert card[0][-1] != 0.0
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(card[2], cpu[2], rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
def test_feedback_network_on_card_matches_cpu(cuda):
    # examples/feedback_populations.py at n = 128: two LIF populations with
    # the generic kernel attached (two launches per step on the card, the
    # plain version on the CPU), dense float32 feedforward and feedback
    n, steps = 128, 300
    rng = np.random.default_rng(52)
    Ws = [rng.normal(size=(n, n)) * (100 / n) for _ in range(2)]
    k = 10.0 * 100 / n
    W_ff, W_fb = k * rng.random((n, n)), -10 * k * rng.random((n, n))
    inp = np.zeros((steps, 1)) + 100.0
    outs = {}
    for device in (cuda, "cpu"):
        net = FeedbackNetwork(1e-2, device=device)
        for label, W in zip(("p1", "p2"), Ws):
            net.add_diffeq_node(label, "rectipy_tpu_torch.models.spiking_neurons.lif.lif",
                                input_var="I_ext", output_var="s", weights=W, source_var="s",
                                target_var="s_in", op="lif_op", spike_var="spike",
                                spike_def="v", coupling_dtype="bfloat16")
        net.add_edge("p1", "p2", weights=W_ff)
        net.add_edge("p2", "p1", weights=W_fb, feedback=True)
        net.compile()
        for label in ("p1", "p2"):
            attach_generic_fused_step(net.get_node(label))
        before = generic_fused_step.launches
        obs = net.run(inp, sampling_steps=10, verbose=False,
                      record_vars=[("p1", "s", True), ("p2", "s", True)])
        launches = generic_fused_step.launches - before
        assert launches == (0 if device == "cpu" else 2 * steps)
        outs[str(device)] = (obs.to_numpy(("p1", "s")), obs.to_numpy(("p2", "s")),
                             net._fb_store["p2"].cpu().numpy())
    card, cpu = outs[str(cuda)], outs["cpu"]
    assert cpu[1].max() > 0.0, "no spikes -- weak test"
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(b).max()))


# ------------------------------------------------------------ batched trials
@pytest.mark.gpu
@pytest.mark.parametrize("B,n_out,n_in,offset,route,route_t", [
    (32, 1000, 1024, 0, "mma", "mma"), (7, 1003, 999, 0, "scalar", "scalar"),
    (40, 256, 512, 0, "mma", "mma"), (1, 37, 16, 0, "mma", "mma"),
    # int8_mm_t on the tensor cores: K tails (n_out not a multiple of 32),
    # a column tail (1,000 columns: 3 strips of 256 and 232), one trial,
    # one n-tile of 7, one and two groups of 32, 33 (a group of one);
    # int8_mm there: n_in % 16 == 8 (two 8-byte loads of W, xq staged byte
    # by byte), row tails (1,003 rows: 7 strips of 128 and 107)
    (1, 1003, 1000, 0, "mma", "mma"), (7, 1003, 1000, 0, "mma", "mma"),
    (32, 1003, 1000, 0, "mma", "mma"), (33, 1003, 1000, 0, "mma", "mma"),
    (64, 1003, 1000, 0, "mma", "mma"), (32, 10000, 1000, 0, "mma", "mma"),
    (7, 10000, 1000, 0, "mma", "mma"),
    (5, 17, 264, 0, "mma", "mma"),  # n_out % 16 != 0: vq staged byte by byte
    (32, 5000, 136, 0, "mma", "mma"),  # few strips: 8 chunks of 640 rows
    (4, 20000, 64, 0, "mma", "mma"),  # chunks of 2,528 rows: two passes of the stage each
    # int8_mm on the tensor cores at the paths' N = 10,000 columns: 16-byte
    # loads and stage, a K tail of 16 bytes in the last chunk's last
    # k-block (3 chunks of 3,456 at 79 strips on an H100), n_out 1,003 and
    # 10,000, B 1 to 64
    (1, 10000, 10000, 0, "mma", "mma"), (7, 10000, 10000, 0, "mma", "mma"),
    (32, 10000, 10000, 0, "mma", "mma"), (33, 1003, 10000, 0, "mma", "mma"),
    (64, 1003, 10000, 0, "mma", "mma"),
    (32, 1003, 10000, 8, "mma", "mma"),  # W 8-byte aligned only: two 8-byte loads
    (3, 300, 40000, 0, "mma", "mma"),  # few strips: 8 chunks of 5,120 columns, three passes
    # the __dp4a instances: int8_mm_t's 4-byte loads (weights at 4 mod 8 or
    # n_in % 8 == 4), int8_mm's byte loads
    (32, 1000, 1024, 4, "scalar", "vec"), (33, 1003, 1004, 0, "scalar", "vec"),
    (7, 1003, 1000, 4, "scalar", "vec"), (32, 10000, 10000, 4, "scalar", "vec"),
    (5, 1003, 1000, 1, "scalar", "scalar"),
])
def test_int8_mm_kernels_are_bit_identical_to_plain_versions(cuda, B, n_out, n_in, offset,
                                                             route, route_t):
    # the tensor-core and __dp4a routes of int8_mm and int8_mm_t (the weights
    # may start `offset` bytes into their buffer); two groups of trials (B >
    # 32), one row.  The sums are integers, so kernel and plain version agree
    # bit for bit.
    rng = np.random.default_rng(60)
    buf = torch.empty(offset + n_out * n_in, dtype=torch.int8, device=cuda)
    wq = buf[offset:].view(n_out, n_in)
    wq.copy_(torch.as_tensor(rng.integers(-127, 128, size=(n_out, n_in)), dtype=torch.int8))
    xq = torch.as_tensor(rng.integers(-127, 128, size=(B, n_in)), dtype=torch.int8, device=cuda)
    vq = torch.as_tensor(rng.integers(-127, 128, size=(B, n_out)), dtype=torch.int8,
                         device=cuda)
    rs = torch.as_tensor(rng.random(n_out), dtype=torch.float32, device=cuda)
    act = torch.as_tensor(rng.random(B) + 0.5, dtype=torch.float32, device=cuda)
    assert int8_mm_route(n_in, wq.data_ptr()) == route
    assert int8_mm_t_route(n_in, wq.data_ptr()) == route_t
    before = (int8_mm.launches, int8_mm.mma_launches, int8_mm_t.launches,
              int8_mm_t.mma_launches)
    mm, mm_t = int8_mm(wq, xq, rs, act), int8_mm_t(wq, vq, act)
    torch.cuda.synchronize()
    assert (int8_mm.launches, int8_mm.mma_launches, int8_mm_t.launches,
            int8_mm_t.mma_launches) == (before[0] + 1, before[1] + int(route == "mma"),
                                        before[2] + 1, before[3] + int(route_t == "mma"))
    assert torch.equal(mm, (int8_mm_plain(wq, xq) * rs) * act[:, None])
    assert torch.equal(mm_t, int8_mm_t_plain(wq, vq) * act[:, None])
    assert torch.equal(mm[B - 1], int8_mv(wq, xq[B - 1], rs, act[B - 1]))


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_out,n_in,x_offset", [
    (32, 1003, 10000, 0), (33, 10000, 1024, 0), (7, 1003, 1000, 0),
    (32, 1003, 10000, 8), (7, 1003, 10000, 3),  # xq not 16-byte aligned: staged byte by byte
])
def test_int8_mm_tensor_cores_and_dp4a_instance_agree(cuda, B, n_out, n_in, x_offset):
    # int8_mm's tensor cores at any address of the activations, and its
    # "vec" __dp4a instance (16-byte loads; no route picks it, it stays as
    # the tensor cores' yardstick) through the C launch where it applies:
    # both bit for bit against the plain version
    from rectipy_tpu_torch.ops import quant

    rng = np.random.default_rng(68)
    wq = torch.as_tensor(rng.integers(-127, 128, size=(n_out, n_in)), dtype=torch.int8,
                         device=cuda)
    xbuf = torch.empty(x_offset + B * n_in, dtype=torch.int8, device=cuda)
    xq = xbuf[x_offset:].view(B, n_in)
    xq.copy_(torch.as_tensor(rng.integers(-127, 128, size=(B, n_in)), dtype=torch.int8))
    rs = torch.as_tensor(rng.random(n_out), dtype=torch.float32, device=cuda)
    act = torch.as_tensor(rng.random(B) + 0.5, dtype=torch.float32, device=cuda)
    ref = (int8_mm_plain(wq, xq) * rs) * act[:, None]
    before = int8_mm.mma_launches
    assert torch.equal(int8_mm(wq, xq, rs, act), ref)
    assert int8_mm.mma_launches == before + 1
    if n_in % 16 == 0 and xq.data_ptr() % 16 == 0:
        out = torch.empty_like(ref)
        err = quant._lib().int8_mm_launch(wq.data_ptr(), xq.data_ptr(), rs.data_ptr(),
                                          act.data_ptr(), out.data_ptr(), n_out, n_in, B,
                                          quant._ROUTES["vec"],
                                          torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0 and torch.equal(out, ref)


@pytest.mark.gpu
def test_int8_mm_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    wq = torch.zeros((64, 32), dtype=torch.int8, device=cuda)
    xq = torch.zeros((4, 32), dtype=torch.int8, device=cuda)
    one = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="activation scale"):
        int8_mm(wq, xq, torch.ones(64, device=cuda), one[:3])
    with pytest.raises(ValueError, match="activations"):
        int8_mm(wq, xq[:, :16], torch.ones(64, device=cuda), one)
    with pytest.raises(ValueError, match="activations"):
        int8_mm_t(wq, xq, one)  # (4, 32) rows for a product that takes (4, 64)


def _rows_inputs(B, n, seed, device, w_dtype, coupling):
    """B trials' states as rows of a (B, 3n) buffer (v | s | x), per-trial
    eta and inp, one W; the reset case or the coupling case of _inputs."""
    rng = np.random.default_rng(seed)
    if coupling:
        W = rng.random((n, n))
        W /= W.sum(axis=1, keepdims=True)
        y = np.concatenate([rng.normal(size=(B, n)) * 1e-3, rng.random((B, n)),
                            rng.random((B, n)) * 1e-3], axis=1)
        eta, inp = rng.normal(size=(B, n)) * 1e-3, rng.normal(size=(B, n)) * 1e-3
    else:
        W = (rng.random((n, n)) < 0.1) * 0.01
        y = np.concatenate([rng.normal(size=(B, n)) * 12.0, rng.random((B, n)),
                            rng.random((B, n))], axis=1)
        eta, inp = rng.normal(size=(B, n)), rng.normal(size=(B, n))
    W, y, eta, inp = _on(device, w_dtype, W, [y, eta, inp])
    return W, y[:, :n], y[:, n:2 * n], y[:, 2 * n:], eta, inp


@pytest.mark.gpu
@pytest.mark.parametrize("B", [5, 32, 33, 64])  # one, one full and two trial groups
# vector loads of W (bf16: the tensor cores) / scalar loads; 1,024 fills every row tile
@pytest.mark.parametrize("n", [1000, 1003, 1024])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_qif_rows_kernel_matches_plain_and_single_row_kernel(cuda, B, n, w_dtype):
    # the B-row step on strided rows of one state buffer: against its plain
    # version, and each trial against the single-row kernel on that trial;
    # an aligned bf16 W takes the tensor cores, an aligned f32 W the tiled
    # kernel, each counted apart
    mma = w_dtype == torch.bfloat16 and n % 8 == 0
    tiled = w_dtype == torch.float32 and n % 4 == 0
    for coupling, p, tol in ((False, PARAMS, dict(rtol=1e-5, atol=1e-4)),
                             (True, COUPLING_PARAMS, COUPLING_TOL)):
        W, v, s, x, eta, inp = _rows_inputs(B, n, 61, cuda, w_dtype, coupling)
        assert rows_route(W.dtype, n, s.stride(0), W.data_ptr(), s.data_ptr()) == (
            "mma" if mma else "tiled" if tiled else "scalar")
        before = (qif_sfa_step.launches, qif_sfa_step.mma_launches,
                  qif_sfa_step.tiled_launches)
        out = qif_sfa_step(v, s, x, W, eta, inp, **p)
        torch.cuda.synchronize()
        assert (qif_sfa_step.launches, qif_sfa_step.mma_launches,
                qif_sfa_step.tiled_launches) == (
            before[0] + 1, before[1] + int(mma), before[2] + int(tiled)) and out.shape == (B, 3, n)
        ref = torch.stack(qif_sfa_reference_step(v, s, x, W, eta, inp, **p), dim=-2)
        torch.testing.assert_close(out, ref, **tol)
        for b in (0, B - 1):
            one = qif_sfa_step(v[b].contiguous(), s[b].contiguous(), x[b].contiguous(), W,
                               eta[b], inp[b], **p)
            torch.testing.assert_close(out[b], one, **tol)
        if not coupling:
            assert torch.equal(out[:, 0] == p["v_reset"], ref[:, 0] == p["v_reset"])
            assert bool((out[:, 0] == p["v_reset"]).any())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [5, 32])
# N = 10,000 (125 strips of 80 rows, 79 chunks, the last of 16 inputs) and
# 1,124 (15 strips, the last of 4 rows; the last chunk of 100 inputs)
@pytest.mark.parametrize("n", [10_000, 1_124])
def test_qif_rows_tiled_and_vec_instance_agree(cuda, B, n):
    # the tiled f32 kernel and the CUDA cores' older vector instance on the same
    # operands: within the B-row tolerance of each other and of the plain
    # version, with equal reset masks; a bad route code is refused
    from rectipy_tpu_torch.ops import kernels

    for coupling, p, tol in ((False, PARAMS, dict(rtol=1e-5, atol=1e-4)),
                             (True, COUPLING_PARAMS, COUPLING_TOL)):
        W, v, s, x, eta, inp = _rows_inputs(B, n, 65, cuda, torch.float32, coupling)
        before = qif_sfa_step.tiled_launches
        new = qif_sfa_step(v, s, x, W, eta, inp, **p)
        old = qif_rows_instance("vec", W, v, s, x, eta, inp, p)
        torch.cuda.synchronize()
        assert qif_sfa_step.tiled_launches == before + 1
        ref = torch.stack(qif_sfa_reference_step(v, s, x, W, eta, inp, **p), dim=-2)
        torch.testing.assert_close(new, old, **tol)
        torch.testing.assert_close(new, ref, **tol)
        assert torch.equal(new[:, 0] == p["v_reset"], old[:, 0] == p["v_reset"])
        assert torch.equal(new[:, 0] == p["v_reset"], ref[:, 0] == p["v_reset"])
        if coupling:  # the tolerance fails a sum that lost every eighth input
            s_cut = s.clone()
            s_cut[:, ::8] = 0.0
            cut = qif_sfa_reference_step(v, s_cut, x, W, eta, inp, **p)[0]
            assert float(((cut - ref[:, 0]).abs()
                          / (tol["atol"] + tol["rtol"] * ref[:, 0].abs())).min()) > 1.0
    with pytest.raises(RuntimeError, match="CUDA error"):  # the tensor cores' code, f32 W
        qif_rows_instance("mma", W, v, s, x, eta, inp, PARAMS)
    assert kernels._ROWS_ROUTES["tiled"] == 3


@pytest.mark.gpu
def test_qif_rows_shared_operands_and_refusals(cuda):
    # an (n,) operand is one row shared by every trial (stride 0)
    B, n = 4, 256
    W, v, s, x, eta, inp = _rows_inputs(B, n, 62, cuda, torch.float32, False)
    out = qif_sfa_step(v, s, x[0].contiguous(), W, eta[1].contiguous(), inp, **PARAMS)
    ref = torch.stack(qif_sfa_reference_step(v, s, x[0], W, eta[1], inp, **PARAMS), dim=-2)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="contiguous rows"):
        qif_sfa_step(v, s, x, W, eta.t().contiguous().t(), inp, **PARAMS)
    with pytest.raises(ValueError, match="float32"):
        qif_sfa_step(v, s, x, W, eta.double(), inp, **PARAMS)


@pytest.mark.gpu
def test_qif_rows_tensor_cores_shared_operands(cuda):
    # the tensor-core route with (n,) operands shared by every trial, s
    # among them (stride 0), in the coupling case
    B, n = 37, 1024
    W, v, s, x, eta, inp = _rows_inputs(B, n, 64, cuda, torch.bfloat16, True)
    s0, x0, eta0 = s[3].contiguous(), x[0].contiguous(), eta[1].contiguous()
    before = qif_sfa_step.mma_launches
    out = qif_sfa_step(v, s0, x0, W, eta0, inp, **COUPLING_PARAMS)
    torch.cuda.synchronize()
    assert qif_sfa_step.mma_launches == before + 1
    ref = torch.stack(qif_sfa_reference_step(v, s0, x0, W, eta0, inp, **COUPLING_PARAMS),
                      dim=-2)
    torch.testing.assert_close(out, ref, **COUPLING_TOL)


def _int8_rate_net(device, coupling, W):
    # the output is the state li_op/v: an algebraic output (tanh_op/r) read
    # by run's step evaluates the lowered field, the coupling included, again
    net = Network(1e-1, device=device)
    net.add_diffeq_node("rnn", "rectipy_tpu_torch.models.rate_neurons.leaky_integrator.tanh",
                        weights=W, input_var="li_op/I_ext", output_var="li_op/v",
                        source_var="tanh_op/r", target_var="li_op/r_in",
                        coupling_dtype=coupling,
                        train_params=None if coupling in (torch.int8, "int4") else ["weights"])
    return net


@pytest.mark.gpu
@pytest.mark.parametrize("coupling", ["int8", "int8_master"])
def test_run_batch_on_card_matches_cpu(cuda, coupling):
    # B trials through one int8_mm launch per step on the card, against the
    # same batch on the CPU (plain products; the activation scales per trial)
    n, B, T = 96, 6, 50
    rng = np.random.default_rng(63)
    W = rng.normal(size=(n, n)) / np.sqrt(n)
    ins = rng.normal(size=(B, T, n)) * np.linspace(0.1, 2.0, B)[:, None, None]
    res = {}
    for device in (cuda, "cpu"):
        net = _int8_rate_net(device, torch.int8 if coupling == "int8" else coupling, W)
        before = (int8_mm.launches, int8_mm.mma_launches, int8_mv.launches)
        out = net.run_batch(ins, sampling_steps=5, record_vars=[("rnn", "li_op/v", True)])
        res[str(device)] = (out, int8_mm.launches - before[0],
                            int8_mm.mma_launches - before[1], int8_mv.launches - before[2])
    (card, n_mm, n_mma, n_mv), (cpu, _, _, _) = res[str(cuda)], res["cpu"]
    assert (n_mm, n_mma, n_mv) == (T, T, 0)  # every step's product on the tensor cores
    np.testing.assert_allclose(card["out"], cpu["out"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card[("rnn", "li_op/v")], cpu[("rnn", "li_op/v")], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("coupling", ["bfloat16", "float32"])
def test_fused_qif_run_batch_on_card_matches_cpu(cuda, coupling):
    # the B-row kernel in run_batch (one launch per step, every one on the
    # route of the node's coupling type: the tensor cores for bf16, the
    # tiled kernel for f32) with a swept eta, against the same batch on the
    # CPU
    n, B, T = 256, 5, 200
    rng = np.random.default_rng(64)
    W = rng.random((n, n)) / n
    etas = 200.0 + rng.normal(size=n) * 20.0
    sweep = etas[None, :] + np.linspace(-100.0, 100.0, B)[:, None]
    drive = rng.normal(size=(T, 1))
    res = {}
    for device in (cuda, "cpu"):
        net = Network(1e-2, device=device)
        net.add_diffeq_node("qif", "rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa",
                            weights=W, source_var="s", target_var="s_in", input_var="I_ext",
                            output_var="s", spike_var="spike", spike_def="v", op="qif_sfa_op",
                            spike_threshold=1e2, spike_reset=-1e2,
                            node_vars={"all/qif_sfa_op/eta": etas}, coupling_dtype=coupling)
        net.compile()
        attach_fused_qif_step(net.get_node("qif"))
        route = "mma_launches" if coupling == "bfloat16" else "tiled_launches"
        before = qif_sfa_step.launches, getattr(qif_sfa_step, route)
        out = net.run_batch(drive, batch_vars={("qif", "eta"): sweep}, sampling_steps=10)
        res[str(device)] = (out["out"], qif_sfa_step.launches - before[0],
                            getattr(qif_sfa_step, route) - before[1])
    assert res[str(cuda)][1:] == (T, T) and res["cpu"][1:] == (0, 0)
    card, cpu = res[str(cuda)][0], res["cpu"][0]
    assert cpu.max() > 0.0, "no spikes -- weak test"
    np.testing.assert_allclose(card, cpu, rtol=1e-4, atol=1e-4 * np.abs(cpu).max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lif", "tanh_heun", "two_couplings"])
def test_generic_fused_run_batch_on_card_matches_cpu(cuda, case):
    # the generic node in run_batch launches the B-row kernel once per step
    # (twice for Heun) for all its trials, on the tiled route (an f32
    # coupling), never the single-trial one; each trial against the plain
    # lowered step on the CPU
    n, B, steps = 128, 3, 200
    rng = np.random.default_rng(67)
    ins = rng.normal(size=(B, steps, n)) + np.linspace(0.0, 2.0, B)[:, None, None]
    outs = {}
    for device in (cuda, "cpu"):
        net, _ = _generic_node(case, n, device, attach=device is cuda)
        before = (generic_fused_rows.launches, generic_fused_rows.tiled_launches,
                  generic_fused_step.launches)
        outs[str(device)] = net.run_batch(ins, sampling_steps=10)["out"]
        launches = (generic_fused_rows.launches - before[0],
                    generic_fused_rows.tiled_launches - before[1],
                    generic_fused_step.launches - before[2])
        # f32 couplings: every B-row launch on the tiled kernel
        rows = steps * (2 if case == "tanh_heun" else 1)
        assert launches == ((0, 0, 0) if device == "cpu" else (rows, rows, 0))
    card, cpu = outs[str(cuda)], outs["cpu"]
    if case == "lif":
        assert cpu.max() > 0.0, "no spikes -- weak test"
    assert np.abs(cpu[0] - cpu[-1]).max() > 1e-3
    np.testing.assert_allclose(card, cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_fit_bptt_batch_on_card_matches_cpu(cuda):
    # an int8_master chain trained on B trials: int8_mm and int8_mm_t once
    # per step on the card, the plain products on the CPU
    n, B, T, E = 64, 4, 40, 3
    rng = np.random.default_rng(65)
    W = rng.normal(size=(n, n)) / np.sqrt(n)
    ins, tgts = rng.normal(size=(B, T, n)), rng.normal(size=(B, T, n)) * 0.5
    res = {}
    for device in (cuda, "cpu"):
        net = _int8_rate_net(device, "int8_master", W)
        before = (int8_mm.launches, int8_mm_t.launches, int8_mm.mma_launches,
                  int8_mm_t.mma_launches)
        obs = net.fit_bptt_batch(ins, tgts, n_epochs=E, optimizer="adam", lr=1e-2,
                                 verbose=False)
        launches = (int8_mm.launches - before[0], int8_mm_t.launches - before[1],
                    int8_mm.mma_launches - before[2], int8_mm_t.mma_launches - before[3])
        assert net.last_fit == {"trajectory": "chain", "fused_adam": False}
        res[str(device)] = (np.asarray(obs["epoch_loss"]),
                            net.get_node("rnn")["weights"].cpu().numpy(), launches)
    card, cpu = res[str(cuda)], res["cpu"]
    # both products of every step on the tensor cores
    assert card[2] == (T * E,) * 4 and cpu[2] == (0,) * 4
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-3, atol=1e-4)


def _same_shape(card, cpu):
    """chip_smoke.py's fused_vs_plain rule: correlation >= 0.999 and max
    |diff| <= 1% of the largest reference value.  The int4 runs need it
    against the CPU: a card and a CPU run of one int4 network part after
    some steps, single trial or batched, though their int4 products agree
    bit for bit and their quantization scales too (``ops.quant.exact_div``,
    ``test_quantization_scales_on_card_equal_cpu_bit_for_bit``): a value
    that differs in its last bit elsewhere in the step can flip an
    activation's rounding now and then (which one is not pinned down)."""
    card, cpu = np.asarray(card), np.asarray(cpu)
    assert np.corrcoef(card.ravel(), cpu.ravel())[0, 1] >= 0.999
    assert np.abs(card - cpu).max() <= 1e-2 * np.abs(cpu).max()


@pytest.mark.gpu
@pytest.mark.parametrize("coupling", ["int4", "int4_master"])
def test_batched_int4_on_card_is_refused(cuda, coupling):
    # the name is that of the refusal this replaced: int4 couplings of (B,
    # n) sources now run through int4_mm on the card, one launch a step;
    # each trial equals the card's single-trial run (int4_mm and int4_mv sum
    # exactly), and the batch follows the CPU's (see _same_shape)
    n, B, T = 96, 6, 50
    rng = np.random.default_rng(66)
    W = rng.normal(size=(n, n)) / np.sqrt(n)
    ins = rng.normal(size=(B, T, n)) * np.linspace(0.1, 2.0, B)[:, None, None]
    res = {}
    for device in (cuda, "cpu"):
        net = _int8_rate_net(device, coupling, W)
        before = (int4_mm.launches, int4_mv.launches)
        out = net.run_batch(ins, sampling_steps=5, record_vars=[("rnn", "li_op/v", True)])
        res[str(device)] = (out, int4_mm.launches - before[0], int4_mv.launches - before[1])
    (card, n_mm, n_mv), (cpu, _, _) = res[str(cuda)], res["cpu"]
    assert (n_mm, n_mv) == (T, 0)
    for b in (0, B - 1):
        one = _int8_rate_net(cuda, coupling, W).run(ins[b], sampling_steps=5, verbose=False)
        np.testing.assert_allclose(card["out"][b], one.to_numpy("out"), rtol=1e-6, atol=1e-7)
    _same_shape(card["out"], cpu["out"])
    _same_shape(card[("rnn", "li_op/v")], cpu[("rnn", "li_op/v")])


@pytest.mark.gpu
def test_int4_master_fit_bptt_batch_on_card_matches_cpu(cuda):
    # an int4_master chain trained on B trials: int4_mm and int4_mm_t once
    # per step on the card, the plain products on the CPU
    n, B, T, E = 64, 4, 40, 3
    rng = np.random.default_rng(68)
    W = rng.normal(size=(n, n)) / np.sqrt(n)
    ins, tgts = rng.normal(size=(B, T, n)), rng.normal(size=(B, T, n)) * 0.5
    res = {}
    for device in (cuda, "cpu"):
        net = _int8_rate_net(device, "int4_master", W)
        before = (int4_mm.launches, int4_mm_t.launches, int4_mv.launches, int4_mv_t.launches)
        obs = net.fit_bptt_batch(ins, tgts, n_epochs=E, optimizer="adam", lr=1e-2,
                                 verbose=False)
        launches = (int4_mm.launches - before[0], int4_mm_t.launches - before[1],
                    int4_mv.launches - before[2], int4_mv_t.launches - before[3])
        assert net.last_fit == {"trajectory": "chain", "fused_adam": False}
        res[str(device)] = (np.asarray(obs["epoch_loss"]),
                            net.get_node("rnn")["weights"].cpu().numpy(), launches)
    card, cpu = res[str(cuda)], res["cpu"]
    assert card[2] == (T * E, T * E, 0, 0) and cpu[2] == (0,) * 4
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    np.testing.assert_allclose(card[1], cpu[1], rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
def test_swept_int4_coupling_on_card_matches_cpu(cuda):
    # a per-trial int4_master coupling: packed per trial once per run, one
    # int4_mv per trial a step; each trial equals the card's single-trial
    # run with its coupling, and the batch follows the CPU's (_same_shape)
    n, B, T = 64, 3, 30
    rng = np.random.default_rng(69)
    W = rng.normal(size=(n, n)) / np.sqrt(n)
    Ws = rng.normal(size=(B, n, n)) / np.sqrt(n)
    ins = rng.normal(size=(B, T, n))
    res = {}
    for device in (cuda, "cpu"):
        net = _int8_rate_net(device, "int4_master", W)
        before = int4_mv.launches
        out = net.run_batch(ins, batch_vars={("rnn", "weights"): Ws})["out"]
        res[str(device)] = (out, int4_mv.launches - before)
    assert res[str(cuda)][1] == B * T and res["cpu"][1] == 0
    for b in (0, B - 1):
        one = _int8_rate_net(cuda, "int4_master", Ws[b]).run(ins[b], verbose=False)
        np.testing.assert_allclose(res[str(cuda)][0][b], one.to_numpy("out"), rtol=1e-6,
                                   atol=1e-7)
    _same_shape(res[str(cuda)][0], res["cpu"][0])


# ------------------------------------------------- B-row generic fused step
def _generic_rows_inputs(node, B, seed, shared_drive=False):
    """``(step, srcs, drive, states, vecs)`` for one B-row launch: trial b's
    rows are ``generic_inputs(node, seed + 1 + b)``'s; the states are strided
    rows of one (B, V*n) buffer, as the node's state is."""
    step, _, _, _, vecs = generic_inputs(node, seed)
    rows = [generic_inputs(node, seed + 1 + b)[1:4] for b in range(B)]
    V, n = len(step.state_order), node._fused_cfg["n"]
    y = torch.stack([torch.cat(st) for _, _, st in rows])
    states = list(y.reshape(B, V, n).unbind(1))
    srcs = [torch.stack([r[0][c] for r in rows]) for c in range(len(step.targets))]
    drive = torch.stack([r[1] for r in rows])
    return step, srcs, drive[0] if shared_drive else drive, states, vecs


def _rows_route(Ws, srcs):
    """:func:`generic_rows_route` of one B-row launch's operands."""
    return generic_rows_route(Ws[0].dtype, srcs[0].shape[-1],
                              [s.stride(0) if s.dim() == 2 else 0 for s in srcs],
                              [t.data_ptr() for t in list(Ws) + list(srcs)])


def _check_rows(node, w_dtype, inputs, case="reset"):
    """The B-row kernel against its plain version and, trial by trial,
    against the single-trial kernel; the launch must take
    :func:`generic_rows_route`'s instance (``mma_launches`` counts the
    tensor cores', ``tiled_launches`` the tiled kernel's).  Returns (got,
    ref, Ws)."""
    step, srcs, drive, states, vecs = inputs
    Ws = [node.args[f"__w_fused_{c}__"].to(w_dtype) for c in range(len(step.targets))]
    before = (generic_fused_rows.launches, generic_fused_rows.mma_launches,
              generic_fused_rows.tiled_launches)
    got = generic_fused_rows(step, srcs, Ws, drive, states, vecs)
    torch.cuda.synchronize()
    route = _rows_route(Ws, srcs)
    assert (generic_fused_rows.launches - before[0], generic_fused_rows.mma_launches - before[1],
            generic_fused_rows.tiled_launches - before[2]) == (1, int(route == "mma"),
                                                               int(route == "tiled"))
    ref = generic_fused_rows_plain(step, srcs, Ws, drive, states, vecs)
    for b in range(got.shape[0]):
        check_generic(got[b], ref[b], step, case)
        one = generic_fused_step(step, [s[b] if s.dim() == 2 else s for s in srcs], Ws,
                                 drive[b] if drive.dim() == 2 else drive,
                                 [s[b].contiguous() for s in states], vecs)
        check_generic(got[b], one, step, case)
    return got, ref, Ws


@pytest.mark.gpu
@pytest.mark.parametrize("B", [32, 5])
# bf16: the tensor cores / the CUDA cores' vector path / the scalar one (f32:
# the tiled kernel at 1000 and 996)
@pytest.mark.parametrize("n", [1000, 996, 37])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(GENERIC_CASES))
def test_generic_rows_kernel_matches_plain_and_single_trial_kernel(cuda, case, w_dtype, n, B):
    # every node class and mode, K = 1 and 2, Heun's derivative mode
    _, node = _generic_node(case, n, cuda)
    inputs = _generic_rows_inputs(node, B, seed=6)
    Ws = [node.args[f"__w_fused_{c}__"].to(w_dtype) for c in range(len(inputs[0].targets))]
    route = ("scalar" if n % 4 else "tiled" if w_dtype == torch.float32
             else "mma" if n % 8 == 0 else "vec")
    assert _rows_route(Ws, inputs[1]) == route
    got, ref, _ = _check_rows(node, w_dtype, inputs)
    step = inputs[0]
    if any(hard for _, _, hard, _ in step.spike_specs) and not step.derivative:
        v = next(v for _, v, hard, _ in step.spike_specs if hard)
        assert bool((ref[:, v] == step.reset_val).any())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 1003])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_generic_rows_kernel_coupling_case(cuda, n, w_dtype):
    # v' = s_in + O(1e-3) in every trial: the check sees each trial's sums
    _, node = _generic_node("qif_sfa", n, cuda)
    B = 33  # two groups of trials, the second of one
    step = generic_inputs(node, 7, coupling=True)[0]
    per = [generic_inputs(node, 8 + b, coupling=True) for b in range(B)]
    srcs = [torch.stack([p[1][0] for p in per])]
    drive = torch.stack([p[2] for p in per])
    V = len(step.state_order)
    y = torch.stack([torch.cat(p[3]) for p in per])
    states = list(y.reshape(B, V, n).unbind(1))
    got, ref, Ws = _check_rows(node, w_dtype, (step, srcs, drive, states, per[0][4]),
                               case="coupling")
    for b in (0, B - 1):
        assert lost_eighth_margin(step, [srcs[0][b]], Ws, drive[b],
                                  [s[b].contiguous() for s in states], per[0][4],
                                  ref[b]) > 1.0


@pytest.mark.gpu
def test_generic_rows_shared_and_misaligned_operands(cuda):
    # a drive shared by every trial (row stride 0), and a source 4 bytes off
    # an aligned base, which takes the scalar instantiation
    _, node = _generic_node("lif", 1000, cuda)
    _check_rows(node, torch.float32, _generic_rows_inputs(node, 7, seed=9, shared_drive=True))
    step, srcs, drive, states, vecs = _generic_rows_inputs(node, 7, seed=10)
    buf = torch.zeros(srcs[0].numel() + 1, device=cuda)
    buf[1:] = srcs[0].reshape(-1)
    off = buf[1:].reshape(srcs[0].shape)
    assert _rows_route([node.args["__w_fused_0__"]], [off]) == "scalar"
    _check_rows(node, torch.float32, (step, [off], drive, states, vecs))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [32, 5, 33])
@pytest.mark.parametrize("case", ["lif", "two_couplings", "tanh_heun"])
def test_generic_rows_tensor_cores_match_plain(cuda, case, B):
    # the bf16 tensor-core instance at K = 1 and 2, Euler and Heun's
    # derivative mode, n = 1000 (a ragged last block of rows and a ragged
    # last chunk of inputs), one or two groups of trials: one launch on the
    # tensor cores, held to the plain version and the single-trial kernel;
    # then with a source row shared by every trial (row stride 0)
    _, node = _generic_node(case, 1000, cuda)
    step, srcs, drive, states, vecs = _generic_rows_inputs(node, B, seed=12)
    before = generic_fused_rows.mma_launches
    _check_rows(node, torch.bfloat16, (step, srcs, drive, states, vecs))
    shared = [srcs[0][1]] + srcs[1:]
    _check_rows(node, torch.bfloat16, (step, shared, drive, states, vecs))
    assert generic_fused_rows.mma_launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("B", [32, 5])
@pytest.mark.parametrize("n", [10_000, 1000])  # 125 and 13 strips of 80 rows, both odd
@pytest.mark.parametrize("case", ["lif", "two_couplings", "tanh_heun"])
def test_generic_rows_tiled_and_vec_instances_agree(cuda, case, n, B):
    # the tiled f32 kernel (K = 1 and 2, Euler and Heun's derivative mode)
    # against its plain version and the CUDA cores' vector instance it
    # replaced, reached through the C entry, on the same operands: within
    # GENERIC_TOL, equal reset masks; then one of its probes launches
    step = _generic_node(case, 16, cuda)[1]._fused_cfg["step"]  # the same at any n
    rng = np.random.default_rng(13)
    srcs, drive, states, vecs = generic_rows_operands(step, n, B, rng, cuda)
    gen = torch.Generator(device=cuda).manual_seed(13)
    Ws = []
    for _ in step.targets:  # dense, row-normalised: a sum averages its U(0, 1) source
        W = torch.rand((n, n), generator=gen, device=cuda)
        Ws.append(W / W.sum(dim=1, keepdim=True))
    assert _rows_route(Ws, srcs) == "tiled"
    before = generic_fused_rows.tiled_launches
    got = generic_fused_rows(step, srcs, Ws, drive, states, vecs)
    old = generic_rows_instance(step, srcs, Ws, drive, states, vecs, "vec")()
    torch.cuda.synchronize()
    assert generic_fused_rows.tiled_launches == before + 1
    ref = generic_fused_rows_plain(step, srcs, Ws, drive, states, vecs)
    for b in range(B):
        check_generic(got[b], ref[b], step)
        check_generic(got[b], old[b], step)
    generic_rows_instance(step, srcs, Ws, drive, states, vecs, "tiled", probe=4)()
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="CUDA error"):  # the tiled kernel takes no bf16 W
        generic_rows_instance(step, srcs, [W.to(torch.bfloat16) for W in Ws], drive, states,
                              vecs, "tiled")()


@pytest.mark.gpu
def test_quantization_scales_on_card_equal_cpu_bit_for_bit(cuda):
    # PyTorch's CUDA division by a Python scalar multiplies by the
    # reciprocal; every scale of the port divides exactly (ops.quant.
    # exact_div), so on rows where the reciprocal of 7 or 127 parts from the
    # division (reciprocal_rows asserts that such rows are in the case) the
    # card's scales and integers equal the CPU's bit for bit: quantize_rows,
    # quantize_rows_i4, quant_vec and the frozen coupling's source scale
    w = torch.as_tensor(reciprocal_rows())
    card, cpu = quant_scales(w.to(cuda)), quant_scales(w)
    for name, ref in cpu.items():
        for got, want in zip(card[name], ref):
            assert got.device.type == "cuda" and torch.equal(got.cpu(), want), name


@pytest.mark.gpu
def test_generic_rows_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    _, node = _generic_node("lif", 64, cuda)
    step, srcs, drive, states, vecs = _generic_rows_inputs(node, 3, seed=11)
    W = node.args["__w_fused_0__"]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        generic_fused_rows(step, srcs, [W.double()], drive, states, vecs)
    with pytest.raises(ValueError, match="contiguous rows"):
        generic_fused_rows(step, [srcs[0].t().contiguous().t()], [W], drive, states, vecs)
    with pytest.raises(ValueError, match=r"\(3, 64\) or \(64,\)"):
        generic_fused_rows(step, srcs, [W], drive[:2], states, vecs)
    with pytest.raises(ValueError, match="float32 on"):
        generic_fused_rows(step, srcs, [W], drive, [states[0].cpu()] + states[1:], vecs)
    with pytest.raises(ValueError, match="expected 1 couplings"):
        generic_fused_rows(step, srcs * 2, [W, W], drive, states, vecs)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["qif", "generic"])
def test_fit_through_a_fused_node_raises_on_the_card(cuda, kernel):
    # a trainable input edge into a node with a fused step, and a trainable
    # readout behind it: on the CPU the generic step's plain version carries
    # the input edge's gradient (the QIF step's plain version has none: its
    # threshold is a heaviside); on the card each kernel, which has no
    # backward (nor has the JAX package's), refuses instead of cutting the
    # gradient silently
    n, T = 64, 30
    rng = np.random.default_rng(70)
    W = rng.random((n, n)) / n
    ins, tgts = rng.normal(size=(T, 2)), rng.normal(size=(T, 3)) * 0.1
    for device in (("cpu", cuda) if kernel == "generic" else (cuda,)):
        net = Network(1e-3, device=device)
        if kernel == "qif":
            net.add_diffeq_node("p", "rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa",
                                weights=W, source_var="s", target_var="s_in", input_var="I_ext",
                                output_var="s", spike_var="spike", spike_def="v",
                                op="qif_sfa_op", spike_threshold=1e2, spike_reset=-1e2)
        else:
            net.add_diffeq_node("p", "rectipy_tpu_torch.models.rate_neurons.leaky_integrator."
                                "tanh", weights=W, source_var="tanh_op/r",
                                target_var="li_op/r_in", input_var="li_op/I_ext",
                                output_var="tanh_op/r")
        net.add_func_node("inp", 2, activation_function="identity")
        net.add_func_node("out", 3, activation_function="identity")
        net.add_edge("inp", "p", weights=rng.normal(size=(n, 2)), train="gd")
        net.add_edge("p", "out", weights=rng.normal(size=(3, n)) * 0.1, train="gd")
        net.compile()
        (attach_fused_qif_step if kernel == "qif" else attach_generic_fused_step)(
            net.get_node("p"))
        w_in = net.get_edge("inp", "p").params["weights"].clone()
        if device == "cpu":
            net.fit_bptt([ins], [tgts], optimizer="sgd", lr=1.0, verbose=False)
            assert float((net.get_edge("inp", "p").params["weights"] - w_in).abs().max()) > 0
        else:
            with pytest.raises(RuntimeError, match="has no backward"):
                net.fit_bptt([ins], [tgts], optimizer="sgd", lr=1.0, verbose=False)


# ------------------------------------------------------------ int4_mm(_t)
def _int4_rows(B, n_out, n_in, seed, device, tight=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randint(-8, 8, (n_out, n_in), generator=gen, device=device, dtype=torch.int8)
    wp = pack_int4(w)
    if tight:
        wp = wp[:, :(n_in + 1) // 2].contiguous()
    scale = torch.linspace(0.1, 10.0, B, device=device)[:, None]
    xq, xs = quant_vec(torch.randn((B, n_in), generator=gen, device=device) * scale)
    vq, vs = quant_vec(torch.randn((B, n_out), generator=gen, device=device))
    ws = torch.rand(n_out, generator=gen, device=device) + 0.5
    return wp, ws, xq, xs.reshape(-1), vq, vs.reshape(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_out,n_in,tight,offset", [
    (32, 10_000, 10_000, False, 0), (7, 10_000, 10_000, False, 0), (5, 1000, 1024, False, 0),
    (5, 300, 10_000, False, 0),  # N = 10,000's 16-column tail in its last k-block, 5 trials
    (33, 1003, 2064, False, 0),  # two groups of trials, a ragged last k-block of 16 inputs
    (1, 37, 48, False, 0), (64, 256, 512, False, 0),
    (7, 1003, 999, False, 0),  # n_in % 16 != 0: the tensor cores, the activations by bytes
    (5, 999, 1003, True, 0), (32, 16, 10_000, True, 0),  # unpadded rows: the scalar paths
    (7, 1003, 1024, False, 1),  # a view of wp one byte into its buffer: the scalar int4_mm
    (3, 33, 1, False, 0), (3, 1, 33, False, 0)])
def test_int4_mm_kernels_bit_identical_to_plain(cuda, B, n_out, n_in, tight, offset):
    # integer sums are exact in any order: bit for bit, epilogues included;
    # int4_mm and int4_mm_t on the tensor cores wherever the packed rows
    # start 16-byte aligned
    wp, ws, xq, xs, vq, vs = _int4_rows(B, n_out, n_in, 71, cuda, tight)
    if offset:
        buf = torch.empty(offset + wp.numel(), dtype=torch.uint8, device=cuda)
        wp = buf[offset:].view(wp.shape).copy_(wp)
    route = int4_mm_route(wp.shape[1], wp.data_ptr())
    assert route == ("scalar" if tight or offset else "mma")
    assert int4_mm_t_route(wp.shape[1], wp.data_ptr()) == route
    counts = (lambda: (int4_mm.launches, int4_mm.mma_launches, int4_mm_t.launches,
                       int4_mm_t.mma_launches))
    before = counts()
    out, out_t = int4_mm(wp, xq, ws, xs), int4_mm_t(wp, vq, vs, n_in)
    torch.cuda.synchronize()
    mma = int(route == "mma")
    assert counts() == (before[0] + 1, before[1] + mma, before[2] + 1, before[3] + mma)
    assert torch.equal(out, (int4_mm_plain(wp, xq) * ws) * xs[:, None])
    assert torch.equal(out_t, int4_mm_t_plain(wp, vq, n_in) * vs[:, None])
    assert bool((out != 0).any()) and bool((out_t != 0).any())
    for b in (0, B - 1):  # and against the single-row kernels
        assert torch.equal(out[b], int4_mv(wp, xq[b].contiguous(), ws, xs[b]))
        assert torch.equal(out_t[b], int4_mv_t(wp, vq[b].contiguous(), vs[b], n_in))


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_out,n_in,x_offset", [
    (32, 1003, 10_000, 0), (33, 10_000, 1024, 0), (7, 1003, 1008, 0),
    (32, 1003, 10_000, 8), (7, 1003, 10_000, 3),  # xq not 16-byte aligned: staged byte by byte
])
def test_int4_mm_tensor_cores_and_dp4a_instance_agree(cuda, B, n_out, n_in, x_offset):
    # int4_mm's tensor cores at any address of the activations, and its
    # "vec" __dp4a instance (16-byte loads; no route picks it, it stays as
    # the tensor cores' yardstick) through the C launch where it applies:
    # both bit for bit against the plain version
    from rectipy_tpu_torch.ops import quant

    wp, ws, xq0, xs, _, _ = _int4_rows(B, n_out, n_in, 73, cuda)
    xbuf = torch.empty(x_offset + B * n_in, dtype=torch.int8, device=cuda)
    xq = xbuf[x_offset:].view(B, n_in).copy_(xq0)
    ref = (int4_mm_plain(wp, xq) * ws) * xs[:, None]
    before = int4_mm.mma_launches
    assert torch.equal(int4_mm(wp, xq, ws, xs), ref)
    assert int4_mm.mma_launches == before + 1
    if n_in % 16 == 0 and xq.data_ptr() % 16 == 0:
        out = torch.empty_like(ref)
        err = quant._lib4().int4_mm_launch(wp.data_ptr(), xq.data_ptr(), ws.data_ptr(),
                                           xs.data_ptr(), out.data_ptr(), n_out, n_in,
                                           wp.shape[1], B, quant._ROUTES["vec"],
                                           torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0 and torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_out,n_in,v_offset", [
    (32, 10_000, 10_000, 0), (7, 10_000, 1003, 0), (5, 1008, 10_000, 0),
    (33, 1024, 10_000, 0),  # two groups of trials
    (32, 10_000, 10_000, 8), (7, 1003, 999, 3),  # vq not 16-byte aligned: staged byte by byte
])
def test_int4_mm_t_tensor_cores_and_dp4a_instance_agree(cuda, B, n_out, n_in, v_offset):
    # int4_mm_t's tensor cores at any address of the activations, and its
    # "vec" __dp4a instance (2-byte loads of the packed rows; no route picks
    # it, it stays as the tensor cores' yardstick) through the C launch: both
    # bit for bit against the plain version
    from rectipy_tpu_torch.ops import quant

    wp, _, _, _, vq0, vs = _int4_rows(B, n_out, n_in, 74, cuda)
    vbuf = torch.empty(v_offset + B * n_out, dtype=torch.int8, device=cuda)
    vq = vbuf[v_offset:].view(B, n_out).copy_(vq0)
    ref = int4_mm_t_plain(wp, vq, n_in) * vs[:, None]
    before = int4_mm_t.mma_launches
    assert torch.equal(int4_mm_t(wp, vq, vs, n_in), ref)
    assert int4_mm_t.mma_launches == before + 1
    lib, vec = quant._lib4(), quant._ROUTES["vec"]
    assert lib.int4_mm_t_scratch(n_out, n_in, B, quant._ROUTES["mma"]) == 0
    scratch = torch.empty(lib.int4_mm_t_scratch(n_out, n_in, B, vec), dtype=torch.int32,
                          device=cuda)
    out = torch.empty_like(ref)
    err = lib.int4_mm_t_launch(wp.data_ptr(), vq.data_ptr(), vs.data_ptr(), scratch.data_ptr(),
                               out.data_ptr(), n_out, n_in, wp.shape[1], B, vec,
                               torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(out, ref)


@pytest.mark.gpu
def test_int4_mm_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    wp, ws, xq, xs, vq, vs = _int4_rows(3, 64, 64, 72, cuda)
    with pytest.raises(ValueError, match="packed int4"):
        int4_mm(wp.to(torch.int8), xq, ws, xs)
    with pytest.raises(ValueError, match="activations"):
        int4_mm(wp, xq.t().contiguous().t(), ws, xs)
    with pytest.raises(ValueError, match="activation scale"):
        int4_mm(wp, xq, ws, xs[:2])
    with pytest.raises(ValueError, match="cannot hold"):
        int4_mm_t(wp[:, :16].contiguous(), vq, vs, 64)
    with pytest.raises(ValueError, match="activations"):
        int4_mm_t(wp, vq.cpu(), vs, 64)


# the edge family on the card (no kernel of its own: PyTorch operations on the
# card's tensors), each against the same network on the CPU
_EDGE_N, _EDGE_T = 96, 120


def _edge_cases():
    rng = np.random.default_rng(80)
    n = _EDGE_N
    D = rng.integers(0, 30, size=(n, n))
    return {
        "masked": dict(mask=(rng.random((n, n)) < 0.3).astype(np.float32)),
        "delay": dict(delays=rng.integers(0, 30, size=n)),
        "filter": dict(filter_weights=np.eye(n, dtype=np.float32) * 0.5),
        "delay_filter": dict(delays=rng.integers(0, 30, size=n),
                             filter_weights=np.eye(n, dtype=np.float32) * 0.5),
        "stp": dict(tau_facil=0.5, tau_depress=0.3, U=0.3),
        "matrix_onehot": dict(delays=D, mode="onehot"),
        "matrix_factored": dict(delays=D, mode="factored"),
        "matrix_gather": dict(delays=D, mode="gather"),
        "matrix_interp_hat": dict(delays=D + 0.3, mode="interp", interp_impl="hat"),
        "matrix_interp_factored2": dict(delays=D + 0.3, mode="interp",
                                        interp_impl="factored2"),
        "matrix_factored_bf16_read": dict(delays=D, mode="factored", read_dtype="bfloat16"),
    }


def _edge_net(device, **edge_kw):
    rng = np.random.default_rng(81)
    n = _EDGE_N
    net = Network(1e-2, device=device)
    net.add_func_node("inp", n, activation_function="identity")
    net.add_diffeq_node("pop", "rectipy_tpu_torch.models.rate_neurons.leaky_integrator.tanh",
                        weights=rng.normal(size=(n, n)) * (0.5 / np.sqrt(n)),
                        input_var="li_op/I_ext", output_var="li_op/v",
                        source_var="tanh_op/r", target_var="li_op/r_in")
    net.add_edge("inp", "pop", weights=rng.normal(size=(n, n)) / np.sqrt(n), **edge_kw)
    net.compile()
    return net


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_edge_class_on_card_matches_cpu(cuda, case):
    # float32 on both: the products sum in another order, so the records
    # agree to rtol 1e-4 of the largest value; run_batch's trials too
    kw = _edge_cases()[case]
    inp = np.abs(np.random.default_rng(82).normal(size=(_EDGE_T, _EDGE_N))).astype(np.float32)
    outs = {}
    for device in ("cpu", cuda):
        net = _edge_net(device, **kw)
        out = net.run(inp, sampling_steps=5, verbose=False).to_numpy("out")
        batch = net.run_batch(np.stack([inp, inp[::-1].copy()]), sampling_steps=5)["out"]
        state = net.get_edge("inp", "pop").init_state()  # None for the masked edge
        state = state if isinstance(state, tuple) else (state,) if state is not None else ()
        outs[str(device)] = (out, batch, *[s.cpu().numpy() for s in state])
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.gpu
def test_delay_matrix_reads_are_bit_identical_on_card(cuda):
    # each read selects exactly one buffer slot: factored, onehot and gather
    # give the same records bit for bit while the products run without TF32
    D = np.random.default_rng(83).integers(0, 60, size=(_EDGE_N, _EDGE_N))
    inp = np.random.default_rng(84).normal(size=(_EDGE_T, _EDGE_N)).astype(np.float32)
    recs = {mode: _edge_net(cuda, delays=D, mode=mode).run(inp, verbose=False).to_numpy("out")
            for mode in ("factored", "onehot", "gather")}
    np.testing.assert_array_equal(recs["factored"], recs["gather"])
    np.testing.assert_array_equal(recs["onehot"], recs["gather"])


# ------------------------------------------------------ block-sparse couplings
def _block_operands(B, bs, form, device, seed):
    """block_int8_mv's operands: 6 block rows of 4 source blocks; ``form``
    'cols' indexes (B, 6, bs) sources by a node coupling's cols, 'history'
    a flat (B, 6 * 5, bs) history by cols * D1 + slot, as the delayed edge's
    read would."""
    rng = np.random.default_rng(seed)
    n_br, cb, nb_in, d1 = 6, 4, 6, 5
    bq = rng.integers(-127, 128, size=(n_br, cb, bs, bs)).astype(np.int8)
    rs = rng.random((n_br, bs)).astype(np.float32)
    cols = np.stack([rng.permutation(nb_in)[:cb] for _ in range(n_br)])
    if form == "cols":
        xq, idx = rng.integers(-127, 128, size=(B, nb_in, bs)), cols
    else:
        xq = rng.integers(-127, 128, size=(B, nb_in * d1, bs))
        idx = cols * d1 + rng.integers(0, d1, size=(n_br, cb))
    return [torch.as_tensor(a).to(device) for a in
            (bq, rs, xq.astype(np.int8), idx.astype(np.int32))]


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["cols", "history"])
@pytest.mark.parametrize("bs", [512, 32, 20])  # 16-byte pieces, and 4-byte ones
@pytest.mark.parametrize("B", [1, 3, 16, 40])  # 40: three groups of trials
def test_block_int8_mv_bit_identical_to_plain(cuda, B, bs, form):
    from rectipy_tpu_torch.ops.quant import block_int8_mv, block_int8_mv_plain

    ops = _block_operands(B, bs, form, cuda, seed=B * 1000 + bs)
    before = block_int8_mv.launches
    out = block_int8_mv(*ops)
    torch.cuda.synchronize()
    assert block_int8_mv.launches == before + 1
    assert torch.equal(out, block_int8_mv_plain(*ops))
    assert torch.equal(out.cpu(), block_int8_mv(*[t.cpu() for t in ops]))


@pytest.mark.gpu
def test_block_int8_mv_odd_block_size_takes_the_byte_route(cuda):
    from rectipy_tpu_torch.ops.quant import block_int8_mv, block_int8_mv_plain, block_int8_mv_route

    ops = _block_operands(3, 7, "cols", cuda, seed=7)
    assert block_int8_mv_route(7, ops[0].data_ptr(), ops[2].data_ptr()) == 1
    assert torch.equal(block_int8_mv(*ops), block_int8_mv_plain(*ops))


@pytest.mark.gpu
def test_block_int8_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    from rectipy_tpu_torch.ops.quant import block_int8_mv

    bq, rs, xq, idx = _block_operands(2, 32, "cols", cuda, seed=3)
    bad = [((bq.float(), rs, xq, idx), "blocks"), ((bq, rs.double(), xq, idx), "row scale"),
           ((bq, rs, xq[:, :, :16].contiguous(), idx), "activations"),
           ((bq, rs, xq, idx.long()), "index")]
    for args, what in bad:
        with pytest.raises(ValueError, match=what):
            block_int8_mv(*args)
    with pytest.raises(ValueError):  # mixed devices
        block_int8_mv(bq, rs.cpu(), xq, idx)


def _block_qif(device, coupling, n=2048):
    from rectipy_tpu_torch import block_random_connectivity

    A = block_random_connectivity(n, n, 200, block_size=256, seed=4)
    A.blocks *= 20.0
    etas = -5.0 + np.tan((np.pi / 2) * (2.0 * np.arange(1, n + 1) - n - 1) / (n + 1))
    net = Network(1e-4, device=device)
    net.add_diffeq_node(
        "qif", "rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa", weights=A,
        source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
        spike_var="spike", spike_def="v", op="qif_sfa_op",
        node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/k": 15.0},
        coupling_dtype=coupling)
    net.compile()
    return net, etas


@pytest.mark.gpu
@pytest.mark.parametrize("coupling", ["float32", "bfloat16", "int8", "int8_master",
                                      "bfloat16_master"])
def test_block_coupled_node_on_card_matches_cpu(cuda, coupling):
    # run and an eta sweep through run_batch, card against CPU (float32;
    # the int8 sums exact on both sides, float sums in another order);
    # an int8 coupling launches block_int8_mv once a step
    from rectipy_tpu_torch.ops.quant import block_int8_mv

    inp = np.full((300, 1), 3.0, dtype=np.float32)
    kw = dict(sampling_steps=10, record_vars=[("qif", "v", True)], record_output=False)
    outs = {}
    for device in ("cpu", cuda):
        net, etas = _block_qif(device, coupling)
        before = block_int8_mv.launches
        out = net.run(inp, verbose=False, **kw).to_numpy(("qif", "v"))
        if device is cuda:
            want = 300 if coupling in ("int8", "int8_master") else 0
            assert block_int8_mv.launches - before == want
        sweep = {("qif", "eta"): np.linspace(-1.0, 1.0, 3)[:, None] + etas}
        batch = net.run_batch(inp, batch_vars=sweep, **kw)[("qif", "v")]
        outs[str(device)] = (out, batch)
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.gpu
@pytest.mark.parametrize("block_dtype", [None, "bfloat16", "int8_master"])
def test_delayed_block_edge_chunked_run_on_card(cuda, block_dtype):
    # the circular history continues across runs bit for bit on the card,
    # and the records follow the CPU's
    from rectipy_tpu_torch import block_random_connectivity

    n = 2048
    A = block_random_connectivity(n, n, 200, block_size=256, seed=5)
    d_blk = np.random.default_rng(6).integers(0, 12, size=A.cols.shape)
    etas = 1000.0 + 200.0 * np.random.default_rng(1).standard_normal(n)

    def build(device):
        net = FeedbackNetwork(1e-3, device=device)
        net.add_diffeq_node(
            "qif", "rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa", n=n,
            input_var="I_ext", output_var="s", spike_var="spike", spike_def="v",
            op="qif_sfa_op", node_vars={"all/qif_sfa_op/eta": etas})
        net.add_edge("qif", "qif", weights=A, delays=d_blk, feedback=True,
                     block_dtype=block_dtype)
        net.compile()
        return net

    inp = np.full((200, 1), 3.0, dtype=np.float32)
    kw = dict(sampling_steps=10, record_vars=[("qif", "v", True)], record_output=False,
              verbose=False)
    full = build(cuda).run(inp, **kw).to_numpy(("qif", "v"))
    net = build(cuda)
    parts = [net.run(inp[:100], **kw).to_numpy(("qif", "v")),
             net.run(inp[100:], **kw).to_numpy(("qif", "v"))]
    np.testing.assert_array_equal(np.concatenate(parts), full)
    want = build("cpu").run(inp, **kw).to_numpy(("qif", "v"))
    np.testing.assert_allclose(full, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
