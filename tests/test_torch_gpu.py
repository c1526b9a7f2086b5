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

from rectipy_tpu_torch import Network, attach_fused_qif_step
from rectipy_tpu_torch.ops.fused_opt import adam_requant, adam_requant_plain
from rectipy_tpu_torch.ops.generic_fused import generic_fused_step, generic_fused_step_plain
from rectipy_tpu_torch.ops.kernels import qif_sfa_reference_step, qif_sfa_step
from rectipy_tpu_torch.ops.quant import (int4_dot_plain, int4_dot_t_plain, int4_mv, int4_mv_t,
                                         int4_vector_path, int8_dot_plain, int8_dot_t_plain,
                                         int8_mv, int8_mv_t, pack_int4, quant_vec, quantize_rows)
from rectipy_tpu_torch.testing import (ADAM_KW, GENERIC_CASES, adam_inputs, check_adam_requant,
                                       check_generic, generic_case_net, generic_inputs,
                                       lost_eighth_margin)

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
