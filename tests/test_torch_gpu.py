"""The port's CUDA kernel on the card, against its plain PyTorch version.

The ``gpu``-marked tests need a CUDA device and skip without one.  The file
imports neither JAX nor the JAX package, so it also runs where only PyTorch
is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from rectipy_tpu_torch import Network, attach_fused_qif_step
from rectipy_tpu_torch.ops.kernels import qif_sfa_reference_step, qif_sfa_step

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
