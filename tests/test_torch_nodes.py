"""The port's surrogate spike and nodes against the JAX package (CPU, seeded numpy inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu.nodes import InstantNode as JInstantNode
from rectipy_tpu.nodes import RateNet as JRateNet
from rectipy_tpu.nodes import SpikeResetNet as JSpikeResetNet
from rectipy_tpu.ops.surrogate import make_spike_fn as j_make_spike_fn
from rectipy_tpu_torch.nodes import InstantNode, RateNet, SpikeResetNet, resolve_dtype
from rectipy_tpu_torch.ops.surrogate import default_spike_slope, make_spike_fn

QIF = "neuron_model_templates.spiking_neurons.qif.qif_sfa"
LI_TANH = "neuron_model_templates.rate_neurons.leaky_integrator.tanh"


@pytest.mark.parametrize("slope,center", [(10.0, 1.0), (0.5, 0.0), (100.0 / 200.0, 0.5)])
def test_surrogate_forward_and_gradient_match_jax(slope, center):
    # float64, closed-form on both sides: equal to rounding
    rng = np.random.default_rng(0)
    x = np.concatenate([[-1.0, -1e-8, 0.0, 1e-8, 2.0], rng.normal(size=11)])
    g = rng.normal(size=x.shape)
    xt = torch.tensor(x, requires_grad=True)
    out = make_spike_fn(slope, center)(xt)
    out.backward(torch.tensor(g))
    jfn = j_make_spike_fn(slope, center)
    j_out, vjp = jax.vjp(jfn, jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(j_out))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-14)
    assert out[2].item() == center  # heaviside(0) takes the center value


def test_default_spike_slope():
    assert default_spike_slope(1e2, -1e2) == pytest.approx(0.5)


def _build_pair(n, rng, dtype_t=torch.float64, dtype_j=jnp.float64):
    W = rng.random((n, n)) * (rng.random((n, n)) < 0.3) * 0.5
    eta = rng.normal(size=n) * 2.0 + 40.0
    kw = dict(weights=W, source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
              spike_var="spike", reset_var="v", spike_threshold=20.0, spike_reset=-20.0,
              dt=5e-3, node_vars={"all/qif_sfa_op/eta": eta, "all/qif_sfa_op/alpha": 0.3})
    t = SpikeResetNet.from_pyrates(QIF, dtype=dtype_t, device="cpu", **kw)
    j = JSpikeResetNet.from_pyrates(QIF, dtype=dtype_j, **kw)
    return t, j


def test_spike_reset_net_trajectory_matches_jax_f64():
    # float64 on both sides: the trajectories agree to near rounding over 200
    # steps (1e-9 leaves room for the matvec's summation order, amplified by
    # the v^2 term); the spike/reset decisions must be identical
    n = 24
    rng = np.random.default_rng(1)
    t, j = _build_pair(n, rng)
    drive = rng.normal(size=(200, n)) * 5.0
    j_step = jax.jit(j.make_step())
    t_step = t.make_step()
    yt, yj = t.y, j.y
    spikes = 0
    for k in range(200):
        yt, ot = t_step(yt, t.args, torch.as_tensor(drive[k]))
        yj, oj = j_step(yj, j.args, jnp.asarray(drive[k]))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-9, atol=1e-9)
        spikes += int((yt[:n] == -20.0).sum())
        np.testing.assert_array_equal(yt[:n].numpy() == -20.0, np.asarray(yj[:n]) == -20.0)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-9, atol=1e-9)
    assert spikes > n, "too few spikes for a meaningful reset test"


def test_spike_reset_gradient_flows_through_surrogate():
    n = 4
    node = SpikeResetNet.from_pyrates(
        "neuron_model_templates.spiking_neurons.qif.qif", weights=np.zeros((n, n)),
        source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
        spike_var="spike", reset_var="v", spike_threshold=5.0, spike_reset=-5.0,
        dt=1e-2, node_vars={"all/qif_op/eta": 3.0}, dtype=torch.float64, device="cpu")
    step = node.make_step()
    eta = torch.tensor(3.0, dtype=torch.float64, requires_grad=True)
    args = dict(node.args)
    args["qif_op/eta"] = eta
    y, loss = node.y, 0.0
    for _ in range(500):
        y, out = step(y, args, torch.zeros(n, dtype=torch.float64))
        loss = loss + (out ** 2).sum()
    loss.backward()
    assert torch.isfinite(eta.grad) and eta.grad.abs() > 0.0


def test_rate_net_algebraic_output_matches_jax_f64():
    # float64 both sides, 200 Euler steps of a coupled tanh population
    n = 10
    rng = np.random.default_rng(2)
    W = rng.normal(size=(n, n)) * 0.3
    kw = dict(weights=W, source_var="tanh_op/r", target_var="li_op/r_in",
              input_var="li_op/I_ext", output_var="tanh_op/r", dt=1e-2,
              node_vars={"all/li_op/tau": rng.uniform(1.0, 2.0, n)})
    t = RateNet.from_pyrates(LI_TANH, dtype=torch.float64, device="cpu", **kw)
    j = JRateNet.from_pyrates(LI_TANH, dtype=jnp.float64, **kw)
    drive = rng.normal(size=(200, n))
    for k in range(200):
        ot = t.forward(drive[k])
        oj = j.forward(drive[k])
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t["out"].numpy(), np.asarray(j["out"]), rtol=1e-12)


def test_raw_mode_rate_net_matches_jax_and_dsl():
    # a hand-written vector field addressed by argument index (RectiPy's
    # test seam), float64 on both sides; equal to the DSL-built node too
    n, dt = 10, 1e-3
    rng = np.random.default_rng(6)
    W = rng.normal(size=(n, n))
    inp = rng.normal(size=n)

    def t_rate(t, y, I_ext, weights, tau):
        return -y / tau + I_ext + weights @ torch.tanh(y)

    def j_rate(t, y, I_ext, weights, tau):
        return -y / tau + I_ext + weights @ jnp.tanh(y)

    t = RateNet(t_rate, (np.zeros(n), np.zeros(n), W, 10.0), {"out": [0, n]}, {"in": 0},
                dt=dt, dtype=torch.float64, device="cpu")
    j = JRateNet(j_rate, (jnp.zeros(n), jnp.zeros(n), jnp.asarray(W), 10.0), {"out": [0, n]},
                 {"in": 0}, dt=dt, dtype=jnp.float64)
    dsl = RateNet.from_pyrates(LI_TANH, weights=W, source_var="tanh_op/r",
                               target_var="li_op/r_in", input_var="li_op/I_ext",
                               output_var="li_op/v", dt=dt, dtype=torch.float64, device="cpu")
    for _ in range(10):
        ot = t.forward(inp)
        np.testing.assert_allclose(ot.numpy(), np.asarray(j.forward(jnp.asarray(inp))),
                                   rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(ot.numpy(), dsl.forward(inp).numpy(), rtol=1e-12, atol=1e-12)
    assert RateNet(t_rate, (np.zeros(n), np.zeros(n), W, 10.0), {"out": [0, 3]}, {"in": 0},
                   device="cpu").forward(inp).shape == (3,)


@pytest.mark.parametrize("func", ["tanh", "sigmoid", "softmax", "softmin", "log_softmax",
                                  "identity"])
def test_instant_node_matches_jax(func):
    rng = np.random.default_rng(3)
    x = rng.normal(size=7)
    got = InstantNode(7, func).forward(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(JInstantNode(7, func).forward(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-15)


def test_instant_node_rejects_unknown_function():
    with pytest.raises(ValueError):
        InstantNode(3, "relu6_not_a_thing")


def test_reset_zeroes_and_indexed_reset():
    rng = np.random.default_rng(4)
    t, _ = _build_pair(6, rng)
    t.forward(np.ones(6))
    y_before = t.y.clone()
    t.reset(np.full(6, 7.0), idx=np.arange(6))
    assert torch.equal(t.y[:6], torch.full((6,), 7.0, dtype=torch.float64))
    assert torch.equal(t.y[6:], y_before[6:])
    t.reset()
    assert torch.count_nonzero(t.y) == 0
    with pytest.raises(ValueError):
        t.reset(np.zeros(3))
    with pytest.raises(ValueError):
        t.reset(np.zeros(1), idx=[99])


def test_set_param_and_getitem():
    rng = np.random.default_rng(5)
    t, _ = _build_pair(5, rng)
    t.set_param("eta", np.arange(5.0))
    np.testing.assert_array_equal(t["eta"].numpy(), np.arange(5.0))
    assert t["v"].shape == (5,)
    with pytest.raises(KeyError):
        t.set_param("no_such_param", 1.0)


@pytest.mark.parametrize("case", ["heun_int4", "spike_reset_bf16_master", "block_sparse"])
def test_unported_node_features_raise(case):
    # the int4 and bfloat16_master couplings are ported: a Heun RateNet with
    # a frozen int4 coupling and a SpikeResetNet with a bfloat16_master one
    # step as JAX's do (float64; the same carrier and scales, exact integer
    # sums; bf16 products exact, float32 sums in another order: rtol 1e-6).
    # An int4 block-sparse coupling raises, as in the JAX package
    # (tests/test_dsl.py:606)
    if case == "block_sparse":
        from rectipy_tpu.ops.sparse import BlockSparseCoupling

        blocks = np.random.default_rng(0).normal(size=(2, 1, 3, 3))
        with pytest.raises(NotImplementedError, match="dense-only"):
            RateNet.from_pyrates(LI_TANH, input_var="li_op/I_ext", output_var="li_op/v",
                                 weights=BlockSparseCoupling(blocks, np.asarray([[0], [1]])),
                                 source_var="tanh_op/r", target_var="li_op/r_in",
                                 integrator="heun", coupling_dtype="int4", device="cpu")
        return
    n = 6
    rng = np.random.default_rng(6)
    W = rng.normal(size=(n, n)) * 0.5
    if case == "heun_int4":
        kw = dict(input_var="li_op/I_ext", output_var="li_op/v", weights=W,
                  source_var="tanh_op/r", target_var="li_op/r_in", integrator="heun",
                  coupling_dtype="int4")
        t = RateNet.from_pyrates(LI_TANH, dtype=torch.float64, device="cpu", **kw)
        j = JRateNet.from_pyrates(LI_TANH, dtype=jnp.float64, **kw)
        t.args["weights__scale"] = torch.as_tensor(np.array(j.args["weights__scale"]))
        tol = dict(rtol=1e-12, atol=1e-14)
    else:
        kw = dict(input_var="I_ext", output_var="s", weights=np.abs(W), source_var="s",
                  target_var="s_in", spike_var="spike", reset_var="v", spike_threshold=20.0,
                  spike_reset=-20.0, dt=5e-3, coupling_dtype="bfloat16_master",
                  node_vars={"all/qif_sfa_op/eta": rng.normal(size=n) * 2.0 + 40.0})
        t = SpikeResetNet.from_pyrates(QIF, dtype=torch.float64, device="cpu", **kw)
        j = JSpikeResetNet.from_pyrates(QIF, dtype=jnp.float64, **kw)
        tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(t.args["weights"].numpy(), np.asarray(j.args["weights"]))
    t_step, j_step = t.make_step(), jax.jit(j.make_step())
    yt, yj = t.y, j.y
    for k in range(60):
        x = rng.normal(size=n) * 5.0
        yt, ot = t_step(yt, t.args, torch.as_tensor(x))
        yj, oj = j_step(yj, j.args, jnp.asarray(x))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **tol)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **tol)


@pytest.mark.parametrize("spec,expect", [(None, torch.float32), ("float64", torch.float64),
                                         (jnp.bfloat16, torch.bfloat16), (np.float32, torch.float32),
                                         (torch.float16, torch.float16)])
def test_resolve_dtype(spec, expect):
    assert resolve_dtype(spec) == expect
