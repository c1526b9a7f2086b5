"""The port's ``LinearSTP`` (Tsodyks-Markram short-term plasticity) against
the JAX package's, mirroring ``tests/test_stp.py`` (all but its mesh and
checkpoint cases, which wait for ROADMAP Queue 1 entries J and I): the step
against the numpy oracle of the documented rule and against the JAX edge,
paired-pulse facilitation, frequency-dependent depression, ``Network.run``
against the eager forward loop, chunked runs, the ``add_edge`` dispatch and
its errors, and BPTT through the ``(u, x)`` state.  Float64, the same
seeded numpy inputs through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.edges import LinearSTP as JLinearSTP
from rectipy_tpu_torch import LinearSTP, Network

TANH = "rate_neurons.leaky_integrator.tanh"
PREFIX = {"jax": "rectipy_tpu.models.", "torch": "rectipy_tpu_torch.models."}


def _numpy_stp(W, r_seq, dt, tau_f, tau_d, U):
    """test_stp.py's independent oracle of the documented update."""
    n_in = W.shape[-1] if W.ndim == 2 else W.shape[0]
    u = np.full(n_in, U)
    x = np.ones(n_in)
    d_f = np.exp(-dt / tau_f) if tau_f > 0 else 0.0
    d_d = np.exp(-dt / tau_d) if tau_d > 0 else 0.0
    outs = []
    for r in r_seq:
        m = np.clip(r * dt, 0.0, 1.0)
        u_plus = u + U * (1.0 - u) * m if tau_f > 0 else u
        drive = u_plus * x * r
        x_minus = x * (1.0 - u_plus * m) if tau_d > 0 else x
        u = U + (u_plus - U) * d_f
        x = 1.0 + (x_minus - 1.0) * d_d
        outs.append(W @ drive if W.ndim == 2 else W * drive)
    return np.stack(outs), u, x


def _edge(n_in, n_out, dtype=torch.float64, **kw):
    return LinearSTP(n_in, n_out, dtype=dtype, device="cpu", **kw)


def _scan(edge, r_seq):
    step, state = edge.make_step(), edge.init_state()
    outs = []
    for r in r_seq:
        state, y = step(state, edge.params, torch.as_tensor(r))
        outs.append(y.numpy())
    return np.stack(outs), state


def test_step_matches_numpy_oracle_and_jax():
    # test_stp.py:47
    rng = np.random.default_rng(7)
    n_in, n_out, T, dt = 5, 3, 80, 0.1
    W = rng.normal(size=(n_out, n_in))
    r_seq = np.abs(rng.normal(size=(T, n_in))) * 3.0
    for tau_f, tau_d in ((50.0, 200.0), (0.0, 150.0), (80.0, 0.0)):
        kw = dict(dt=dt, weights=W, tau_facil=tau_f, tau_depress=tau_d, U=0.3)
        outs, (u, x) = _scan(_edge(n_in, n_out, **kw), r_seq)
        ref, u_ref, x_ref = _numpy_stp(W, r_seq, dt, tau_f, tau_d, 0.3)
        np.testing.assert_allclose(outs, ref, rtol=1e-10)
        np.testing.assert_allclose(u.numpy(), u_ref, rtol=1e-10)
        np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-10)
        j = JLinearSTP(n_in, n_out, dtype=jnp.float64, **kw)
        jstep, jstate = j.make_step(), j.init_state()
        jouts = []
        for r in r_seq:
            jstate, y = jstep(jstate, j.params, jnp.asarray(r))
            jouts.append(np.asarray(y))
        np.testing.assert_allclose(outs, np.stack(jouts), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(x.numpy(), np.asarray(jstate[1]), rtol=1e-12)


def test_diagonal_weights_oracle():
    # test_stp.py:67
    rng = np.random.default_rng(2)
    n, T, dt = 6, 40, 0.05
    g = rng.normal(size=n)
    r_seq = np.abs(rng.normal(size=(T, n)))
    outs, _ = _scan(_edge(n, n, dt=dt, weights=g, tau_facil=30.0, tau_depress=90.0, U=0.25),
                    r_seq)
    ref, _, _ = _numpy_stp(g, r_seq, dt, 30.0, 90.0, 0.25)
    np.testing.assert_allclose(outs, ref, rtol=1e-10)


def test_paired_pulse_facilitation():
    # test_stp.py:83 -- the second impulse transmits more, by exactly the
    # decayed utilization jump
    dt, U, tau_f, gap = 0.1, 0.2, 50.0, 20
    edge = _edge(1, 1, dt=dt, weights=np.ones((1, 1)), tau_facil=tau_f, tau_depress=0.0, U=U)
    r_seq = np.zeros((2 * gap, 1))
    r_seq[::gap] = 1.0 / dt
    outs, _ = _scan(edge, r_seq)
    responses = outs[::gap, 0]
    assert responses[1] > responses[0]
    d = np.exp(-dt / tau_f)
    u_plus_1 = U + U * (1 - U)
    u_2 = U + (u_plus_1 - U) * d ** gap
    u_plus_2 = u_2 + U * (1 - u_2)
    np.testing.assert_allclose(responses[0], u_plus_1 / dt, rtol=1e-10)
    np.testing.assert_allclose(responses[1], u_plus_2 / dt, rtol=1e-10)


def test_frequency_dependent_depression():
    # test_stp.py:109 -- responses fall monotonically to a steady state, the
    # resources stay in [0, 1], a faster train depresses more
    dt, U, tau_d = 0.1, 0.5, 300.0

    def run_train(period):
        edge = _edge(1, 1, dt=dt, weights=np.ones((1, 1)), tau_facil=0.0, tau_depress=tau_d,
                     U=U)
        step, state = edge.make_step(), edge.init_state()
        resp = []
        for t in range(600):
            r = torch.tensor([1.0 / dt if t % period == 0 else 0.0], dtype=torch.float64)
            state, y = step(state, edge.params, r)
            if t % period == 0:
                resp.append(float(y[0]))
            assert 0.0 <= float(state[1][0]) <= 1.0
        return resp

    fast, slow = run_train(10), run_train(60)
    assert all(b <= a + 1e-12 for a, b in zip(fast, fast[1:]))
    assert fast[-1] < fast[0]
    assert fast[-1] < slow[-1]


def test_float32_edge_stays_float32():
    # the decays are Python floats: no float64 promotion of a float32 edge
    edge = _edge(3, 2, dtype=torch.float32, dt=1e-2, weights=np.ones((2, 3)), tau_facil=5.0,
                 tau_depress=7.0, U=0.4)
    (u, x), y = edge.make_step()(edge.init_state(), edge.params,
                                 torch.ones(3, dtype=torch.float32))
    assert u.dtype == x.dtype == y.dtype == torch.float32


def _stp_net(pkg, n, w_rec, w_stp, stp_kw, readout=None):
    """test_stp.py's network: an identity input through an STP edge into a
    tanh population (and optionally a trainable readout)."""
    if pkg == "jax":
        net = JNetwork(dt=1e-2, dtype=jnp.float64)
    else:
        net = Network(dt=1e-2, dtype=torch.float64, device="cpu")
    net.add_func_node("inp", n, activation_function="identity")
    net.add_diffeq_node("pop", PREFIX[pkg] + TANH, weights=w_rec, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r", target_var="li_op/r_in")
    net.add_edge("inp", "pop", weights=w_stp, **stp_kw)
    if readout is not None:
        net.add_func_node("out", readout.shape[0], activation_function="identity")
        net.add_edge("pop", "out", train="gd", weights=readout)
    return net


def test_network_run_matches_eager_forward_and_jax():
    # test_stp.py:136 -- run threads the (u, x) state as the eager loop does
    rng = np.random.default_rng(11)
    n = 4
    inp = np.abs(rng.normal(size=(30, n)))
    w_rec = rng.standard_normal((n, n)) * 0.1
    kw = dict(tau_facil=40.0, tau_depress=120.0, U=0.3)
    net1 = _stp_net("torch", n, w_rec, np.eye(n), kw)
    scan_out = net1.run(inp, sampling_steps=1, verbose=False).to_numpy("out")
    net2 = _stp_net("torch", n, w_rec, np.eye(n), kw)
    eager = np.stack([net2.forward(inp[t]).numpy() for t in range(inp.shape[0])])
    np.testing.assert_allclose(scan_out, eager, rtol=1e-8, atol=1e-10)
    e1, e2 = net1.get_edge("inp", "pop"), net2.get_edge("inp", "pop")
    np.testing.assert_allclose(e1.u.numpy(), e2.u.numpy(), rtol=1e-8)
    np.testing.assert_allclose(e1.x.numpy(), e2.x.numpy(), rtol=1e-8)
    jnet = _stp_net("jax", n, w_rec, np.eye(n), kw)
    jout = jnet.run(inp, sampling_steps=1, verbose=False).to_numpy("out")
    np.testing.assert_allclose(scan_out, jout, rtol=1e-10, atol=1e-12)
    je = jnet.get_edge("inp", "pop")
    np.testing.assert_allclose(e1.u.numpy(), np.asarray(je.u), rtol=1e-10)
    np.testing.assert_allclose(e1.x.numpy(), np.asarray(je.x), rtol=1e-10)


def test_chunked_runs_continue_state():
    # test_stp.py:167 -- the write-back carries (u, x) into the next run;
    # reset() leaves it alone, as the JAX package's does
    rng = np.random.default_rng(5)
    n = 3
    inp = np.abs(rng.normal(size=(40, n)))
    w_stp = rng.standard_normal((n, n))
    kw = dict(tau_depress=80.0, U=0.4)
    out_a = _stp_net("torch", n, np.zeros((n, n)), w_stp, kw).run(
        inp, sampling_steps=1, verbose=False).to_numpy("out")
    net_b = _stp_net("torch", n, np.zeros((n, n)), w_stp, kw)
    out_b1 = net_b.run(inp[:25], sampling_steps=1, verbose=False).to_numpy("out")
    out_b2 = net_b.run(inp[25:], sampling_steps=1, verbose=False).to_numpy("out")
    np.testing.assert_allclose(np.concatenate([out_b1, out_b2]), out_a, rtol=1e-8, atol=1e-12)
    x_before = net_b.get_edge("inp", "pop").x.clone()
    assert float(x_before.min()) < 1.0
    net_b.reset()
    np.testing.assert_array_equal(net_b.get_edge("inp", "pop").x.numpy(), x_before.numpy())


def test_add_edge_dispatch_and_errors():
    # test_stp.py:216
    n = 3
    net = Network(dt=1e-3, device="cpu")
    net.add_func_node("a", n, activation_function="identity")
    net.add_func_node("b", n, activation_function="identity")
    edge = net.add_edge("a", "b", tau_depress=100.0, weights=np.eye(n))
    assert isinstance(edge, LinearSTP)
    assert edge.dt == pytest.approx(1e-3)
    with pytest.raises(ValueError, match="cannot be combined"):
        net.add_edge("b", "a", tau_facil=10.0, delays=np.zeros(n, dtype=int))
    with pytest.raises(ValueError, match="cannot be combined"):
        net.add_edge("b", "a", tau_depress=10.0, mask=np.ones((n, n)))
    with pytest.raises(ValueError, match="utilization"):
        LinearSTP(n, n, dt=1e-3, tau_facil=10.0, U=0.0, device="cpu")
    with pytest.raises(ValueError, match="time constants"):
        LinearSTP(n, n, dt=1e-3, tau_facil=-1.0, device="cpu")


def test_bptt_trains_through_stp_dynamics_like_jax():
    # test_stp.py:261 -- fit the readout of a depressing synapse chain: the
    # losses fall, and equal the JAX package's epoch by epoch
    rng = np.random.default_rng(21)
    n, n_out, T = 4, 2, 25
    w_rec = rng.standard_normal((n, n)) * 0.1
    readout = rng.standard_normal((n_out, n)) * 0.1
    kw = dict(tau_facil=40.0, tau_depress=150.0, U=0.3)
    inputs = [np.abs(rng.normal(size=(T, n)))] * 6
    targets = [np.tile(np.asarray([0.3, -0.2]), (T, 1))] * 6
    losses, weights = {}, {}
    for pkg in ("jax", "torch"):
        net = _stp_net(pkg, n, w_rec, np.eye(n), kw, readout=readout)
        obs = net.fit_bptt(inputs, targets, optimizer="adam", lr=5e-2, verbose=False,
                           record_output=False)
        losses[pkg] = [float(x) for x in obs["epoch_loss"]]
        weights[pkg] = np.asarray(net.get_edge("pop", "out").weights)
        if pkg == "torch":
            assert net.last_fit["trajectory"] == "autograd"  # a stateful edge: no chain
    assert all(np.isfinite(losses["torch"]))
    assert losses["torch"][-1] < losses["torch"][0]
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-8)
    np.testing.assert_allclose(weights["torch"], weights["jax"], rtol=1e-8, atol=1e-12)
