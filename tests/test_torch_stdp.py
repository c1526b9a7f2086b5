"""The port's ``STDP`` edge and ``Network.fit_stdp`` against the JAX package
(CPU, float64 unless stated, inputs from numpy seeds; the cases of
``tests/test_stdp.py``).  Records, weights and traces are held to JAX within
rtol 1e-10 (the rule's own functions within 1e-12, and against a numpy
oracle); spike counts exactly.  On the CPU the update is the plain version
of ``ops/stdp.py`` (the kernel runs on the card only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import FeedbackNetwork as JFeedbackNetwork
from rectipy_tpu import Network as JNetwork
from rectipy_tpu import Poisson as JPoisson
from rectipy_tpu.edges import STDP as JSTDP
from rectipy_tpu_torch import STDP, FeedbackNetwork, Network, Poisson, load_jax_params
from rectipy_tpu_torch.ops.stdp import stdp_consts, stdp_update, stdp_update_plain

LIF = "rectipy_tpu.models.spiking_neurons.lif.lif"
QIF = "rectipy_tpu.models.spiking_neurons.qif.qif"
TIGHT = dict(rtol=1e-10, atol=0.0)


def _new(cls, dt, dtype="float64"):
    if cls in (JNetwork, JFeedbackNetwork):
        return cls(dt, dtype=getattr(jnp, dtype))
    return cls(dt, dtype=getattr(torch, dtype), device="cpu")


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x) \
        if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.float64)


def _numpy_stdp(W, spk_pre, spk_post, dt, tau_plus, tau_minus, a_plus, a_minus, w_min, w_max,
                soft=False):
    """Independent oracle of the documented rule (decay first, zero-lag
    pairs do not interact, bounds last)."""
    W = np.array(W, dtype=np.float64)
    x_pre = np.zeros(W.shape[-1] if W.ndim == 2 else W.shape[0])
    x_post = np.zeros(W.shape[0])
    for sp, so in zip(spk_pre, spk_post):
        x_pre *= np.exp(-dt / tau_plus)
        x_post *= np.exp(-dt / tau_minus)
        if W.ndim == 2:
            pot, dep = a_plus * np.outer(so, x_pre), a_minus * np.outer(x_post, sp)
        else:
            pot, dep = a_plus * so * x_pre, a_minus * x_post * sp
        W = W + pot * (w_max - W) - dep * (W - w_min) if soft else W + pot - dep
        W = np.clip(W, w_min, w_max)
        x_pre += sp
        x_post += so
    return W, x_pre, x_post


# ---------------------------------------------------------------- unit level

@pytest.mark.parametrize("soft", [False, True])
def test_update_fn_matches_jax_and_numpy_oracle(soft):
    rng = np.random.default_rng(3)
    n_in, n_out, T, dt = 4, 3, 60, 0.5
    cfg = dict(tau_plus=7.0, tau_minus=11.0, a_plus=0.04, a_minus=0.03, w_min=0.0, w_max=1.0)
    spk_pre = (rng.random((T, n_in)) < 0.15).astype(float)
    spk_post = (rng.random((T, n_out)) < 0.15).astype(float)
    W0 = np.full((n_out, n_in), 0.5)
    edge = STDP(n_in, n_out, weights=W0, soft_bounds=soft, device="cpu", **cfg)
    jedge = JSTDP(n_in, n_out, weights=W0, dtype=jnp.float64, soft_bounds=soft, **cfg)
    upd, jupd = edge.update_fn(dt), jedge.update_fn(dt)
    W, xp, xs = edge.params["weights"], edge.x_pre, edge.x_post
    jW, jxp, jxs = jedge.params["weights"], jedge.x_pre, jedge.x_post
    for t in range(T):
        W, xp, xs = upd(W, xp, xs, torch.as_tensor(spk_pre[t]), torch.as_tensor(spk_post[t]))
        jW, jxp, jxs = jupd(jW, jxp, jxs, jnp.asarray(spk_pre[t]), jnp.asarray(spk_post[t]))
    ref = _numpy_stdp(W0, spk_pre, spk_post, dt, soft=soft, **cfg)
    for got, want, oracle in zip((W, xp, xs), (jW, jxp, jxs), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
        np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-12)
    assert W.numpy().min() < 0.5 < W.numpy().max()  # the rule moved both ways


def test_reward_update_fn_matches_jax_and_numpy_oracle():
    rng = np.random.default_rng(13)
    n_in, n_out, T, dt, tau_e = 3, 2, 80, 0.5, 15.0
    cfg = dict(tau_plus=6.0, tau_minus=9.0, a_plus=0.03, a_minus=0.025, w_min=0.0, w_max=1.0)
    spk_pre = (rng.random((T, n_in)) < 0.2).astype(float)
    spk_post = (rng.random((T, n_out)) < 0.2).astype(float)
    r = rng.normal(0.0, 0.5, size=T)
    W0 = np.full((n_out, n_in), 0.5)
    edge = STDP(n_in, n_out, weights=W0, device="cpu", **cfg)
    jedge = JSTDP(n_in, n_out, weights=W0, dtype=jnp.float64, **cfg)
    upd, jupd = edge.reward_update_fn(dt, tau_e), jedge.reward_update_fn(dt, tau_e)
    W, xp, xs = edge.params["weights"], edge.x_pre, edge.x_post
    E = torch.zeros_like(W)
    jW, jxp, jxs = jedge.params["weights"], jedge.x_pre, jedge.x_post
    jE = jnp.zeros_like(jW)
    for t in range(T):
        W, E, xp, xs = upd(W, E, xp, xs, torch.as_tensor(spk_pre[t]),
                           torch.as_tensor(spk_post[t]), r[t])
        jW, jE, jxp, jxs = jupd(jW, jE, jxp, jxs, jnp.asarray(spk_pre[t]),
                                jnp.asarray(spk_post[t]), jnp.asarray(r[t]))
    W_ref, E_ref = W0.copy(), np.zeros_like(W0)
    xp_ref, xs_ref = np.zeros(n_in), np.zeros(n_out)
    for t in range(T):
        xp_ref *= np.exp(-dt / cfg["tau_plus"])
        xs_ref *= np.exp(-dt / cfg["tau_minus"])
        pot = cfg["a_plus"] * np.outer(spk_post[t], xp_ref)
        dep = cfg["a_minus"] * np.outer(xs_ref, spk_pre[t])
        E_ref = E_ref * np.exp(-dt / tau_e) + (pot - dep)
        W_ref = np.clip(W_ref + r[t] * E_ref, cfg["w_min"], cfg["w_max"])
        xp_ref += spk_pre[t]
        xs_ref += spk_post[t]
    for got, want, oracle in ((W, jW, W_ref), (E, jE, E_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
        np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-12)


def test_update_fn_pair_timing_closed_form():
    """One causal pair: +a_plus*exp(-dt*delta/tau_plus); anti-causal:
    -a_minus*exp(-dt*delta/tau_minus); zero-lag pairs do not interact."""
    dt, delta, T = 0.5, 6, 20
    cfg = dict(tau_plus=8.0, tau_minus=5.0, a_plus=0.02, a_minus=0.015, w_min=-1.0, w_max=1.0)

    def run(pre_step, post_step):
        edge = STDP(1, 1, weights=np.zeros((1, 1)), device="cpu", **cfg)
        upd = edge.update_fn(dt)
        W, xp, xs = edge.params["weights"], edge.x_pre, edge.x_post
        for t in range(T):
            W, xp, xs = upd(W, xp, xs, torch.tensor([float(t == pre_step)], dtype=W.dtype),
                            torch.tensor([float(t == post_step)], dtype=W.dtype))
        return float(W[0, 0])

    assert run(2, 2 + delta) == pytest.approx(
        cfg["a_plus"] * np.exp(-dt * delta / cfg["tau_plus"]), rel=1e-12)
    assert run(2 + delta, 2) == pytest.approx(
        -cfg["a_minus"] * np.exp(-dt * delta / cfg["tau_minus"]), rel=1e-12)
    assert run(4, 4) == 0.0


def test_update_fn_diagonal_matches_jax():
    rng = np.random.default_rng(9)
    n, T, dt = 5, 40, 0.2
    cfg = dict(tau_plus=4.0, tau_minus=6.0, a_plus=0.05, a_minus=0.04, w_min=0.0, w_max=2.0)
    spk_pre = (rng.random((T, n)) < 0.2).astype(float)
    spk_post = (rng.random((T, n)) < 0.2).astype(float)
    w0 = rng.uniform(0.2, 1.8, size=n)
    edge = STDP(n, n, weights=w0, device="cpu", **cfg)
    jedge = JSTDP(n, n, weights=w0, dtype=jnp.float64, **cfg)
    assert edge.params["weights"].dim() == 1
    upd, jupd = edge.update_fn(dt), jedge.update_fn(dt)
    W, xp, xs = edge.params["weights"], edge.x_pre, edge.x_post
    jW, jxp, jxs = jedge.params["weights"], jedge.x_pre, jedge.x_post
    for t in range(T):
        W, xp, xs = upd(W, xp, xs, torch.as_tensor(spk_pre[t]), torch.as_tensor(spk_post[t]))
        jW, jxp, jxs = jupd(jW, jxp, jxs, jnp.asarray(spk_pre[t]), jnp.asarray(spk_post[t]))
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), rtol=1e-12)
    np.testing.assert_allclose(W.numpy(), _numpy_stdp(w0, spk_pre, spk_post, dt, **cfg)[0],
                               rtol=1e-12)


def test_stdp_constructor_random_init_and_validation():
    with pytest.raises(ValueError, match="tau_plus"):
        STDP(2, 2, tau_plus=0.0, device="cpu")
    with pytest.raises(ValueError, match="a_plus"):
        STDP(2, 2, a_plus=-0.1, device="cpu")
    with pytest.raises(ValueError, match="w_max > w_min"):
        STDP(2, 2, w_min=1.0, w_max=0.0, device="cpu")
    with pytest.raises(ValueError, match="floating"):
        STDP(2, 2, w_dtype=torch.int8, device="cpu")
    with pytest.raises(ValueError, match="tau_e > 0"):
        STDP(2, 2, device="cpu").reward_update_fn(0.1, tau_e=0.0)
    # the default init: the caller's numpy generator draws it, as in JAX,
    # uniform within the bounds; a square draw takes the transpose rule too
    for n_in, n_out in ((3, 4), (5, 5)):
        edge = STDP(n_in, n_out, w_min=0.1, w_max=0.9, rng=np.random.default_rng(0),
                    device="cpu")
        jedge = JSTDP(n_in, n_out, w_min=0.1, w_max=0.9, rng=np.random.default_rng(0))
        W = edge.params["weights"].numpy()
        assert W.shape == (n_out, n_in) and W.min() >= 0.1 and W.max() <= 0.9
        np.testing.assert_array_equal(W, np.asarray(jedge.params["weights"]))
    # the eager update moves the weight: pre spikes charge x_pre, then post
    # spikes potentiate
    edge.update(np.ones(5), np.zeros(5), dt=0.1)
    edge.update(np.zeros(5), np.ones(5), dt=0.1)
    assert edge.params["weights"].numpy().mean() > W.mean()


# ------------------------------------------------------------ network level

def _pair_net(cls, dt=0.1, w0=0.2, **kw):
    """inp (identity, 2 channels) -> {pre, post} single LIF populations;
    the STDP edge pre -> post."""
    net = _new(cls, dt)
    net.add_func_node("inp", 2, activation_function="identity")
    for label, sel in (("pre", [[1.0, 0.0]]), ("post", [[0.0, 1.0]])):
        net.add_diffeq_node(label, LIF, weights=np.zeros((1, 1)), source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            op="lif_op", spike_var="spike", reset_var="v",
                            spike_threshold=1.0, spike_reset=0.0)
        net.add_edge("inp", label, weights=np.array(sel))
    net.add_edge("pre", "post", train="stdp", weights=np.full((1, 1), w0), tau_plus=2.0,
                 tau_minus=2.0, a_plus=0.05, a_minus=0.05, w_min=0.0, w_max=1.0, **kw)
    return net


def _assert_edge_close(tnet, jnet, src, tgt, keys=("weights", "x_pre", "x_post")):
    te, je = tnet.get_edge(src, tgt), jnet.get_edge(src, tgt)
    for key in keys:
        np.testing.assert_allclose(_np(te.params[key]), np.asarray(je.params[key]),
                                   err_msg=key, **TIGHT)


def _assert_obs_close(tobs, jobs, spikes=()):
    np.testing.assert_allclose(tobs.to_numpy("out"), jobs.to_numpy("out"), **TIGHT)
    for key in ("w_mean", "w_min", "w_max"):
        np.testing.assert_allclose(np.asarray(tobs[key]), np.asarray(jobs[key]), err_msg=key,
                                   **TIGHT)
    np.testing.assert_array_equal(np.asarray(tobs["w_steps"]), np.asarray(jobs["w_steps"]))
    for label in spikes:
        got, want = tobs.to_numpy((label, "spikes")), jobs.to_numpy((label, "spikes"))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _pulse_train(T, steps, channel, amp=50.0):
    x = np.zeros((T, 2))
    x[list(steps), channel] = amp
    return x


def test_fit_stdp_pair_protocol_matches_jax():
    """Causal pairings potentiate, anti-causal ones depress; each fit equals
    JAX's."""
    T, dt = 400, 0.1
    pre_steps = np.arange(20, 380, 40)
    w = {}
    for causal in (True, False):
        first, second = (0, 1) if causal else (1, 0)
        x = _pulse_train(T, pre_steps, first) + _pulse_train(T, pre_steps + 5, second)
        tnet, jnet = _pair_net(Network, dt), _pair_net(JNetwork, dt)
        tobs = tnet.fit_stdp(x, sampling_steps=50, verbose=False)
        jobs = jnet.fit_stdp(x, sampling_steps=50, verbose=False)
        _assert_obs_close(tobs, jobs)
        _assert_edge_close(tnet, jnet, "pre", "post")
        w[causal] = float(tnet.get_edge("pre", "post").params["weights"][0, 0])
    assert w[True] > 0.2 + 1e-4 and w[False] < 0.2 - 1e-4


def test_fit_stdp_matches_eager_loop_and_jax():
    """The fit equals an eager loop over make_step and update_fn, and JAX's
    fit: weights, traces, state, output and record_vars records, and the
    spike counts of the windows that end at each record step."""
    T, dt, s = 150, 0.1, 50
    rng = np.random.default_rng(5)
    x = (rng.random((T, 2)) < 0.08) * 40.0
    net = _pair_net(Network, dt)
    edge = net.get_edge("pre", "post")
    step, state, params = net.make_step(), net.init_state(), net.parameters_pytree()
    upd = edge.update_fn(dt)
    pre_read = net.get_node("pre")._make_spike_reader()
    post_read = net.get_node("post")._make_spike_reader()
    W, xp, xs = edge.params["weights"], edge.x_pre, edge.x_post
    spk_log, v_log = np.zeros((T, 1)), np.zeros((T, 1))
    v_lo, v_hi = net.get_node("post")._var_map["v"]
    with torch.no_grad():
        for t in range(T):
            spk_pre = pre_read(state["nodes"]["pre"])
            spk_post = post_read(state["nodes"]["post"])
            spk_log[t] = spk_post.numpy()
            p = {"nodes": params["nodes"],
                 "edges": {**params["edges"], "pre->post": {**params["edges"]["pre->post"],
                                                            "weights": W}}}
            state, _, _ = step(state, p, torch.as_tensor(x[t]))
            W, xp, xs = upd(W, xp, xs, spk_pre, spk_post)
            v_log[t] = state["nodes"]["post"][v_lo:v_hi].numpy()

    kw = dict(sampling_steps=s, verbose=False, record_spikes=["post"],
              record_vars=[("post", "v", False)])
    tnet, jnet = _pair_net(Network, dt), _pair_net(JNetwork, dt)
    tobs, jobs = tnet.fit_stdp(x, **kw), jnet.fit_stdp(x, **kw)
    counts = tobs.to_numpy(("post", "spikes"))
    expected = [spk_log[0].sum()] + [spk_log[1 + s * k:1 + s * (k + 1)].sum()
                                     for k in range(T // s - 1)]
    np.testing.assert_array_equal(counts[:, 0], np.asarray(expected, dtype=np.int32))
    assert counts.sum() > 0
    np.testing.assert_allclose(tobs.to_numpy(("post", "v")), v_log[np.arange(0, T, s)],
                               rtol=1e-12)
    te = tnet.get_edge("pre", "post")
    for got, want in ((te.params["weights"], W), (te.x_pre, xp), (te.x_post, xs),
                      (tnet.get_node("post").y, state["nodes"]["post"])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    _assert_obs_close(tobs, jobs, spikes=["post"])
    np.testing.assert_allclose(tobs.to_numpy(("post", "v")), jobs.to_numpy(("post", "v")),
                               **TIGHT)
    _assert_edge_close(tnet, jnet, "pre", "post")


def test_fit_stdp_chunked_equals_single_call_and_jax():
    T, dt = 200, 0.1
    rng = np.random.default_rng(11)
    x = (rng.random((T, 2)) < 0.1) * 40.0
    net_a = _pair_net(Network, dt)
    net_a.fit_stdp(x, sampling_steps=20, verbose=False)
    net_b, jnet = _pair_net(Network, dt), _pair_net(JNetwork, dt)
    for chunk in (x[:T // 2], x[T // 2:]):
        net_b.fit_stdp(chunk, sampling_steps=20, verbose=False)
        jnet.fit_stdp(chunk, sampling_steps=20, verbose=False)
    for key in ("weights", "x_pre", "x_post"):
        np.testing.assert_allclose(net_b.get_edge("pre", "post").params[key].numpy(),
                                   net_a.get_edge("pre", "post").params[key].numpy(),
                                   rtol=1e-12, err_msg=key)
    _assert_edge_close(net_b, jnet, "pre", "post")


def _qif_fb(cls, n, dt, w0, eta=20.0, **kw):
    net = _new(cls, dt)
    net.add_diffeq_node("qif", QIF, weights=np.zeros((n, n)), source_var="s",
                        target_var="s_in", input_var="I_ext", output_var="s",
                        spike_var="spike", reset_var="v", spike_threshold=1e2,
                        spike_reset=-1e2, node_vars={"eta": eta})
    net.add_edge("qif", "qif", feedback=True, train="stdp", weights=w0, **kw)
    return net


def test_fit_stdp_recurrent_feedback_edge_soft_bounds_matches_jax():
    """A QIF population with a plastic feedback self-edge: soft bounds keep
    every weight strictly inside, the weights move, and the fit equals
    JAX's."""
    n, T, dt = 6, 800, 1e-3
    rng = np.random.default_rng(2)
    w0 = rng.uniform(0.3, 0.7, size=(n, n))
    kw = dict(tau_plus=5e-3, tau_minus=5e-3, a_plus=0.05, a_minus=0.02, w_min=0.0, w_max=1.0,
              soft_bounds=True)
    x = rng.normal(0.0, 5.0, size=(T, n))
    tnet, jnet = (_qif_fb(cls, n, dt, w0, **kw) for cls in (FeedbackNetwork, JFeedbackNetwork))
    tobs = tnet.fit_stdp(x, sampling_steps=100, verbose=False, record_spikes=["qif"])
    jobs = jnet.fit_stdp(x, sampling_steps=100, verbose=False, record_spikes=["qif"])
    W = tnet.get_edge("qif", "qif").params["weights"].numpy()
    assert np.all(np.isfinite(W)) and W.min() > 0.0 and W.max() < 1.0
    assert np.abs(W - w0.T).max() > 1e-4
    assert len(tobs["w_mean"]) == T // 100
    _assert_obs_close(tobs, jobs, spikes=["qif"])
    _assert_edge_close(tnet, jnet, "qif", "qif")


def test_fit_stdp_input_spec_matches_materialized_and_jax():
    """A Poisson spec equals its materialized drive (bit for bit), and JAX's
    fit of that drive (the specs' random bits are the port's own).  eta
    1,000 (test_stdp.py's 10 spikes in none of the 300 steps) moves W."""
    n, T, dt = 4, 300, 1e-3
    kw = dict(tau_plus=5e-3, tau_minus=5e-3, a_plus=0.03, a_minus=0.02, w_min=0.0,
              w_max=1.0)
    nets = [_qif_fb(cls, n, dt, np.full((n, n), 0.5), eta=1000.0, **kw)
            for cls in (FeedbackNetwork, FeedbackNetwork, JFeedbackNetwork)]
    spec = Poisson(steps=T, channels=n, rate=200.0, amp=0.03, seed=7)
    dense = spec.materialize(dt, dtype=torch.float64, device="cpu")
    nets[0].fit_stdp(spec, sampling_steps=100, verbose=False)
    nets[1].fit_stdp(dense, sampling_steps=100, verbose=False)
    nets[2].fit_stdp(dense.numpy(), sampling_steps=100, verbose=False)
    W = [np.asarray(_np(net.get_edge("qif", "qif").params["weights"])) for net in nets]
    np.testing.assert_array_equal(W[0], W[1])
    np.testing.assert_allclose(W[0], W[2], **TIGHT)
    assert np.abs(W[0] - 0.5).max() > 0
    with pytest.raises(ValueError, match="unbatched"):
        nets[0].fit_stdp(Poisson(steps=T, channels=n, rate=200.0, amp=0.03,
                                 seed=np.arange(2)), verbose=False)


def test_fit_stdp_reward_mode_matches_jax_and_chunks():
    """Reward-modulated STDP through the network, JAX's distal-reward
    protocol: the paired synapse potentiates; one call equals two chunks
    (W, elig, traces) and JAX's fits."""
    T, dt = 600, 0.1
    x, r = np.zeros((T, 3)), np.zeros(T)
    for t0 in range(20, 560, 60):
        x[t0, 0] = x[t0 + 4, 2] = x[t0 + 30, 1] = 50.0
        r[t0 + 20] = 1.0
    rng = np.random.default_rng(17)
    x += (rng.random((T, 3)) < 0.05) * 40.0
    r += rng.normal(0.0, 0.3, size=T)
    nets = [_rstdp_net(cls) for cls in (Network, Network, JNetwork, JNetwork)]
    w0 = nets[0].get_edge("pre", "post").params["weights"].numpy().copy()
    kw = dict(tau_e=5.0, sampling_steps=100, verbose=False)
    tobs = nets[0].fit_stdp(x, reward=r, record_spikes=["post"], **kw)
    jobs = nets[2].fit_stdp(x, reward=r, record_spikes=["post"], **kw)
    for net in nets[1::2]:
        net.fit_stdp(x[:T // 2], reward=r[:T // 2], **kw)
        net.fit_stdp(x[T // 2:], reward=r[T // 2:], **kw)
    keys = ("weights", "elig", "x_pre", "x_post")
    _assert_obs_close(tobs, jobs, spikes=["post"])
    _assert_edge_close(nets[0], nets[2], "pre", "post", keys)
    _assert_edge_close(nets[1], nets[3], "pre", "post", keys)
    for key in keys:
        np.testing.assert_allclose(nets[1].get_edge("pre", "post").params[key].numpy(),
                                   nets[0].get_edge("pre", "post").params[key].numpy(),
                                   rtol=1e-12, err_msg=key)
    W = nets[0].get_edge("pre", "post").params["weights"].numpy()
    assert W[0, 0] - w0[0, 0] > 1e-4


def _rstdp_net(cls, dt=0.1):
    """inp (3 channels) -> pre (2 LIF, channels 0 and 1) and post (1 LIF,
    channel 2); the STDP edge pre -> post."""
    net = _new(cls, dt)
    net.add_func_node("inp", 3, activation_function="identity")
    for label, n in (("pre", 2), ("post", 1)):
        net.add_diffeq_node(label, LIF, weights=np.zeros((n, n)), source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            op="lif_op", spike_var="spike", reset_var="v",
                            spike_threshold=1.0, spike_reset=0.0)
    net.add_edge("inp", "pre", weights=np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    net.add_edge("inp", "post", weights=np.array([[0.0, 0.0, 1.0]]))
    net.add_edge("pre", "post", train="stdp", weights=np.full((1, 2), 0.3), tau_plus=1.0,
                 tau_minus=1.0, a_plus=0.05, a_minus=0.05, w_min=0.0, w_max=1.0)
    return net


# -------------------------------------------------------- homeostatic scaling

def _wide_net(cls, dt=0.1, n_pre=4, n_post=2, w0=None, seed=13):
    """inp -> pre / post LIF populations with an STDP edge; channel i drives
    pre[i], channel n_pre + j drives post[j]."""
    rng = np.random.default_rng(seed)
    m = n_pre + n_post
    net = _new(cls, dt)
    net.add_func_node("inp", m, activation_function="identity")
    for label, n, sel in (("pre", n_pre, np.eye(n_pre, m)),
                          ("post", n_post, np.eye(n_post, m, k=n_pre))):
        net.add_diffeq_node(label, LIF, weights=np.zeros((n, n)), source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            op="lif_op", spike_var="spike", reset_var="v",
                            spike_threshold=1.0, spike_reset=0.0)
        net.add_edge("inp", label, weights=sel)
    if w0 is None:
        w0 = rng.uniform(0.1, 0.4, size=(n_post, n_pre))
    net.add_edge("pre", "post", train="stdp", weights=w0, tau_plus=2.0, tau_minus=2.0,
                 a_plus=0.05, a_minus=0.04, w_min=0.0, w_max=1.0)
    return net


def test_fit_stdp_homeostasis_matches_eager_loop_and_pins_rows():
    """Aligned homeostasis equals an eager loop with the documented scaling
    interleaved, pins every row's above-floor mass, and equals JAX's."""
    T, dt, h = 120, 0.1, 20
    rng = np.random.default_rng(23)
    x = (rng.random((T, 6)) < 0.2) * 40.0
    w0 = rng.uniform(0.1, 0.4, size=(2, 4))
    target = w0.sum(axis=1)
    net = _wide_net(Network, dt, w0=w0)
    edge = net.get_edge("pre", "post")
    step, state, params = net.make_step(), net.init_state(), net.parameters_pytree()
    upd = edge.update_fn(dt)
    pre_read = net.get_node("pre")._make_spike_reader()
    post_read = net.get_node("post")._make_spike_reader()
    W, xp, xs = edge.params["weights"], edge.x_pre, edge.x_post
    with torch.no_grad():
        for t in range(T):
            spk_pre = pre_read(state["nodes"]["pre"])
            spk_post = post_read(state["nodes"]["post"])
            p = {"nodes": params["nodes"],
                 "edges": {**params["edges"], "pre->post": {**params["edges"]["pre->post"],
                                                            "weights": W}}}
            state, _, _ = step(state, p, torch.as_tensor(x[t]))
            W, xp, xs = upd(W, xp, xs, spk_pre, spk_post)
            if t % h == h - 1:
                above = W.numpy()
                W = torch.as_tensor(np.clip(above * (target / (above.sum(axis=1) + 1e-12))
                                            [:, None], 0.0, 1.0))
    tnet, jnet, free = _wide_net(Network, dt, w0=w0), _wide_net(JNetwork, dt, w0=w0), \
        _wide_net(Network, dt, w0=w0)
    tobs = tnet.fit_stdp(x, sampling_steps=40, homeostasis_steps=h, verbose=False)
    jobs = jnet.fit_stdp(x, sampling_steps=40, homeostasis_steps=h, verbose=False)
    Wt = tnet.get_edge("pre", "post").params["weights"].numpy()
    np.testing.assert_allclose(Wt, W.numpy(), rtol=1e-12)
    np.testing.assert_allclose(Wt.sum(axis=1), target, rtol=1e-9)
    assert np.abs(Wt - w0).max() > 1e-4
    _assert_obs_close(tobs, jobs)
    _assert_edge_close(tnet, jnet, "pre", "post")
    free.fit_stdp(x, sampling_steps=40, verbose=False)
    W_free = free.get_edge("pre", "post").params["weights"].numpy()
    assert np.abs(W_free.sum(axis=1) - target).max() > 1e-4


@pytest.mark.parametrize("chunks", [(80, 80), (70, 90), (72, 88)])
def test_fit_stdp_homeostasis_chunks_equal_one_call_and_jax(chunks):
    """The target and the schedule's phase persist on the edge: chunks of
    any length (aligned to the period or not: the segmented and the
    per-step paths) equal one long call and JAX's chunks."""
    T, dt, h = sum(chunks), 0.1, 16
    rng = np.random.default_rng(37 + chunks[0])
    x = (rng.random((T, 6)) < 0.15) * 40.0
    w0 = rng.uniform(0.1, 0.4, size=(2, 4))
    one = _wide_net(Network, dt, w0=w0)
    one.fit_stdp(x, sampling_steps=40, homeostasis_steps=h, verbose=False)
    tnet, jnet = _wide_net(Network, dt, w0=w0), _wide_net(JNetwork, dt, w0=w0)
    t0 = 0
    for n in chunks:
        tobs = tnet.fit_stdp(x[t0:t0 + n], sampling_steps=40, homeostasis_steps=h,
                             verbose=False)
        jobs = jnet.fit_stdp(x[t0:t0 + n], sampling_steps=40, homeostasis_steps=h,
                             verbose=False)
        _assert_obs_close(tobs, jobs)
        t0 += n
    te = tnet.get_edge("pre", "post")
    assert te._homeo_phase == jnet.get_edge("pre", "post")._homeo_phase == T % h
    np.testing.assert_allclose(te.params["weights"].numpy(),
                               one.get_edge("pre", "post").params["weights"].numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(te._homeo_target.numpy(),
                               np.asarray(jnet.get_edge("pre", "post")._homeo_target), **TIGHT)
    _assert_edge_close(tnet, jnet, "pre", "post")


def test_fit_stdp_homeostasis_w_stats_at_a_scaling_step():
    """The JAX package's two observable behaviours: an aligned call (the
    segmented path) records the weights of a scaling step before the
    scaling, an unaligned one (the per-step path) after it; the dynamics are
    the same.  Both held to JAX."""
    T, dt, h = 48, 0.1, 16
    rng = np.random.default_rng(53)
    x = (rng.random((T, 6)) < 0.25) * 40.0
    w0 = rng.uniform(0.1, 0.4, size=(2, 4))
    kw = dict(sampling_steps=1, homeostasis_steps=h, verbose=False)
    seg, jseg = _wide_net(Network, dt, w0=w0), _wide_net(JNetwork, dt, w0=w0)
    cond, jcond = _wide_net(Network, dt, w0=w0), _wide_net(JNetwork, dt, w0=w0)
    obs_seg, jobs_seg = seg.fit_stdp(x, **kw), jseg.fit_stdp(x, **kw)
    obs_c1, jobs_c1 = cond.fit_stdp(x[:5], **kw), jcond.fit_stdp(x[:5], **kw)
    obs_c2, jobs_c2 = cond.fit_stdp(x[5:], **kw), jcond.fit_stdp(x[5:], **kw)
    _assert_obs_close(obs_seg, jobs_seg)
    _assert_obs_close(obs_c1, jobs_c1)
    _assert_obs_close(obs_c2, jobs_c2)
    mean_seg = np.asarray(obs_seg["w_mean"])
    mean_cond = np.concatenate([obs_c1["w_mean"], obs_c2["w_mean"]])
    scaling = np.arange(h - 1, T, h)
    assert not np.allclose(mean_seg[scaling], mean_cond[scaling], rtol=1e-12, atol=0)
    others = np.setdiff1d(np.arange(T), scaling)
    np.testing.assert_allclose(mean_seg[others], mean_cond[others], rtol=1e-12)
    np.testing.assert_allclose(seg.get_edge("pre", "post").params["weights"].numpy(),
                               cond.get_edge("pre", "post").params["weights"].numpy(),
                               rtol=1e-12)


def test_fit_stdp_homeostasis_feedback_self_edge_pins_stored_rows():
    """A square weights matrix is stored transposed (the transpose rule), so
    the default targets are the given matrix's column sums."""
    N, dt, T, h = 12, 1e-3, 200, 50
    rng = np.random.default_rng(1)
    etas = rng.uniform(-2.0, 1.0, N)
    w0 = rng.uniform(0.0, 0.4, size=(N, N))
    drive = JPoisson(T, channels=N, rate=40.0, amp=15.0, seed=3).materialize(dt)
    nets = []
    for cls in (FeedbackNetwork, JFeedbackNetwork):
        net = _new(cls, dt)
        net.add_diffeq_node("qif", QIF, weights=np.zeros((N, N)), source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            spike_var="spike", reset_var="v", op="qif_op",
                            spike_threshold=100.0, spike_reset=-100.0,
                            node_vars={"all/qif_op/eta": etas})
        net.add_edge("qif", "qif", feedback=True, train="stdp", weights=w0, tau_plus=20e-3,
                     tau_minus=20e-3, a_plus=5e-3, a_minus=6e-3, w_min=0.0, w_max=0.5)
        net.fit_stdp(np.asarray(drive), sampling_steps=50, verbose=False,
                     homeostasis_steps=h)
        nets.append(net)
    W = nets[0].get_edge("qif", "qif").params["weights"].numpy()
    np.testing.assert_allclose(W.sum(axis=1), w0.sum(axis=0), rtol=1e-9)
    assert np.abs(W - w0.T).max() > 1e-4
    _assert_edge_close(nets[0], nets[1], "qif", "qif")


# ------------------------------------------------------------- bf16 carry

def test_stdp_bfloat16_carry_holds_weights_and_traces_at_bfloat16():
    """w_dtype='bfloat16': the weights and both traces carry at bfloat16 (as
    the JAX package's code does; docs/performance.md:144 says float32 for
    the traces), causal pairing still potentiates, and the fit follows
    JAX's to bfloat16's resolution."""
    T, dt = 400, 0.1
    pre_steps = np.arange(20, 380, 40)
    x = _pulse_train(T, pre_steps, 0) + _pulse_train(T, pre_steps + 5, 1)
    tnet = _pair_net(Network, dt, w0=0.25, w_dtype="bfloat16")
    jnet = _pair_net(JNetwork, dt, w0=0.25, w_dtype=jnp.bfloat16)
    edge = tnet.get_edge("pre", "post")
    assert {edge.params[k].dtype for k in ("weights", "x_pre", "x_post")} == {torch.bfloat16}
    assert {str(jnet.get_edge("pre", "post").params[k].dtype)
            for k in ("weights", "x_pre", "x_post")} == {"bfloat16"}
    tobs = tnet.fit_stdp(x, sampling_steps=50, verbose=False)
    jobs = jnet.fit_stdp(x, sampling_steps=50, verbose=False)
    assert {edge.params[k].dtype for k in ("weights", "x_pre", "x_post")} == {torch.bfloat16}
    w = float(edge.params["weights"][0, 0])
    assert w > 0.25 + 1e-3
    # one bfloat16 ulp at the weights' scale: the eager port rounds every
    # operation to bfloat16, XLA may keep float32 between fused operations
    np.testing.assert_allclose(w, float(np.asarray(jnet.get_edge("pre", "post")
                                                   .params["weights"], np.float32)[0, 0]),
                               rtol=2 ** -7)
    np.testing.assert_allclose(np.asarray(tobs["w_mean"]),
                               np.asarray(jobs["w_mean"], np.float32), rtol=2 ** -7)


def test_plain_update_matches_jax_at_float32():
    """The plain update at float32 (the type the card runs) equals JAX's
    update function on the same inputs: dense, hard, soft and reward."""
    rng = np.random.default_rng(8)
    n_in, n_out, dt = 33, 17, 1e-3
    cfg = dict(tau_plus=5e-3, tau_minus=7e-3, a_plus=3e-3, a_minus=4e-3, w_min=0.0, w_max=0.03)
    W0 = rng.uniform(0.0, 0.03, size=(n_out, n_in)).astype(np.float32)
    xp, xq = rng.random(n_in).astype(np.float32), rng.random(n_out).astype(np.float32)
    sp = (rng.random(n_in) < 0.3).astype(np.float32)
    sq = (rng.random(n_out) < 0.3).astype(np.float32)
    E0 = (rng.normal(size=(n_out, n_in)) * 1e-3).astype(np.float32)
    for soft in (False, True):
        edge = STDP(n_in, n_out, weights=W0, dtype=torch.float32, soft_bounds=soft,
                    device="cpu", **cfg)
        jedge = JSTDP(n_in, n_out, weights=W0, dtype=jnp.float32, soft_bounds=soft, **cfg)
        got = edge.update_fn(dt)(*(torch.as_tensor(a) for a in (W0, xp, xq, sp, sq)))
        want = jedge.update_fn(dt)(*(jnp.asarray(a) for a in (W0, xp, xq, sp, sq)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7, atol=0)
    got = edge.reward_update_fn(dt, 0.02)(*(torch.as_tensor(a) for a in (W0, E0, xp, xq, sp,
                                                                          sq)), 0.7)
    want = jedge.reward_update_fn(dt, 0.02)(*(jnp.asarray(a) for a in (W0, E0, xp, xq, sp, sq)),
                                            jnp.float32(0.7))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("mode", ["hard", "soft", "reward"])
def test_stdp_update_on_cpu_is_the_plain_version(dtype, mode):
    """On CPU tensors the wrapper is the plain version: nothing launches and
    the inputs are not written."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(4)
    W = torch.rand(7, 9, generator=g).to(dt)
    xp, xq = torch.rand(9, generator=g).to(dt), torch.rand(7, generator=g).to(dt)
    sp = (torch.rand(9, generator=g) < 0.5).to(dt)
    sq = (torch.rand(7, generator=g) < 0.5).to(dt)
    c = stdp_consts(dt, "cpu", 0.1, 0.12, 0.0, 1.0, d_e=0.9)
    E = torch.rand(7, 9, generator=g).to(dt) if mode == "reward" else None
    r = torch.tensor(0.5, dtype=dt) if mode == "reward" else None
    before, W0 = stdp_update.launches, W.clone()
    got = stdp_update(W, xp, xq, sp, sq, c, mode == "soft", None, E, r)
    want = stdp_update_plain(W, xp, xq, sp, sq, c, mode == "soft", None, E, r)
    assert stdp_update.launches == before and torch.equal(W, W0)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert got[0].dtype == dt and float(got[0].float().min()) >= 0.0


# ---------------------------------------------------------- dispatch, errors

def test_fit_stdp_dispatch_and_errors():
    dt = 0.1
    net = _pair_net(Network, dt)
    assert isinstance(net.get_edge("pre", "post"), STDP)
    assert net._train_edge == ("pre", "post")
    x = np.zeros((10, 2))
    # mesh= is ported (tests/test_torch_parallel_fits.py): a mesh that is no
    # DeviceMesh raises
    with pytest.raises(TypeError, match="DeviceMesh"):
        net.fit_stdp(x, verbose=False, mesh=object())
    with pytest.raises(ValueError, match="positive integer"):
        net.fit_stdp(x, homeostasis_steps=0, verbose=False)
    with pytest.raises(ValueError, match="only applies"):
        net.fit_stdp(x, homeostasis_target=1.0, verbose=False)
    with pytest.raises(ValueError, match="tau_e only applies"):
        net.fit_stdp(x, tau_e=5.0, verbose=False)
    with pytest.raises(ValueError, match="one value per step"):
        net.fit_stdp(x, reward=np.zeros(5), verbose=False)
    with pytest.raises(ValueError, match="channels"):
        net.fit_stdp(np.zeros((10, 3)), verbose=False)
    with pytest.raises(ValueError, match=r"\(T, m\)"):
        net.fit_stdp(np.zeros(10), verbose=False)
    with pytest.raises(ValueError, match="per-row"):
        _wide_net(Network).fit_stdp(np.zeros((10, 6)), homeostasis_steps=5,
                                    homeostasis_target=np.ones(3), verbose=False)
    soft = _pair_net(Network, dt, soft_bounds=True)
    with pytest.raises(ValueError, match="hard bounds"):
        soft.fit_stdp(x, reward=np.zeros(10), verbose=False)
    diag = _qif_fb(FeedbackNetwork, 3, 1e-3, np.full(3, 0.5))
    with pytest.raises(ValueError, match="2-D edge weights"):
        diag.fit_stdp(np.zeros((10, 3)), homeostasis_steps=5, verbose=False)
    # a width mismatch fails with names, not inside the loop
    wide = _rstdp_net(Network)
    wide.get_edge("pre", "post").n_in = 3
    with pytest.raises(ValueError, match="spike vector"):
        wide.fit_stdp(np.zeros((10, 3)), verbose=False)

    def lif_net():
        n = Network(dt, dtype=torch.float64, device="cpu")
        n.add_diffeq_node("lif", LIF, weights=np.zeros((2, 2)), source_var="s",
                          target_var="s_in", input_var="I_ext", output_var="s", op="lif_op",
                          spike_var="spike", reset_var="v")
        n.add_func_node("readout", 2, activation_function="identity")
        return n

    with pytest.raises(ValueError, match="No STDP-trainable edge"):
        n0 = lif_net()
        n0.add_edge("lif", "readout")
        n0.fit_stdp(np.zeros((10, 2)), verbose=False)
    n1 = lif_net()
    n1.add_edge("lif", "readout", train="rls")
    with pytest.raises(ValueError, match="not an STDP edge"):
        n1.fit_stdp(np.zeros((10, 2)), verbose=False)
    n2 = lif_net()
    n2.add_edge("lif", "readout", train="stdp")
    with pytest.raises(ValueError, match="not a spiking node"):
        n2.fit_stdp(np.zeros((10, 2)), verbose=False)
    # structural requests never ride a plastic edge, and an integer carry
    # is refused
    n3 = lif_net()
    for kw in ({"delays": np.arange(2)}, {"mask": np.eye(2)},
               {"tau_facil": 1.0, "tau_depress": 1.0}):
        with pytest.raises(ValueError, match="not supported on a plastic"):
            n3.add_edge("lif", "readout", train="stdp", weights=np.full((2, 2), 0.3), **kw)
    with pytest.raises(ValueError, match="floating"):
        n3.add_edge("lif", "readout", train="stdp", weights=np.full((2, 2), 0.3),
                    w_dtype=torch.int8)


def test_load_jax_params_continues_a_chunked_jax_fit_exactly():
    """A JAX network after a chunked reward fit with homeostasis (its target,
    phase, traces and eligibility on the edge) continues in the port as it
    continues in JAX."""
    T, dt, h = 150, 0.1, 16
    rng = np.random.default_rng(61)
    x = (rng.random((T, 6)) < 0.2) * 40.0
    r = rng.normal(0.0, 0.5, size=T)
    w0 = rng.uniform(0.1, 0.4, size=(2, 4))
    jnet, tnet = _wide_net(JNetwork, dt, w0=w0), _wide_net(Network, dt, w0=w0)
    kw = dict(sampling_steps=25, homeostasis_steps=h, verbose=False, tau_e=3.0)
    jnet.fit_stdp(x[:70], reward=r[:70], **kw)
    jedge = jnet.get_edge("pre", "post")
    to_np = lambda tree: {k: (to_np(v) if isinstance(v, dict) else  # noqa: E731
                              None if v is None else np.asarray(v)) for k, v in tree.items()}
    load_jax_params(tnet, to_np(jnet.parameters_pytree()), to_np(jnet.init_state()),
                    edge_attrs={"pre->post": {"_homeo_target": np.asarray(jedge._homeo_target),
                                              "_homeo_phase": jedge._homeo_phase}})
    tedge = tnet.get_edge("pre", "post")
    assert tedge._homeo_phase == 70 % h and "elig" in tedge.params
    tobs = tnet.fit_stdp(x[70:], reward=r[70:], **kw)
    jobs = jnet.fit_stdp(x[70:], reward=r[70:], **kw)
    _assert_obs_close(tobs, jobs)
    _assert_edge_close(tnet, jnet, "pre", "post", ("weights", "elig", "x_pre", "x_post"))
    with pytest.raises(KeyError, match="takes no attribute"):
        load_jax_params(tnet, {}, edge_attrs={"pre->post": {"_homeo_steps": 3}})
