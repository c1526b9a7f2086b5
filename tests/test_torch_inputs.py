"""Input specs of the port (``rectipy_tpu_torch.inputs``) against the JAX
package's (``rectipy_tpu.inputs``): CPU, float64, the cases of
``tests/test_inputs.py``.

The deterministic specs (pulses, sines, constants) evaluate to JAX's values
(pulses and constants exactly, sines within 1e-12), and spec-driven runs
give JAX's records within 1e-12.  The random streams are torch's, not
``jax.random``'s: the stochastic specs are held to their statistics, and a
spec-driven run to the run fed ``spec.materialize(dt, device="cpu")``, bit
for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import FeedbackNetwork as JFeedbackNetwork
from rectipy_tpu import Network as JNetwork
from rectipy_tpu import inputs as jinputs
from rectipy_tpu_torch import FeedbackNetwork, Network, inputs
from rectipy_tpu_torch.inputs import CHUNK, Constant, Noise, Poisson, Pulse, Sine, Wiener

LI = "rectipy_tpu.models.rate_neurons.leaky_integrator.tanh"
N, T = 24, 200
DT = 1e-3
CPU = "cpu"  # a spec is evaluated on the card unless told otherwise


def _build(cls=Network, train=False):
    W = np.random.default_rng(0).normal(size=(N, N)) / N
    net = (cls(DT, dtype=jnp.float64) if cls is JNetwork
           else cls(DT, dtype=torch.float64, device="cpu"))
    net.add_diffeq_node("t", LI, weights=W, source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext",
                        output_var="li_op/v",
                        train_params=["weights"] if train else None)
    return net


def _det(mod, steps=T, channels=N, **kw):
    """A deterministic spec of either package: a pulse, a sine and a
    per-channel constant."""
    return (mod.Pulse(steps, channels=channels, t_on=20, t_off=150, amp=1.5, **kw)
            + mod.Sine(steps, channels=channels, freq=3.0, amp=0.5, phase=0.3, **kw)
            + mod.Constant(steps, channels=channels, value=np.linspace(-1.0, 1.0, channels),
                           **kw))


def _spec():
    return _det(inputs) + Noise(T, channels=N, scale=0.3, seed=4)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("t0", [0, 37])
def test_deterministic_specs_match_jax(t0):
    kw = {"t0": t0} if t0 else {}
    np.testing.assert_allclose(_np(_det(inputs, **kw).materialize(DT, torch.float64, CPU)),
                               _det(jinputs, **kw).materialize(DT, np.float64),
                               rtol=1e-12, atol=1e-12)
    for make in (lambda m: m.Pulse(T, channels=3, t_on=5, t_off=-1, amp=np.arange(3.0), **kw),
                 lambda m: m.Constant(T, channels=3, value=np.array([1.0, 2.0, 3.0]), **kw)):
        np.testing.assert_array_equal(_np(make(inputs).materialize(DT, torch.float64, CPU)),
                                      make(jinputs).materialize(DT, np.float64))


def test_materialize_shapes_and_values():
    dense = _spec().materialize(DT, dtype=torch.float64, device="cpu")
    assert dense.shape == (T, N) and dense.dtype == torch.float64
    p = Pulse(T, channels=1, t_on=5, t_off=9, amp=2.0).materialize(DT, device="cpu")
    assert p.dtype == torch.float32 and p.device.type == "cpu"
    np.testing.assert_array_equal(p[:5], 0.0)
    np.testing.assert_array_equal(p[5:9], 2.0)
    np.testing.assert_array_equal(p[9:], 0.0)
    s = Sine(T, channels=1, freq=2.0, amp=1.0).materialize(DT, torch.float64, device="cpu")
    np.testing.assert_allclose(s[:, 0], np.sin(2 * np.pi * 2.0 * np.arange(T) * DT),
                               atol=1e-12)
    u = Noise(T, channels=2, scale=1.0, seed=1, dist="uniform").materialize(DT, device="cpu")
    assert (u >= -1.0).all() and (u < 1.0).all()
    z = Noise(4000, channels=8, seed=2).materialize(DT, torch.float64, device="cpu")
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05


def test_run_with_spec_equals_run_with_materialized():
    # the same chunks feed both runs: bit for bit, records and final state
    spec = _spec()
    kw = dict(sampling_steps=7, cutoff=13, verbose=False, record_vars=[("t", "v", False)])
    a, b = _build(), _build()
    o1, o2 = a.run(spec, **kw), b.run(spec.materialize(DT, torch.float64, device="cpu"), **kw)
    np.testing.assert_array_equal(o1.to_numpy("out"), o2.to_numpy("out"))
    np.testing.assert_array_equal(o1.to_numpy(("t", "v")), o2.to_numpy(("t", "v")))
    assert torch.equal(a.get_node("t").y, b.get_node("t").y)


def test_spec_driven_runs_match_jax():
    # a deterministic spec drives run and run_batch as JAX's drives JAX's
    kw = dict(sampling_steps=7, cutoff=13, verbose=False, record_vars=[("t", "v", False)])
    o1 = _build().run(_det(inputs), **kw)
    o2 = _build(JNetwork).run(_det(jinputs), **kw)
    np.testing.assert_allclose(o1.to_numpy("out"), o2.to_numpy("out"), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(o1.to_numpy(("t", "v")), o2.to_numpy(("t", "v")),
                               rtol=1e-12, atol=1e-12)
    etas = np.linspace(-2, 2, 4)
    bv = {("t", "li_op/eta"): etas}
    r1 = _build().run_batch(_det(inputs), batch_vars=bv, sampling_steps=5)
    r2 = _build(JNetwork).run_batch(_det(jinputs), batch_vars=bv, sampling_steps=5)
    np.testing.assert_allclose(r1["out"], np.asarray(r2["out"]), rtol=1e-12, atol=1e-12)


def test_single_channel_broadcast():
    spec = Pulse(T, channels=1, t_on=10, t_off=60, amp=2.0)
    o1 = _build().run(spec, sampling_steps=5, verbose=False)
    o2 = _build(JNetwork).run(jinputs.Pulse(T, channels=1, t_on=10, t_off=60, amp=2.0),
                              sampling_steps=5, verbose=False)
    np.testing.assert_allclose(o1.to_numpy("out"), o2.to_numpy("out"), rtol=1e-12, atol=1e-14)


def test_run_batch_per_trial_noise():
    B = 4
    spec = (Noise(T, channels=N, scale=0.5, seed=np.arange(B))
            + Pulse(T, channels=N, t_on=20, t_off=150, amp=1.5))
    kw = dict(sampling_steps=5, cutoff=10, record_vars=[("t", "v", True)])
    res = _build().run_batch(spec, **kw)
    assert res["out"].shape[0] == B
    dense = spec.materialize(DT, torch.float64, device="cpu")
    assert dense.shape == (B, T, N)
    ref = _build().run_batch(dense, **kw)
    np.testing.assert_array_equal(res["out"], ref["out"])
    for b in range(B):
        sb = (Noise(T, channels=N, scale=0.5, seed=int(b))
              + Pulse(T, channels=N, t_on=20, t_off=150, amp=1.5))
        assert torch.equal(sb.materialize(DT, torch.float64, device="cpu"), dense[b])
        ob = _build().run(sb, sampling_steps=5, cutoff=10, verbose=False,
                          record_vars=[("t", "v", True)])
        np.testing.assert_allclose(res["out"][b], ob.to_numpy("out"), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(res[("t", "v")][b], ob.to_numpy(("t", "v")),
                                   rtol=1e-12, atol=1e-14)
    assert np.abs(res["out"][0] - res["out"][1]).max() > 1e-6  # distinct streams


def test_run_batch_shared_spec_with_batch_vars():
    etas = np.linspace(-2, 2, 4)
    spec = Pulse(T, channels=N, t_on=0, t_off=T, amp=1.0) + Noise(T, channels=N, seed=9)
    res = _build().run_batch(spec, batch_vars={("t", "li_op/eta"): etas}, sampling_steps=5)
    ref = _build().run_batch(spec.materialize(DT, torch.float64, device="cpu"),
                             batch_vars={("t", "li_op/eta"): etas}, sampling_steps=5)
    np.testing.assert_array_equal(res["out"], ref["out"])


def test_poisson_statistics():
    rate, steps = 40.0, 4000
    dense = Poisson(steps, channels=8, rate=rate, seed=2).materialize(DT, torch.float64,
                                                                      CPU).numpy()
    assert set(np.round(np.unique(dense), 6)) <= {0.0, np.round(1.0 / DT, 6)}
    emp = (dense > 0).mean(axis=0) / DT
    assert np.all(np.abs(emp - rate) < 5 * np.sqrt(rate / (steps * DT)))
    db = Poisson(200, channels=4, rate=rate, seed=np.array([3, 4])).materialize(DT, device="cpu")
    assert db.shape == (2, 200, 4) and (db[0] != db[1]).any()
    assert torch.equal(db[0],
                       Poisson(200, channels=4, rate=rate, seed=3).materialize(DT, device=CPU))


def test_wiener_statistics():
    sigma, drift = 0.5, 0.2
    x = Wiener(2000, channels=16, sigma=sigma, drift=drift,
               seed=11).materialize(1e-3, torch.float64, device="cpu").numpy()
    np.testing.assert_allclose(x.std(), sigma / np.sqrt(1e-3), rtol=0.05)
    np.testing.assert_allclose(x.mean(), drift, atol=5 * x.std() / np.sqrt(x.size))
    # Var[integral of sigma dW over T] = sigma^2 T at any dt
    for dt in (1e-3, 4e-3):
        steps = int(round(1.0 / dt))
        paths = Wiener(steps, channels=2048, sigma=sigma, seed=3).materialize(
            dt, torch.float64, device="cpu").numpy()
        np.testing.assert_allclose((paths.sum(axis=0) * dt).var(), sigma**2, rtol=0.15)
    db = Wiener(100, channels=4, sigma=sigma, seed=np.array([3, 4])).materialize(1e-3,
                                                                                 device=CPU)
    assert db.shape == (2, 100, 4) and (db[0] != db[1]).any()
    assert torch.equal(db[0],
                       Wiener(100, channels=4, sigma=sigma, seed=3).materialize(1e-3, device=CPU))


def test_wiener_ou_stationary_variance():
    # li_op without coupling driven by Wiener(sigma) is an OU process: the
    # Euler-discretised stationary variance sigma^2 dt / (1 - (1 - dt/tau)^2)
    tau, sigma, dt, n, steps = 0.02, 1.0, 1e-3, 64, 20_000
    net = Network(dt, dtype=torch.float64, device="cpu")
    net.add_diffeq_node("ou", LI, weights=np.zeros((n, n)), source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext",
                        output_var="li_op/v", node_vars={"li_op/tau": tau})
    v = net.run(Wiener(steps, channels=n, sigma=sigma, seed=7), sampling_steps=1,
                cutoff=5_000, verbose=False).to_numpy("out")
    expect = sigma**2 * dt / (1.0 - (1.0 - dt / tau) ** 2)
    np.testing.assert_allclose(v.var(), expect, rtol=0.1)
    assert abs(expect - sigma**2 * tau / 2) / expect < 0.03


def test_stochastic_parts_draw_independent_streams():
    steps = 2000
    noise = Noise(steps, channels=1, scale=1.0, seed=0)
    pois = Poisson(steps, channels=1, rate=100.0, amp=1.0, seed=0)
    both = (pois + noise).materialize(DT, torch.float64, device="cpu").numpy()[:, 0]
    events = both > 500.0
    assert events.sum() > 100
    assert abs((both[events] - 1.0 / DT).mean() - both[~events].mean()) < 0.2
    double = (Noise(steps, channels=1, seed=0)
              + Noise(steps, channels=1, seed=0)).materialize(DT, device=CPU)
    single = Noise(steps, channels=1, scale=2.0, seed=0).materialize(DT, device="cpu")
    assert not np.allclose(double.numpy(), single.numpy())
    assert abs(float(double.std()) / np.sqrt(2.0) - 1.0) < 0.1


@pytest.mark.parametrize("T1", [100, CHUNK, CHUNK + 3])
def test_shifted_specs_continue_chunked_runs(T1):
    # two chunks of a run equal one run: the drive (bit for bit) and the
    # network's end state, wherever the chunk boundary falls
    def spec(steps):
        return (Pulse(steps, channels=N, t_on=50, t_off=180, amp=1.0)
                + Sine(steps, channels=N, freq=2.0, amp=0.3)
                + Noise(steps, channels=N, scale=0.4, seed=6))

    full, chunk = spec(2 * T1), spec(T1)
    d_full = full.materialize(DT, torch.float64, device="cpu")
    d_chunks = torch.cat([chunk.materialize(DT, torch.float64, device="cpu"),
                          chunk.shifted(T1).materialize(DT, torch.float64, device="cpu")])
    assert torch.equal(d_chunks, d_full)
    net_a, net_b = _build(), _build()
    net_a.run(full, sampling_steps=10, verbose=False)
    net_b.run(chunk, sampling_steps=10, verbose=False)
    net_b.run(chunk.shifted(T1), sampling_steps=10, verbose=False)
    assert torch.equal(net_b.get_node("t").y, net_a.get_node("t").y)


def test_drive_reads_one_block_at_a_time():
    # a run's drive makes one block of CHUNK steps at a time, in order; a
    # shifted noise spec (t0 off the chunk grid) continues the stream
    calls = []
    spec = Noise(3 * CHUNK - 10, channels=2, seed=1).shifted(10)
    values = spec.build(DT, torch.float32, "cpu")
    drive = inputs.Drive(lambda t, n: calls.append((t, n)) or values(t, n), spec.steps)
    rows = torch.stack([drive[t] for t in range(len(drive))])
    assert calls == [(0, CHUNK), (CHUNK, CHUNK), (2 * CHUNK, CHUNK - 10)]
    assert torch.equal(rows, spec.materialize(DT, device="cpu"))
    assert torch.equal(rows,
                       Noise(3 * CHUNK, channels=2, seed=1).materialize(DT, device=CPU)[10:])


def test_spec_with_feedback_network():
    Wa = np.random.default_rng(0).normal(size=(N, N)) / N
    Wb = np.random.default_rng(1).normal(size=(N, N)) / N
    Wab = np.random.default_rng(3).normal(size=(N, N)) * 0.5
    Wfb = np.random.default_rng(2).normal(size=(N, N)) * 0.1

    def build(cls):
        net = (cls(DT, dtype=jnp.float64) if cls is JFeedbackNetwork
               else cls(DT, dtype=torch.float64, device="cpu"))
        for label, W in (("a", Wa), ("b", Wb)):
            net.add_diffeq_node(label, LI, weights=W, source_var="tanh_op/r",
                                target_var="li_op/r_in", input_var="li_op/I_ext",
                                output_var="li_op/v")
        net.add_edge("a", "b", weights=Wab)
        net.add_edge("b", "a", feedback=True, weights=Wfb)
        return net

    spec = Pulse(T, channels=N, t_on=10, t_off=100, amp=1.0) + Noise(T, channels=N, seed=3)
    o1 = build(FeedbackNetwork).run(spec, sampling_steps=5, verbose=False)
    o2 = build(FeedbackNetwork).run(spec.materialize(DT, torch.float64, CPU), sampling_steps=5,
                                    verbose=False)
    np.testing.assert_array_equal(o1.to_numpy("out"), o2.to_numpy("out"))
    o3 = build(JFeedbackNetwork).run(
        jinputs.Pulse(T, channels=N, t_on=10, t_off=100, amp=1.0), sampling_steps=5,
        verbose=False)
    o4 = build(FeedbackNetwork).run(Pulse(T, channels=N, t_on=10, t_off=100, amp=1.0),
                                    sampling_steps=5, verbose=False)
    np.testing.assert_allclose(o4.to_numpy("out"), o3.to_numpy("out"), rtol=1e-12, atol=1e-13)
    assert np.abs(o1.to_numpy("out")).max() > 1e-3


def test_spec_errors():
    with pytest.raises(ValueError, match="unbatched"):
        _build().run(Noise(T, channels=N, seed=np.arange(3)), verbose=False)
    with pytest.raises(ValueError, match="batch_vars"):
        _build().run_batch(Pulse(T, channels=N, amp=1.0))
    with pytest.raises(ValueError, match="channels"):
        _build().run(Pulse(T, channels=N + 1, amp=1.0), verbose=False)
    with pytest.raises(ValueError, match="channels"):
        _build().run_batch(Noise(T, channels=N + 1, seed=np.arange(2)))
    with pytest.raises(ValueError, match="steps"):
        Pulse(100, channels=1) + Pulse(200, channels=1)
    with pytest.raises(ValueError, match="channels"):
        Pulse(T, channels=2) + Pulse(T, channels=3)
    with pytest.raises(ValueError, match="batch size"):
        Noise(T, seed=np.arange(2)) + Noise(T, seed=np.arange(3))
    with pytest.raises(ValueError, match="dist"):
        Noise(T, dist="poisson").build(DT, torch.float64, "cpu")
    with pytest.raises(ValueError, match="Pulse bounds"):
        Pulse(100, t_on=0, t_off=-10).build(DT, torch.float64, "cpu")
    with pytest.raises(ValueError, match="Pulse bounds"):
        Pulse(100, t_on=-5, t_off=50).build(DT, torch.float64, "cpu")
    with pytest.raises(ValueError, match="seed"):
        Noise(T, seed=np.zeros((2, 2), dtype=int)).build(DT, torch.float64, "cpu")
    tail = Pulse(10, t_on=2, t_off=-1, amp=1.0).materialize(DT, device=CPU)[2:, 0]
    np.testing.assert_array_equal(tail, 1.0)


def test_spec_device_defaults_to_the_card(monkeypatch):
    # like Network, a spec evaluates on the card unless the CPU is asked
    # for: with no card, the default raises instead of drawing on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = Pulse(10, channels=2, amp=1.0) + Noise(10, channels=2, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.materialize(DT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.drive(DT)
    assert spec.materialize(DT, device=CPU).device.type == "cpu"


def test_trainers_reject_specs_with_guidance():
    net = _build(train=True)
    with pytest.raises(TypeError, match="materialize"):
        net.fit_bptt(Pulse(T, channels=N, amp=1.0), np.zeros((T, N)))
    with pytest.raises(TypeError, match="materialize"):
        net.fit_bptt_batch(Noise(T, channels=N, seed=np.arange(2)), np.zeros((2, T, N)))
    with pytest.raises(TypeError, match="materialize"):
        np.asarray(Pulse(T, channels=N))
    dense = Pulse(T, channels=N, amp=0.1).materialize(DT, torch.float64, device="cpu")
    obs = net.fit_bptt([dense], [np.zeros((T, N))], optimizer="adam", lr=1e-3, verbose=False)
    assert np.isfinite(obs["epoch_loss"]).all()
