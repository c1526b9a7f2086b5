"""``Network.run_batch`` of the port against the JAX package, and the batched
kernels' plain versions against per-trial loops of the single-trial ones.
CPU, float64 unless stated, inputs from numpy seeds; the cases mirror
``tests/test_run_batch_sweep.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import FeedbackNetwork as JFeedbackNetwork
from rectipy_tpu import Network as JNetwork
from rectipy_tpu import inputs as jinputs
from rectipy_tpu.ops.generic_fused import attach_generic_fused_step as j_attach_generic
from rectipy_tpu.ops.kernels import attach_fused_qif_step as j_attach
from rectipy_tpu_torch import FeedbackNetwork, Network, attach_fused_qif_step
from rectipy_tpu_torch.ops import quant
from rectipy_tpu_torch.ops.generic_fused import attach_generic_fused_step
from rectipy_tpu_torch.ops.kernels import qif_sfa_reference_step, qif_sfa_step

J, T_ = "neuron_model_templates.", "rectipy_tpu_torch.models."
TANH = "rate_neurons.leaky_integrator.tanh"
QIF = "spiking_neurons.qif.qif"
QIF_SFA = "spiking_neurons.qif.qif_sfa"
LIF = "spiking_neurons.lif.lif"


def _kw(cls, dtype="float64"):
    if cls is JNetwork or cls is JFeedbackNetwork:
        return J, dict(dtype=getattr(jnp, dtype))
    return T_, dict(dtype=getattr(torch, dtype), device="cpu")


def _rate(cls, W, dtype="float64", coupling=None, out="tanh_op/r"):
    prefix, kw = _kw(cls, dtype)
    net = cls(1e-2, **kw)
    net.add_diffeq_node("p", prefix + TANH, weights=W, source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext", output_var=out,
                        coupling_dtype=coupling)
    return net


def _qif(cls, W, etas, dtype="float64", **kw):
    prefix, nkw = _kw(cls, dtype)
    net = cls(1e-2, **nkw)
    net.add_diffeq_node("p", prefix + QIF, weights=W, input_var="I_ext", output_var="s",
                        source_var="s", target_var="s_in", op="qif_op", spike_var="spike",
                        spike_def="v", spike_threshold=100.0, spike_reset=-100.0,
                        node_vars={"all/qif_op/eta": etas}, **kw)
    return net


def _out(res):
    return np.asarray(res["out"], dtype=np.float64)


def _both(build, inputs, **kw):
    """The records of ``run_batch`` in both packages, for ``build(cls)``."""
    return (build(JNetwork).run_batch(inputs, verbose=False, **kw),
            build(Network).run_batch(inputs, verbose=False, **kw))


@pytest.mark.parametrize("var,shape", [("eta", "scalar"), ("tau", "per_neuron"),
                                       ("weights", "matrix")])
def test_sweep_matches_jax_and_sequential(var, shape):
    # test_run_batch_sweep.py::test_sweep_matches_sequential: the sweep
    # against JAX's and against the port's single-trial runs, atol 1e-14
    rng = np.random.default_rng(0)
    N, B, T = 6, 4, 30
    W = rng.normal(scale=0.3, size=(N, N))
    ins = np.broadcast_to(rng.normal(size=(1, T, 1)), (B, T, 1)).copy()
    vals = {"scalar": np.linspace(-2.0, 3.0, B),
            "per_neuron": rng.uniform(5.0, 20.0, size=(B, N)),
            "matrix": rng.normal(scale=0.3, size=(B, N, N))}[shape]
    rj, rt = _both(lambda cls: _rate(cls, W), ins, batch_vars={("p", var): vals})
    assert rt["out"].shape == (B, T, N)
    np.testing.assert_allclose(rt["out"], _out(rj), rtol=0, atol=1e-14)
    for b in range(B):
        net = _rate(Network, W)
        net.set_var("p", var, vals[b])
        o = net.run(ins[b], verbose=False).to_numpy("out")
        np.testing.assert_allclose(rt["out"][b], o, rtol=0, atol=1e-14)


@pytest.mark.parametrize("s,cutoff", [(1, 0), (4, 5), (7, 13)])
def test_per_trial_inputs_and_windowed_records_match_jax(s, cutoff):
    # (B, T, m) inputs, windowed output records, a full (s = 1) or reduced
    # record_vars entry, sampling_steps and cutoff along axis 1
    rng = np.random.default_rng(1)
    N, B, T = 5, 3, 40
    W = rng.normal(scale=0.3, size=(N, N))
    ins = rng.normal(size=(B, T, N))
    kw = dict(sampling_steps=s, cutoff=cutoff, record_vars=[("p", "li_op/v", s > 1)])
    rj, rt = _both(lambda cls: _rate(cls, W), ins, **kw)
    assert sorted(map(str, rt)) == sorted(map(str, rj))
    np.testing.assert_array_equal(rt["steps"], np.asarray(rj["steps"]))
    R = len(rt["steps"])
    assert rt["out"].shape == (B, R, N)
    assert rt[("p", "li_op/v")].shape == ((B, R) if s > 1 else (B, R, N))
    for key in ("out", ("p", "li_op/v")):
        np.testing.assert_allclose(rt[key], np.asarray(rj[key]), rtol=1e-12, atol=1e-14)


def test_shared_drive_matches_tiled_and_jax():
    # test_run_batch_sweep.py::test_run_batch_shared_2d_inputs_match_tiled
    rng = np.random.default_rng(8)
    n, B, T = 4, 3, 25
    W = rng.standard_normal((n, n)) * 0.1
    inp = rng.normal(size=(T, n))
    etas = np.linspace(-0.5, 0.5, B)
    kw = dict(batch_vars={("p", "li_op/eta"): etas})
    rj, shared = _both(lambda cls: _rate(cls, W, out="li_op/v"), inp, **kw)
    tiled = _rate(Network, W, out="li_op/v").run_batch(np.broadcast_to(inp, (B, T, n)),
                                                       verbose=False, **kw)
    np.testing.assert_array_equal(shared["out"], tiled["out"])
    np.testing.assert_allclose(shared["out"], _out(rj), rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="shared"):
        _rate(Network, W).run_batch(inp, verbose=False)  # 2-D without batch_vars


def test_sweep_quantized_coupling_preps_per_trial():
    # test_run_batch_sweep.py::test_sweep_quantized_coupling_preps_per_trial:
    # a swept int8_master coupling is quantized per trial; float32, atol 1e-6
    rng = np.random.default_rng(1)
    N, B, T = 8, 3, 25
    W = rng.normal(scale=0.3, size=(N, N))
    Ws = rng.normal(scale=0.3, size=(B, N, N))
    ins = rng.normal(size=(B, T, 1))
    quant.int8_mv.launches = quant.int8_mm.launches = 0
    rj, rt = _both(lambda cls: _rate(cls, W, "float32", "int8_master"), ins,
                   batch_vars={("p", "weights"): Ws})
    np.testing.assert_allclose(rt["out"], _out(rj), rtol=0, atol=1e-6)
    for b in range(B):
        o = _rate(Network, Ws[b], "float32", "int8_master").run(ins[b], verbose=False)
        np.testing.assert_allclose(rt["out"][b], o.to_numpy("out"), rtol=0, atol=1e-6)


def test_frozen_int8_takes_one_activation_scale_per_trial():
    # trials whose sources differ 10x in amplitude: each trial quantizes its
    # source by its own max|src|, as JAX's vmap does; a scale shared by the
    # batch would round the small trial's source to a few levels
    rng = np.random.default_rng(2)
    N, B, T = 16, 2, 20
    W = rng.normal(scale=0.3, size=(N, N))
    ins = rng.normal(size=(1, T, N)) * np.array([1.0, 0.1])[:, None, None]
    rt = _rate(Network, W, "float32", torch.int8).run_batch(ins, verbose=False)
    rj = _rate(JNetwork, W, "float32", jnp.int8).run_batch(ins, verbose=False)
    np.testing.assert_allclose(rt["out"], _out(rj), rtol=1e-5, atol=1e-6)
    for b in range(B):
        o = _rate(Network, W, "float32", torch.int8).run(ins[b], verbose=False)
        np.testing.assert_array_equal(rt["out"][b], o.to_numpy("out"))
    x = torch.as_tensor(ins[:, 0], dtype=torch.float32)
    xq, xs = quant.quant_vec(x)
    assert xs.shape == (B, 1)
    for b in range(B):
        q1, s1 = quant.quant_vec(x[b])
        assert torch.equal(xq[b], q1) and torch.equal(xs[b, 0], s1)
    shared, _ = quant.quant_vec(x.reshape(-1))
    assert int(shared[N:].abs().max()) <= 13  # what one shared scale would leave


def test_qif_trials_cross_the_threshold_like_jax():
    # test_run_batch_sweep.py::test_sweep_qif_bifurcation_shape, against JAX
    rng = np.random.default_rng(2)
    N, B, T = 8, 6, 200
    W = np.abs(rng.normal(size=(N, N))) * 0.2
    etas = np.linspace(-5.0, 25.0, B)
    rj, rt = _both(lambda cls: _qif(cls, W, np.zeros(N)), np.zeros((B, T, N)),
                   batch_vars={("p", "eta"): etas},
                   record_vars=[("p", "v", False)])
    np.testing.assert_allclose(rt["out"], _out(rj), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(rt[("p", "v")], np.asarray(rj[("p", "v")]), rtol=1e-9,
                               atol=1e-8)
    rates = rt["out"].mean(axis=(1, 2))
    assert rates[0] < 1e-6 < rates[-1]
    assert np.all(np.diff(rates) >= -1e-9)


def _fb(cls):
    # two tanh populations, feedforward p1 -> p2 and feedback p2 -> p1
    prefix, kw = _kw(cls)
    rng = np.random.default_rng(5)
    net = cls(1e-2, **kw)
    for lbl in ("p1", "p2"):
        net.add_diffeq_node(lbl, prefix + TANH, weights=rng.normal(size=(4, 4)) * 0.3,
                            source_var="tanh_op/r", target_var="li_op/r_in",
                            input_var="li_op/I_ext", output_var="tanh_op/r")
    net.add_edge("p1", "p2", weights=rng.normal(size=(4, 4)) * 0.5)
    net.add_edge("p2", "p1", weights=rng.normal(size=(4, 4)) * 0.5, feedback=True)
    net.compile()
    return net


def test_feedback_network_matches_jax_and_keeps_its_store():
    rng = np.random.default_rng(6)
    ins = rng.normal(size=(3, 30, 4))
    jnet, tnet = _fb(JFeedbackNetwork), _fb(FeedbackNetwork)
    rj = jnet.run_batch(ins, verbose=False, sampling_steps=2)
    tnet.run(ins[0, :5], verbose=False)  # a carried feedback output to keep
    store = {k: v.clone() for k, v in tnet._fb_store.items()}
    jnet.run(ins[0, :5], verbose=False)
    rj = jnet.run_batch(ins, verbose=False, sampling_steps=2)
    rt = tnet.run_batch(ins, verbose=False, sampling_steps=2)
    np.testing.assert_allclose(rt["out"], _out(rj), rtol=1e-12, atol=1e-14)
    assert store.keys() == tnet._fb_store.keys()
    assert all(torch.equal(store[k], tnet._fb_store[k]) for k in store)
    ref = _fb(FeedbackNetwork)
    ref.run(ins[0, :5], verbose=False)
    o = ref.run(ins[1], verbose=False, sampling_steps=2).to_numpy("out")
    np.testing.assert_allclose(rt["out"][1], o, rtol=1e-12, atol=1e-14)


def test_t1_fallback_and_state_unchanged():
    # test_run_batch_sweep.py::test_sweep_t1_fallback; and the network's state
    # is left as it was (trials would disagree)
    rng = np.random.default_rng(4)
    N, B = 4, 3
    W = rng.normal(size=(N, N)) * 0.2
    etas = np.linspace(-1.0, 1.0, B)
    ins = rng.normal(size=(B, 1, 1))
    rj, rt = _both(lambda cls: _rate(cls, W), ins, batch_vars={("p", "eta"): etas})
    assert rt["out"].shape == (B, 1, N)
    np.testing.assert_allclose(rt["out"], _out(rj), rtol=0, atol=1e-14)
    net = _rate(Network, W)
    net.run(rng.normal(size=(5, 1)), verbose=False)
    y = net.get_node("p").y.clone()
    net.run_batch(rng.normal(size=(B, 9, 1)), verbose=False, batch_vars={("p", "eta"): etas})
    assert torch.equal(net.get_node("p").y, y)
    for b in range(B):
        n2 = _rate(Network, W)
        n2.set_var("p", "eta", etas[b])
        o = n2.run(ins[b], verbose=False).to_numpy("out")
        np.testing.assert_allclose(rt["out"][b], o, rtol=0, atol=1e-14)


def _fused(cls, n, etas, W, interpret=False):
    prefix, kw = _kw(cls, "float32")
    net = cls(1e-2, **kw)
    net.add_diffeq_node("qif", prefix + QIF_SFA, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", spike_var="spike", spike_def="v",
                        op="qif_sfa_op", spike_threshold=1e2, spike_reset=-1e2,
                        dtype=kw["dtype"],
                        node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/alpha": 0.05,
                                   "all/qif_sfa_op/k": 15.0})
    net.compile()
    node = net.get_node("qif")
    if cls is JNetwork:
        j_attach(node, interpret=interpret)
    else:
        attach_fused_qif_step(node)
    return net


def test_fused_qif_node_matches_jax_interpret():
    # the fused QIF node in run_batch: the port's B-row step (its plain
    # version here) against JAX's run_batch of the Pallas kernel in
    # interpret mode, float32; N = 16, B = 3, the trials cross the threshold
    n, B, T = 16, 3, 60
    rng = np.random.default_rng(9)
    W = rng.random((n, n)) / n
    etas = 200.0 + rng.normal(size=n) * 20.0
    ins = rng.normal(size=(B, T, 1)) * 20.0
    jnet = _fused(JNetwork, n, etas, W, interpret=True)
    rj = jnet.run_batch(ins, verbose=False, record_vars=[("qif", "v", False)])
    tnet = _fused(Network, n, etas, W)
    qif_sfa_step.launches = 0
    rt = tnet.run_batch(ins, verbose=False, record_vars=[("qif", "v", False)])
    np.testing.assert_allclose(rt["out"], _out(rj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rt[("qif", "v")], np.asarray(rj[("qif", "v")]), rtol=1e-4,
                               atol=1e-3)
    assert (rt[("qif", "v")] == -100.0).any()  # some neuron was reset


def test_fused_qif_node_applies_a_swept_eta():
    # the port routes a swept eta into the kernel's copy (JAX's fused node
    # reads its padded copy and ignores the sweep); each trial equals a
    # single-trial fused run with that eta
    n, B, T = 16, 3, 50
    rng = np.random.default_rng(10)
    W = rng.random((n, n)) / n
    etas = 200.0 + rng.normal(size=n) * 20.0
    offsets = np.linspace(-100.0, 100.0, B)
    drive = rng.normal(size=(T, 1))
    rt = _fused(Network, n, etas, W).run_batch(
        drive, verbose=False, batch_vars={("qif", "eta"): etas[None, :] + offsets[:, None]})
    for b in range(B):
        net = _fused(Network, n, etas, W)
        net.set_var("qif", "eta", etas + offsets[b])
        o = net.run(drive, verbose=False).to_numpy("out")
        np.testing.assert_allclose(rt["out"][b], o, rtol=1e-6, atol=1e-6)
    assert np.abs(rt["out"][0] - rt["out"][-1]).max() > 1e-3
    with pytest.raises(ValueError, match="only eta"):
        _fused(Network, n, etas, W).run_batch(drive, verbose=False,
                                              batch_vars={("qif", "tau"): np.ones(B)})


def test_edge_sweep_and_softmax_output_match_jax():
    # ("edge", src, tgt, "weights") sweeps per-trial input projections; a
    # softmax output node normalises each trial over its own neurons
    rng = np.random.default_rng(11)
    N, B, T = 5, 3, 20
    W = rng.normal(scale=0.3, size=(N, N))
    W_in = rng.normal(size=(B, N, 2))

    def build(cls):
        net = _rate(cls, W)
        net.add_func_node("inp", 2, activation_function="identity")
        net.add_func_node("sm", N, activation_function="softmax")
        net.add_edge("inp", "p", weights=W_in[0])
        net.add_edge("p", "sm", weights=np.eye(N))
        net.compile()
        return net

    ins = rng.normal(size=(T, 2))
    rj, rt = _both(build, ins, batch_vars={("edge", "inp", "p", "weights"): W_in})
    np.testing.assert_allclose(rt["out"], _out(rj), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(rt["out"].sum(axis=-1), 1.0, rtol=1e-12)


def test_frozen_int4_rows_on_the_plain_path():
    # int4 couplings take (B, n) sources through int4_mm, whose CPU tensors
    # take its plain version (no launch); each trial equals its single-trial
    # run
    rng = np.random.default_rng(12)
    N, B, T = 8, 3, 15
    W = rng.normal(scale=0.3, size=(N, N))
    ins = rng.normal(size=(B, T, 1))
    quant.int4_mm.launches = quant.int4_mv.launches = 0
    rt = _rate(Network, W, "float32", "int4").run_batch(ins, verbose=False)
    assert quant.int4_mm.launches == quant.int4_mv.launches == 0
    for b in range(B):
        o = _rate(Network, W, "float32", "int4").run(ins[b], verbose=False).to_numpy("out")
        np.testing.assert_allclose(rt["out"][b], o, rtol=0, atol=1e-6)


def test_run_batch_validation():
    # test_run_batch_sweep.py::test_sweep_validation
    rng = np.random.default_rng(3)
    N, B, T = 4, 3, 10
    net = _rate(Network, rng.normal(size=(N, N)) * 0.2)
    ins = rng.normal(size=(B, T, 1))
    with pytest.raises(KeyError, match="not a parameter"):
        net.run_batch(ins, batch_vars={("p", "nope"): np.ones(B)})
    with pytest.raises(ValueError, match="leading dimension"):
        net.run_batch(ins, batch_vars={("p", "eta"): np.ones(B + 1)})
    with pytest.raises(ValueError, match=r"\(B, T, m\)"):
        net.run_batch(ins[0, :, 0])
    with pytest.raises(ValueError, match="channels"):
        net.run_batch(rng.normal(size=(B, T, 3)))


@pytest.mark.parametrize("case", ["record_spikes", "mesh", "input_spec"])
def test_unported_run_batch_features_raise(case):
    # mesh=, record_spikes and input specs are ported
    # (tests/test_torch_parallel*.py, tests/test_torch_record_spikes.py,
    # tests/test_torch_inputs.py) and refuse what they cannot take: a mesh
    # that is no DeviceMesh, a rate node's spikes, and an unbatched spec
    # without batch_vars to give the trials
    from rectipy_tpu_torch.inputs import Pulse

    rng = np.random.default_rng(13)
    n = 6
    ins = rng.normal(size=(2, 5, 1))
    net = _rate(Network, rng.normal(size=(n, n)) * 0.2)
    if case == "mesh":
        with pytest.raises(TypeError, match="DeviceMesh"):
            net.run_batch(ins, mesh=object())
        return
    jnet = _rate(JNetwork, rng.normal(size=(n, n)) * 0.2)
    if case == "record_spikes":
        for nt in (net, jnet):
            with pytest.raises(ValueError, match="not a spiking node"):
                nt.run_batch(ins, record_spikes=["p"])
    else:
        for nt, spec in ((net, Pulse(5, channels=1)), (jnet, jinputs.Pulse(5, channels=1))):
            with pytest.raises(ValueError, match="batch_vars"):
                nt.run_batch(spec)


def _generic(cls, case, n, rng):
    """A LIF SpikeResetNet (bf16-free f32 coupling, per-neuron tau) or a
    Heun tanh RateNet, float32, with the generic fused step attached (the
    JAX package's Pallas kernel in interpret mode)."""
    prefix, kw = _kw(cls, "float32")
    net = cls(1e-2, **kw)
    tau = rng.uniform(10.0, 15.0, size=n)
    if case == "lif":
        net.add_diffeq_node("lif", prefix + LIF, weights=np.abs(rng.normal(size=(n, n))) * 0.05,
                            source_var="s", target_var="s_in", input_var="I_ext",
                            output_var="s", op="lif_op", spike_var="spike", reset_var="v",
                            spike_threshold=10.0, spike_reset=-10.0, dtype=kw["dtype"],
                            node_vars={"eta": 10.0, "tau": tau, "tau_s": 5.0})
    else:
        net.add_diffeq_node("p", prefix + TANH, weights=rng.normal(size=(n, n)) * 0.3,
                            source_var="tanh_op/r", target_var="li_op/r_in",
                            input_var="li_op/I_ext", output_var="li_op/v", integrator="heun",
                            dtype=kw["dtype"], node_vars={"all/li_op/tau": tau})
    net.compile()
    node = net.get_node(list(net.nodes)[0])
    if cls is JNetwork:
        j_attach_generic(node, tile=128, interpret=True)
    else:
        attach_generic_fused_step(node)
    return net


@pytest.mark.parametrize("case,atol", [("lif", 2e-4), ("tanh_heun", 5e-5)])
def test_generic_fused_node_matches_jax_and_single_trials(case, atol):
    # the generic fused node in run_batch: one launch per trial per step of
    # the single-trial kernel (its plain version here), against JAX's
    # run_batch of the Pallas kernel in interpret mode (test_generic_fused.py's
    # tolerances), and each trial against a single-trial run
    n, B, T = 16, 3, 100
    ins = (np.random.default_rng(14).normal(size=(B, T, 1)) * 3.0
           + np.linspace(10.0, 30.0, B)[:, None, None])
    rj, rt = (_generic(cls, case, n, np.random.default_rng(15)).run_batch(ins, verbose=False)
              for cls in (JNetwork, Network))
    np.testing.assert_allclose(rt["out"], _out(rj), rtol=1e-4, atol=atol)
    for b in range(B):
        net = _generic(Network, case, n, np.random.default_rng(15))
        o = net.run(ins[b], verbose=False).to_numpy("out")
        np.testing.assert_allclose(rt["out"][b], o, rtol=0, atol=1e-6)
    assert np.abs(rt["out"][0] - rt["out"][-1]).max() > 1e-3
    if case == "lif":
        assert rt["out"].max() > 0, "no spikes -- weak test"
        net = _generic(Network, case, n, np.random.default_rng(15))
        with pytest.raises(ValueError, match="none can be swept"):
            net.run_batch(ins[0], verbose=False, batch_vars={("lif", "eta"): np.ones(B)})


# ---------------------------------------------------- batched plain versions
@pytest.mark.parametrize("B,n_out,n_in", [(7, 33, 48), (3, 16, 16)])
def test_int8_mm_plain_versions_equal_per_row_loops(B, n_out, n_in):
    # bit for bit: the batched products and their epilogues against a loop
    # of the single-vector ones, trial by trial
    rng = np.random.default_rng(14)
    wq = torch.as_tensor(rng.integers(-127, 128, size=(n_out, n_in)), dtype=torch.int8)
    xq = torch.as_tensor(rng.integers(-127, 128, size=(B, n_in)), dtype=torch.int8)
    vq = torch.as_tensor(rng.integers(-127, 128, size=(B, n_out)), dtype=torch.int8)
    rs = torch.as_tensor(rng.random(n_out), dtype=torch.float32)
    act = torch.as_tensor(rng.random(B) + 0.5, dtype=torch.float32)
    mm, mm_t = quant.int8_mm(wq, xq, rs, act), quant.int8_mm_t(wq, vq, act)
    for b in range(B):
        assert torch.equal(mm[b], quant.int8_mv(wq, xq[b], rs, act[b]))
        assert torch.equal(mm_t[b], quant.int8_mv_t(wq, vq[b], act[b]))
    assert torch.equal(quant.int8_mm_plain(wq, xq)[2], quant.int8_dot_plain(wq, xq[2]))


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_qif_rows_plain_equals_per_trial_oracle(w_dtype):
    # the B-row step's plain version against the single-row oracle, trial by
    # trial (bit for bit), with a shared x operand and per-trial eta
    rng = np.random.default_rng(15)
    B, n = 4, 24
    W = torch.as_tensor(rng.random((n, n)) / n, dtype=torch.float32).to(w_dtype)
    v, s, inp, eta = (torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.normal(size=(B, n)) * 80.0, rng.random((B, n)), rng.normal(size=(B, n)),
        rng.normal(size=(B, n))))
    x = torch.as_tensor(rng.random(n), dtype=torch.float32)
    p = dict(dt=1e-4, tau=1.0, tau_s=1.0, tau_x=10.0, k=15.0, alpha=0.05, thresh=100.0,
             v_reset=-100.0)
    out = qif_sfa_step(v, s, x, W, eta, inp, **p)
    assert out.shape == (B, 3, n)
    for b in range(B):
        ref = torch.stack(qif_sfa_reference_step(v[b], s[b], x, W, eta[b], inp[b], **p))
        torch.testing.assert_close(out[b], ref, rtol=1e-6, atol=1e-5)
