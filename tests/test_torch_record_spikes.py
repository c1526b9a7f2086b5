"""``record_spikes`` of the port against the JAX package: per-window spike
counts of ``run`` and ``run_batch`` (CPU, float64 unless stated, inputs from
numpy seeds; the cases of ``tests/test_record_spikes.py``).  The counts are
integers: they must equal JAX's exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.ops.kernels import attach_fused_qif_step as j_attach
from rectipy_tpu_torch import Network, Observer, attach_fused_qif_step

QIF_SFA = "rectipy_tpu.models.spiking_neurons.qif.qif_sfa"
QIF_RESET = "rectipy_tpu.models.spiking_neurons.qif.qif_reset"
QIF = "rectipy_tpu.models.spiking_neurons.qif.qif"
IK = "rectipy_tpu.models.spiking_neurons.ik.ik"
TANH = "rectipy_tpu.models.rate_neurons.leaky_integrator.tanh"
# dt so that the suprathreshold QIF period spans a few dozen steps
N, T, DT = 16, 300, 1e-2


def _net(cls, dtype="float64", dt=DT):
    if cls is JNetwork:
        return cls(dt, dtype=getattr(jnp, dtype))
    return cls(dt, device="cpu", dtype=getattr(torch, dtype))


def _reset(cls):  # SpikeResetNet: the framework's hard reset
    rng = np.random.default_rng(0)
    net = _net(cls)
    net.add_diffeq_node("qif", QIF_SFA, weights=rng.normal(size=(N, N)) * 0.1 / N,
                        source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
                        spike_var="spike", spike_def="v", op="qif_sfa_op",
                        spike_threshold=10.0, spike_reset=-10.0,
                        node_vars={"all/qif_sfa_op/eta":
                                   3.0 + np.random.default_rng(1).normal(size=N)})
    return net


def _intrinsic(cls):  # SpikeNet: the equations reset
    rng = np.random.default_rng(0)
    net = _net(cls)
    net.add_diffeq_node("qif", QIF_RESET, weights=rng.normal(size=(N, N)) * 0.1 / N,
                        source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
                        spike_var="spike", reset_var="reset", reset=False, spike_def="v",
                        op="qif_reset_op", spike_threshold=10.0, spike_reset=-10.0,
                        node_vars={"all/qif_reset_op/eta":
                                   3.0 + np.random.default_rng(1).normal(size=N)})
    return net


def _multi(cls):  # MultiSpikeResetNet: a list spike_var
    rng = np.random.default_rng(41)
    net = _net(cls)
    net.add_diffeq_node("qif", IK, weights=np.abs(rng.normal(size=(N, N))) * 0.02,
                        source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
                        op="ik_op", spike_var=["spike"], reset_var=["v"],
                        spike_threshold=40.0, spike_reset=-60.0,
                        node_vars={"eta": rng.uniform(150.0, 250.0, N),
                                   "v": rng.uniform(-60.0, 35.0, N)})
    return net


CASES = {"spike_reset_net": (_reset, 15.0), "spike_net": (_intrinsic, 15.0),
            "multi_spike_reset_net": (_multi, 20.0)}


def _counts(obs, label="qif"):
    return obs.to_numpy((label, "spikes"))


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_counts_match_jax_and_eager_oracle(case):
    # test_windowed_counts_match_eager_oracle, for each spiking class
    build, drive = CASES[case]
    s = 7
    inp = np.full((T, N), drive)
    kw = dict(sampling_steps=s, verbose=False, record_spikes=["qif"])
    want = _counts(build(JNetwork).run(inp, **kw))
    tnet = build(Network)
    got = _counts(tnet.run(inp, **kw))
    assert got.dtype == np.int32 and got.shape == want.shape and got.shape[1] == N
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0, "expected spikes in the suprathreshold regime"
    # the eager oracle: the reader's decision on each pre-update state,
    # summed into the same windows (step 0 its own)
    net = build(Network)
    reader = net.get_node("qif")._make_spike_reader()
    counts, buf = [], np.zeros(N)
    for t in range(T):
        buf = buf + reader(net.get_node("qif").y).numpy()
        net.forward(inp[t])
        if t % s == 0:
            counts.append(buf)
            buf = np.zeros(N)
    np.testing.assert_array_equal(got, np.stack(counts)[:got.shape[0]])


def test_spike_reader_is_the_reset_decision():
    # SpikeResetNet: the reader marks exactly the neurons the step resets
    net = _reset(Network)
    node = net.get_node("qif")
    step, reader = node.make_step(), node._make_spike_reader()
    lo, hi = node._reset_lo, node._reset_hi
    y = node.y.clone()
    y[lo:hi] = torch.linspace(5.0, 15.0, N, dtype=y.dtype)
    y_new, _ = step(y, node.args, torch.full((N,), 15.0, dtype=y.dtype))
    assert torch.equal(reader(y) > 0, y_new[lo:hi] == -10.0)
    assert reader(y).sum() > 0 and not reader(y).requires_grad
    # (B, S) states slice the last axis
    rows = reader(torch.stack([y, y]))
    assert rows.shape == (2, N) and torch.equal(rows[1], reader(y))


@pytest.mark.parametrize("center", [1.0, 0.5])
def test_spike_reader_equals_the_surrogate_forward(center):
    # the reader is the forward of the node's surrogate spike, heaviside(v -
    # thresh, center), on values at, above and below the threshold
    net = _net(Network)
    net.add_diffeq_node("qif", QIF_SFA, weights=np.zeros((N, N)), source_var="s",
                        target_var="s_in", input_var="I_ext", output_var="s",
                        spike_var="spike", spike_def="v", op="qif_sfa_op",
                        spike_threshold=10.0, spike_reset=-10.0, spike_center=center)
    node = net.get_node("qif")
    y = node.y.clone()
    y[:N] = torch.tensor([10.0, 10.0 + 1e-12, 10.0 - 1e-12, -3.0, 12.0, np.inf, -np.inf,
                          9.999999999999998] * 2, dtype=y.dtype)
    got = node._make_spike_reader()(y)
    assert torch.equal(got, node.spike(y[:N] - 10.0))
    assert got[0] == center and got.dtype == y.dtype


@pytest.mark.parametrize("s,cutoff", [(10, 95), (5, 1), (20, 40)])
def test_cutoff_and_sampling_alignment(s, cutoff):
    # records at steps >= cutoff; a window straddling the cutoff counts its
    # later steps only
    inp = np.full((T, N), 15.0)
    kw = dict(sampling_steps=s, verbose=False, record_spikes=["qif"])
    full = _reset(Network).run(inp, **kw)
    cut = _reset(Network).run(inp, cutoff=cutoff, **kw)
    np.testing.assert_array_equal(_counts(cut), _counts(_reset(JNetwork).run(
        inp, cutoff=cutoff, **kw)))
    f, c = _counts(full), _counts(cut)
    kept = np.asarray(full["steps"]) >= cutoff
    np.testing.assert_array_equal(c[1:], f[kept][1:])
    assert (c[0] <= f[kept][0]).all()


def test_run_batch_counts_match_jax_and_single_runs():
    # test_run_batch_and_total_rate
    s, drives = 5, (12.0, 15.0, 18.0)
    inp = np.stack([np.full((T, N), a) for a in drives])
    rj = _reset(JNetwork).run_batch(inp, sampling_steps=s, record_spikes=["qif"])
    rt = _reset(Network).run_batch(inp, sampling_steps=s, record_spikes=["qif"])
    counts = rt[("qif", "spikes")]
    assert counts.shape[0] == len(drives) and counts.dtype == np.int32
    np.testing.assert_array_equal(counts, np.asarray(rj[("qif", "spikes")]))
    for b in range(len(drives)):
        ob = _reset(Network).run(inp[b], sampling_steps=s, verbose=False,
                                 record_spikes=["qif"])
        np.testing.assert_array_equal(counts[b], _counts(ob))
    totals = counts.sum(axis=(1, 2))
    assert totals[0] < totals[2]


def _fused(cls, fused):
    n, rng = 32, np.random.default_rng(3)
    net = _net(cls, "float32", dt=1e-3)
    net.add_diffeq_node("qif", QIF_SFA, weights=np.abs(rng.normal(size=(n, n))) * 0.02,
                        source_var="s", target_var="s_in", input_var="I_ext", output_var="s",
                        spike_var="spike", spike_def="v", op="qif_sfa_op",
                        spike_threshold=30.0, spike_reset=-30.0, dtype=net.dtype,
                        node_vars={"all/qif_sfa_op/eta": rng.normal(size=n) + 100.0})
    net.compile()
    if fused:
        (j_attach(net.get_node("qif"), tile=128, interpret=True) if cls is JNetwork
         else attach_fused_qif_step(net.get_node("qif")))
    return net


def test_fused_qif_node_counts():
    # the reader reads the state, so the fused step's counts follow its
    # trajectory: the port's fused node (its plain version here) against
    # JAX's Pallas kernel in interpret mode and against the unfused port;
    # float32 steps in another order may flip a borderline spike (the JAX
    # test's bound: under 1% of the entries)
    inp = np.random.default_rng(5).normal(size=(400, 32)).astype(np.float32) * 10.0
    kw = dict(sampling_steps=5, verbose=False, record_spikes=["qif"])
    fused = _counts(_fused(Network, True).run(inp, **kw))
    plain = _counts(_fused(Network, False).run(inp, **kw))
    jax_fused = _counts(_fused(JNetwork, True).run(inp, **kw))
    assert plain.sum() > 0
    assert (fused != plain).mean() < 0.01
    assert (fused != jax_fused).mean() < 0.01
    # batched: every trial of the B-row step against its single-trial run
    res = _fused(Network, True).run_batch(np.stack([inp, inp * 0.5]), sampling_steps=5,
                                          record_spikes=["qif"])
    np.testing.assert_array_equal(res[("qif", "spikes")][0], fused)


def test_bfloat16_node_counts_in_float32():
    # the counts accumulate in float32: a window of 300 steps of a neuron
    # spiking every step counts past bfloat16's 256
    net = Network(1e-3, device="cpu", dtype=torch.bfloat16)
    net.add_diffeq_node("qif", QIF, weights=np.zeros((4, 4)), source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="qif_op", spike_var="spike",
                        reset_var="v", spike_threshold=-1e3, spike_reset=0.0)
    obs = net.run(np.zeros((301, 1)), sampling_steps=300, verbose=False, record_spikes=["qif"],
                  record_output=False)
    np.testing.assert_array_equal(_counts(obs), [[1] * 4, [300] * 4])


@pytest.mark.parametrize("cls", [Network, JNetwork], ids=["port", "jax"])
def test_non_spiking_node_raises(cls):
    net = _net(cls)
    net.add_diffeq_node("li", TANH, weights=np.eye(4), source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext", output_var="li_op/v")
    with pytest.raises(ValueError, match="spiking"):
        net.run(np.zeros((10, 4)), record_spikes=["li"], verbose=False)
    with pytest.raises(ValueError, match="spiking"):
        net.run_batch(np.zeros((2, 10, 4)), record_spikes=["li"])


def _regular(cls):
    n, rng = 4, np.random.default_rng(7)
    net = _net(cls, dt=1e-3)
    net.add_diffeq_node("qif", QIF, weights=np.zeros((n, n)), source_var="s",
                        target_var="s_in", input_var="I_ext", output_var="s", op="qif_op",
                        spike_var="spike", reset_var="v",
                        node_vars={"all/qif_op/eta": rng.uniform(1.0, 3.0, n)})
    return net


def test_observer_psth_raster_isi_stats_on_a_port_run():
    # test_observer_psth_from_run, test_raster_plot_helper and
    # test_observer_isi_stats_regular_spiking_end_to_end on a port run,
    # and the same statistics as JAX's run
    import matplotlib
    matplotlib.use("Agg")
    kw = dict(sampling_steps=1, verbose=False, record_spikes=["qif"])
    inp = np.full((2000, 1), 50.0)
    obs, jobs = _regular(Network).run(inp, **kw), _regular(JNetwork).run(inp, **kw)
    counts = _counts(obs)
    np.testing.assert_array_equal(counts, _counts(jobs))
    assert (counts.sum(axis=0) >= 3).all(), "every neuron must spike repeatedly"
    st, jst = obs.isi_stats("qif"), jobs.isi_stats("qif")
    for key in ("mean_isi", "cv", "fano"):
        np.testing.assert_allclose(st[key], jst[key], rtol=1e-12)
    assert np.all(st["cv"] < 0.15) and np.all(st["fano"] <= 1.0 + 1e-9)
    np.testing.assert_allclose(st["mean_isi"], 1.0 / obs.rates("qif"), rtol=0.25)
    times, rate = obs.psth("qif")
    jtimes, jrate = jobs.psth("qif")
    np.testing.assert_allclose(rate, jrate, rtol=1e-12)
    np.testing.assert_allclose(times, jtimes)
    ax = obs.raster("qif")
    assert ax.collections[0].get_offsets().shape[0] == (counts > 0).sum()


def test_observer_npz_round_trip_of_spike_counts(tmp_path):
    obs = _regular(Network).run(np.full((200, 1), 50.0), sampling_steps=20, verbose=False,
                                record_spikes=["qif"], record_vars=[("qif", "v", True)])
    obs2 = Observer.from_npz(obs.to_npz(str(tmp_path / "obs")))
    np.testing.assert_array_equal(_counts(obs2), _counts(obs))
    np.testing.assert_array_equal(obs2.to_numpy(("qif", "v")), obs.to_numpy(("qif", "v")))
    np.testing.assert_allclose(obs2.rates("qif"), obs.rates("qif"))
