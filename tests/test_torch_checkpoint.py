"""The port's checkpoints (``rectipy_tpu_torch.checkpoint``) against the JAX
package's (``rectipy_tpu.checkpoint``), on the CPU at float64: the cases of
``tests/test_checkpoint.py`` (a restored network continues the exact
trajectory; rolling training checkpoints; STDP weights, traces and
eligibility; the homeostasis sidecar; a legacy snapshot clears a stale
schedule), the JAX package's key layout, and the port's own cases: bfloat16
leaves restored bit for bit, and a fused node's kernel copies rebuilt on
restore.  Restore-then-continue is held to the uninterrupted run bit for
bit; the port's runs to JAX's within rtol 1e-10 (the tolerance of
``tests/test_torch_stdp.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.checkpoint import _flatten_with_paths as j_flatten
from rectipy_tpu_torch import Network, attach_fused_qif_step
from rectipy_tpu_torch.checkpoint import (BF16_RECORD, TrainCheckpointer, restore_network,
                                          restore_pytree, save_network, save_pytree)
from rectipy_tpu_torch.train import get_optimizer

TANH = "neuron_model_templates.rate_neurons.leaky_integrator.tanh"
LIF = "rectipy_tpu.models.spiking_neurons.lif.lif"
QIF_SFA = "rectipy_tpu.models.spiking_neurons.qif.qif_sfa"
TIGHT = dict(rtol=1e-10, atol=0.0)


def _new(jax, dt, dtype="float64"):
    if jax:
        return JNetwork(dt, dtype=getattr(jnp, dtype))
    return Network(dt, dtype=getattr(torch, dtype), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).detach().numpy()
    return np.asarray(x)


def _build(jax, n, W):
    net = _new(jax, 1e-2)
    net.add_diffeq_node("rnn", TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", train_params=["weights"])
    net.compile()
    return net


def test_network_snapshot_roundtrip(tmp_path):
    """A fresh network restored from disk continues the exact trajectory of
    the saved one (and JAX's)."""
    n = 8
    rng = np.random.default_rng(0)
    W = rng.normal(size=(n, n)) * 0.3
    inp, inp2 = rng.normal(size=(30, n)), rng.normal(size=(10, n))
    net, jnet = _build(False, n, W), _build(True, n, W)
    net.run(inp, verbose=False)
    jnet.run(inp, verbose=False)
    save_network(net, str(tmp_path / "ckpt"))
    net2 = _build(False, n, np.zeros((n, n)))
    restore_network(net2, str(tmp_path / "ckpt"))
    assert torch.equal(net2.get_node("rnn").y, net.get_node("rnn").y)
    np.testing.assert_array_equal(_np(net2.get_node("rnn")["weights"]), W)
    out_a = net.run(inp2, verbose=False).to_numpy("out")
    out_b = net2.run(inp2, verbose=False).to_numpy("out")
    np.testing.assert_array_equal(out_b, out_a)
    np.testing.assert_allclose(out_b, jnet.run(inp2, verbose=False).to_numpy("out"), **TIGHT)


def test_npz_keys_are_the_jax_packages(tmp_path):
    """The snapshot's keys are the JAX package's _flatten_with_paths keys
    of the same network (params and state)."""
    n = 6
    W = np.random.default_rng(1).normal(size=(n, n)) * 0.3
    net, jnet = _build(False, n, W), _build(True, n, W)
    save_network(net, str(tmp_path / "k"))
    with np.load(str(tmp_path / "k.npz")) as data:
        keys = set(data.files)
    jkeys = set(j_flatten({"params": jnet.parameters_pytree(), "state": jnet.init_state()}))
    assert keys == jkeys


def test_train_checkpointer_rolls_and_restores(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "ckpts"), keep=2)
    opt = get_optimizer("adam", 1e-3)
    train = {"w": torch.arange(4.0)}
    opt_state = opt.init(train)
    for step in [10, 20, 30]:
        ckpt.save(step, train={"w": train["w"] + step}, opt_state=opt_state)
    assert ckpt.all_steps() == [20, 30]  # keep=2 pruned step 10
    step, pieces = ckpt.restore_latest({"train": {"w": train["w"]}, "opt_state": opt_state})
    assert step == 30
    np.testing.assert_array_equal(pieces["train"]["w"].numpy(), np.arange(4.0) + 30)


def test_restore_missing_raises(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "empty"))
    assert ckpt.restore_latest({}) == (None, None)
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones((2, 2))}, "s": 2.5}
    save_pytree(tree, str(tmp_path / "t"))
    out = restore_pytree(tree, str(tmp_path / "t"))
    assert torch.equal(out["b"]["c"], tree["b"]["c"]) and out["s"] == 2.5
    with pytest.raises(FileNotFoundError):
        restore_pytree(tree, str(tmp_path / "missing"))
    with pytest.raises(KeyError):
        restore_pytree({"z": torch.ones(1)}, str(tmp_path / "t"))
    with pytest.raises(ValueError, match="shape"):
        restore_pytree({"a": torch.ones(3)}, str(tmp_path / "t"))


def _stdp_net(jax, w_dtype=None, w0=0.3, soft=False):
    net = _new(jax, 0.1)
    net.add_func_node("inp", 2, activation_function="identity")
    for label, sel in (("pre", [[1.0, 0.0]]), ("post", [[0.0, 1.0]])):
        net.add_diffeq_node(label, LIF, weights=np.zeros((1, 1)), source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            op="lif_op", spike_var="spike", reset_var="v",
                            spike_threshold=1.0, spike_reset=0.0)
        net.add_edge("inp", label, weights=np.array(sel))
    kw = dict(w_dtype=w_dtype) if w_dtype else {}
    net.add_edge("pre", "post", train="stdp", weights=np.full((1, 1), w0), tau_plus=1.0,
                 tau_minus=1.0, a_plus=0.05, a_minus=0.05, w_min=0.0, w_max=1.0,
                 soft_bounds=soft, **kw)
    return net


def test_plastic_edge_state_roundtrip(tmp_path):
    """STDP weights, both pair traces and the R-STDP eligibility trace are
    part of the snapshot: plasticity resumes exactly (and as JAX's)."""
    rng = np.random.default_rng(5)
    T = 120
    x = (rng.random((T, 2)) < 0.1) * 40.0
    r = rng.normal(0.0, 0.3, size=T)
    kw = dict(reward=r, tau_e=4.0, sampling_steps=30, verbose=False)
    net, jnet = _stdp_net(False), _stdp_net(True)
    net.fit_stdp(x, **kw)
    jnet.fit_stdp(x, **kw)
    save_network(net, str(tmp_path / "plastic"))
    saved = {k: v.clone() for k, v in net.get_edge("pre", "post").params.items()}
    assert "elig" in saved

    net2 = _stdp_net(False)
    restore_network(net2, str(tmp_path / "plastic"))
    for k, v in saved.items():
        assert torch.equal(net2.get_edge("pre", "post").params[k], v), k
    for m in (net, net2, jnet):
        m.fit_stdp(x, **kw)
    w = net.get_edge("pre", "post").params["weights"]
    assert torch.equal(net2.get_edge("pre", "post").params["weights"], w)
    np.testing.assert_allclose(_np(w), np.asarray(jnet.get_edge("pre", "post").params["weights"]),
                               **TIGHT)


def _homeo_net(jax, w0):
    net = _new(jax, 0.1)
    net.add_func_node("inp", 6, activation_function="identity")
    for label, n, k in (("pre", 4, 0), ("post", 2, 4)):
        net.add_diffeq_node(label, LIF, weights=np.zeros((n, n)), source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            op="lif_op", spike_var="spike", reset_var="v",
                            spike_threshold=1.0, spike_reset=0.0)
        net.add_edge("inp", label, weights=np.eye(n, 6, k=k))
    net.add_edge("pre", "post", train="stdp", weights=w0, tau_plus=2.0,
                 tau_minus=2.0, a_plus=0.05, a_minus=0.04, w_min=0.0, w_max=1.0)
    return net


def test_homeostasis_schedule_roundtrip(tmp_path):
    """The homeostasis sidecar (per-row target, schedule phase): a restored
    network continues the exact scaling schedule of one uninterrupted
    chunked run; a snapshot taken before any homeostatic fit restores to
    'no schedule'."""
    rng = np.random.default_rng(9)
    T, h = 70, 16  # 70 % 16 != 0: phase 6 at the checkpoint
    x = (rng.random((T, 6)) < 0.15) * 40.0
    w0 = rng.uniform(0.1, 0.4, size=(2, 4))
    kw = dict(sampling_steps=40, homeostasis_steps=h, verbose=False)
    net_b = _homeo_net(False, w0)
    net_b.fit_stdp(x[:40], **kw)
    save_network(net_b, str(tmp_path / "homeo"))
    net_c = _homeo_net(False, w0)
    restore_network(net_c, str(tmp_path / "homeo"))
    edge_c = net_c.get_edge("pre", "post")
    assert int(edge_c._homeo_phase) == 40 % h
    np.testing.assert_allclose(_np(edge_c._homeo_target), w0.sum(axis=1), rtol=1e-12)
    net_c.fit_stdp(x[40:], **kw)
    net_d = _homeo_net(False, w0)
    net_d.fit_stdp(x[:40], **kw)
    net_d.fit_stdp(x[40:], **kw)
    assert torch.equal(edge_c.params["weights"], net_d.get_edge("pre", "post").params["weights"])
    jnet = _homeo_net(True, w0)
    jnet.fit_stdp(x, **kw)
    np.testing.assert_allclose(_np(edge_c.params["weights"]),
                               np.asarray(jnet.get_edge("pre", "post").params["weights"]),
                               **TIGHT)

    save_network(_homeo_net(False, w0), str(tmp_path / "fresh"))
    net_f = _homeo_net(False, w0)
    net_f._homeo_left_over = True  # an unrelated attribute survives
    restore_network(net_f, str(tmp_path / "fresh"))
    edge_f = net_f.get_edge("pre", "post")
    assert not hasattr(edge_f, "_homeo_target") and not hasattr(edge_f, "_homeo_phase")
    assert net_f._homeo_left_over


def test_legacy_snapshot_clears_stale_homeo_schedule(tmp_path):
    """Restoring a pre-sidecar snapshot (params + state only) CLEARS any live
    homeostasis schedule."""
    from rectipy_tpu_torch.checkpoint import _canonicalize_plastic_edges

    rng = np.random.default_rng(11)
    x = (rng.random((48, 6)) < 0.2) * 40.0
    net = _homeo_net(False, np.full((2, 4), 0.3))
    net.fit_stdp(x, sampling_steps=24, homeostasis_steps=10, verbose=False)
    edge = net.get_edge("pre", "post")
    assert hasattr(edge, "_homeo_target")
    legacy = {"params": net.parameters_pytree(), "state": net.init_state()}
    _canonicalize_plastic_edges(legacy)
    save_pytree(legacy, str(tmp_path / "legacy"))
    restore_network(net, str(tmp_path / "legacy"))
    assert not hasattr(edge, "_homeo_target") and not hasattr(edge, "_homeo_phase")


def test_bf16_stdp_edge_restores_bit_for_bit(tmp_path):
    """A w_dtype=bfloat16 STDP edge with soft bounds: its weights are stored
    as bfloat16 bit patterns (the record dtype that names the type) and
    restored bit for bit; the resumed fit equals the uninterrupted one."""
    rng = np.random.default_rng(12)
    x = (rng.random((200, 2)) < 0.2) * 40.0
    kw = dict(sampling_steps=50, verbose=False)
    net = _stdp_net(False, w_dtype="bfloat16", w0=0.37, soft=True)
    net.fit_stdp(x[:100], **kw)
    save_network(net, str(tmp_path / "bf"))
    with np.load(str(tmp_path / "bf.npz")) as data:
        assert data["params/edges/pre->post/weights"].dtype == BF16_RECORD
    net2 = _stdp_net(False, w_dtype="bfloat16", w0=0.1, soft=True)
    restore_network(net2, str(tmp_path / "bf"))
    for key, val in net.get_edge("pre", "post").params.items():
        got = net2.get_edge("pre", "post").params[key]
        assert got.dtype == val.dtype and torch.equal(got.view(torch.int16)
                                                      if got.dtype == torch.bfloat16 else got,
                                                      val.view(torch.int16)
                                                      if val.dtype == torch.bfloat16 else val)
    net.fit_stdp(x[100:], **kw)
    net2.fit_stdp(x[100:], **kw)
    w, w2 = (m.get_edge("pre", "post").params["weights"] for m in (net, net2))
    assert w.dtype == torch.bfloat16 and torch.equal(w2.view(torch.int16), w.view(torch.int16))


@pytest.mark.parametrize("weights_dtype", ["float32", "bfloat16"])
def test_fused_node_restore_rebuilds_kernel_copies(tmp_path, weights_dtype):
    """A node with the fused QIF step attached: the restore rebuilds the
    kernel's copies of W (bf16: its bit patterns) and eta from the restored
    parameters, and a run after the restore equals a run of the saved
    network."""
    n = 16
    rng = np.random.default_rng(13)
    W = (rng.random((n, n)) < 0.3) * 0.05

    def build(eta):
        net = Network(1e-3, device="cpu")
        net.add_diffeq_node("qif", QIF_SFA, weights=W, source_var="s", target_var="s_in",
                            input_var="I_ext", output_var="s", spike_var="spike",
                            spike_def="v", op="qif_sfa_op", spike_threshold=30.0,
                            spike_reset=-30.0, node_vars={"all/qif_sfa_op/eta": eta})
        attach_fused_qif_step(net.get_node("qif"), weights_dtype=weights_dtype)
        return net

    drive = rng.normal(size=(100, n)).astype(np.float32) * 30.0
    net = build(100.0 + np.arange(n))
    net.run(drive, verbose=False)
    save_network(net, str(tmp_path / "fused"))
    net2 = build(np.zeros(n))
    restore_network(net2, str(tmp_path / "fused"))
    args, args2 = net.get_node("qif").args, net2.get_node("qif").args
    for key in ("__w_fused__", "__eta_fused__"):
        assert args2[key].dtype == args[key].dtype and torch.equal(args2[key], args[key])
    if weights_dtype == "float32":  # the kernel's copy is W itself again
        assert args2["__w_fused__"] is args2["weights"]
    a = net.run(drive, verbose=False).to_numpy("out")
    b = net2.run(drive, verbose=False).to_numpy("out")
    assert a.max() > 0
    np.testing.assert_array_equal(b, a)
