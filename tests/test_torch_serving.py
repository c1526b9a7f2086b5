"""The port's serving bundles (``rectipy_tpu_torch.serving``) against the JAX
package's (``rectipy_tpu.serving``), on the CPU: the cases of
``tests/test_serving.py``, each network exported by both packages and the
served outputs compared, and the port's own rules (registered operators
in the program, eager runs that never enter an operator; the bundles of
the generic, int4 and block kernels are held in
``tests/test_torch_serving_kernels.py``).

Tolerances: the reference test's (rtol 1e-6 at float32, 1e-5 over two
chained calls); served against the port's own ``Network.run`` bit for bit
(the same step, the same arithmetic); the int8_master bundle at float64
within rtol 1e-9, as ``tests/test_torch_quant.py`` holds that path; the
fused QIF bundle (the JAX kernel in interpret mode, the port's operator
with its CPU implementation) within rtol 1e-4, atol 1e-4, as
``tests/test_torch_kernels.py`` holds the attached runs.
"""

import json
import os
import subprocess
import sys
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rectipy_tpu import FeedbackNetwork as JFeedbackNetwork
from rectipy_tpu import Network as JNetwork
from rectipy_tpu.ops.kernels import attach_fused_qif_step as j_attach
from rectipy_tpu.serving import export_network as j_export
from rectipy_tpu.serving import load_network as j_load
from rectipy_tpu_torch import FeedbackNetwork, Network, attach_fused_qif_step
from rectipy_tpu_torch.ops import library
from rectipy_tpu_torch.serving import export_network, load_network

TANH = "neuron_model_templates.rate_neurons.leaky_integrator.tanh"
QIF = "rectipy_tpu.models.spiking_neurons.qif.qif"
QIF_SFA = "rectipy_tpu.models.spiking_neurons.qif.qif_sfa"
LIF = "rectipy_tpu.models.spiking_neurons.lif.lif"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

rng0 = np.random.default_rng(0)
N, T = 8, 40
W0 = rng0.normal(scale=0.3, size=(N, N))
INP = rng0.normal(size=(T, 1)).astype(np.float32)


def _new(jax, dt, cls=None, dtype="float32"):
    if jax:
        return (cls or JNetwork)(dt, dtype=getattr(jnp, dtype))
    return (cls or Network)(dt, device="cpu", dtype=getattr(torch, dtype))


def _rate_net(jax, **kw):
    dtype = kw.pop("dtype", "float32")
    net = _new(jax, 1e-2, dtype=dtype)
    net.add_diffeq_node("p", TANH, weights=W0.copy(), source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext",
                        output_var="tanh_op/r", float_precision=dtype, **kw)
    return net


def _qif_net(jax, fused=False, n=16, eta=100.0):
    net = _new(jax, 1e-3)
    W = (np.random.default_rng(3).random((n, n)) < 0.3) * 0.05
    net.add_diffeq_node("qif", QIF_SFA, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", spike_var="spike", spike_def="v",
                        op="qif_sfa_op", spike_threshold=30.0, spike_reset=-30.0,
                        float_precision="float32",
                        node_vars={"all/qif_sfa_op/eta": eta + np.arange(n, dtype=float)})
    net.add_func_node("inp", 1, activation_function="tanh")
    net.add_edge("inp", "qif", weights=np.ones((n, 1)))
    net.compile()
    if fused:
        (j_attach(net.get_node("qif"), tile=128, interpret=True) if jax
         else attach_fused_qif_step(net.get_node("qif")))
    return net


def _out(obs):
    return np.asarray(obs.to_numpy("out"))


def test_export_load_matches_run(tmp_path):
    model = load_network(export_network(_rate_net(False), str(tmp_path / "b"), T=T, n_in=1))
    jmodel = j_load(j_export(_rate_net(True), str(tmp_path / "j"), T=T, n_in=1))
    got = model(INP)
    np.testing.assert_array_equal(got, _out(_rate_net(False).run(INP, verbose=False)))
    np.testing.assert_allclose(got, jmodel(INP), rtol=1e-6, atol=1e-7)
    assert model.n_in == 1 and model.n_out == N and model.T == T
    assert model.meta["ops"] == [] and model.meta["programs"]["prep"] is None


def test_served_state_carries_and_resets(tmp_path):
    """Two chained calls == one 2T-step run (and JAX's chained calls);
    reset() restores the exported snapshot."""
    model = load_network(export_network(_rate_net(False), str(tmp_path / "b"), T=T, n_in=1))
    jmodel = j_load(j_export(_rate_net(True), str(tmp_path / "j"), T=T, n_in=1))
    inp2 = np.random.default_rng(1).normal(size=(2 * T, 1)).astype(np.float32)
    a, b = model(inp2[:T]), model(inp2[T:])
    full = _out(_rate_net(False).run(inp2, verbose=False))
    np.testing.assert_array_equal(np.concatenate([a, b]), full)
    np.testing.assert_allclose(np.concatenate([a, b]),
                               np.concatenate([jmodel(inp2[:T]), jmodel(inp2[T:])]),
                               rtol=1e-5, atol=1e-6)
    model.reset()
    np.testing.assert_array_equal(model(inp2[:T]), a)


def test_serving_spiking_with_sampling(tmp_path):
    """QIF spiking network with window-mean downsampling: R = T//s
    contiguous window means, equal to the run's outputs averaged and to
    JAX's bundle."""
    def _qif(jax):
        q = _new(jax, 1e-2)
        q.add_diffeq_node("qif", QIF, weights=np.abs(W0) * 2.0, source_var="s",
                          target_var="s_in", input_var="I_ext", output_var="s",
                          spike_var="spike", spike_def="v", op="qif_op",
                          spike_threshold=1e2, spike_reset=-1e2,
                          float_precision="float32", node_vars={"all/qif_op/eta": 1.0})
        return q

    s = 5
    drive = np.full((T, 1), 100.0, dtype=np.float32)
    got = load_network(export_network(_qif(False), str(tmp_path / "q"), T=T, n_in=1,
                                      sampling_steps=s))(drive)
    assert got.shape == (T // s, N) and np.isfinite(got).all() and got.max() > 0
    outs = torch.as_tensor(_out(_qif(False).run(drive, verbose=False)))
    want = outs.reshape(T // s, s, N).mean(dim=1).numpy()
    np.testing.assert_array_equal(got, want)
    jgot = j_load(j_export(_qif(True), str(tmp_path / "j"), T=T, n_in=1,
                           sampling_steps=s))(drive)
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-6)


def test_fused_qif_bundle_names_the_operator(tmp_path):
    """The fused QIF node: the exported step calls rectipy::qif_sfa_step
    (the CPU implementation here), the kernel's copy of W rides in the
    snapshot as the same leaf as W, and the served records equal the
    attached run's and the JAX bundle's (its Pallas kernel in interpret
    mode) under the attached runs' tolerance."""
    T2 = 200
    drive = np.random.default_rng(2).normal(size=(T2, 1)).astype(np.float32) * 40.0
    path = export_network(_qif_net(False, fused=True), str(tmp_path / "f"), T=T2, n_in=1)
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["ops"] == ["rectipy::qif_sfa_step"]
    assert meta["aliases"], "the fused copy of the f32 W is the W leaf itself"
    ep = torch.export.load(os.path.join(path, "step.pt2"))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert "rectipy.qif_sfa_step.default" in targets
    got = load_network(path)(drive)
    ref = _out(_qif_net(False, fused=True).run(drive, verbose=False))
    np.testing.assert_array_equal(got, ref)
    assert got.max() > 0, "no spikes -- weak test"
    jgot = j_load(j_export(_qif_net(True, fused=True), str(tmp_path / "jf"), T=T2,
                           n_in=1))(drive)
    np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-4)


def test_serving_int8_master_prep_inside_program(tmp_path):
    """int8_master: the quantization prep is its own exported program (once
    per call), the snapshot carries the float master, and the step calls
    rectipy::int8_mv; served == run bit for bit; JAX's bundle within rtol
    1e-9 at float64."""
    kw = dict(coupling_dtype="int8_master", dtype="float64")
    path = export_network(_rate_net(False, **kw), str(tmp_path / "i8"), T=T, n_in=1)
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["ops"] == ["rectipy::int8_mv"] and meta["programs"]["prep"] == "prep.pt2"
    assert any(src == "prep" for src, _ in meta["prep"])
    got = load_network(path)(INP)
    np.testing.assert_array_equal(got, _out(_rate_net(False, **kw).run(INP, verbose=False)))
    jgot = j_load(j_export(_rate_net(True, **kw), str(tmp_path / "j"), T=T, n_in=1))(INP)
    np.testing.assert_allclose(got, jgot, rtol=1e-9, atol=1e-12)


def test_serving_feedback_delay_edges(tmp_path):
    """FeedbackNetwork with a delayed feedback edge: the delay ring buffer
    and the previous-step feedback outputs ride in the carried state."""
    def _net(jax):
        q = _new(jax, 1e-2, JFeedbackNetwork if jax else FeedbackNetwork)
        q.add_func_node("inp", 1, activation_function="identity")
        q.add_diffeq_node("p", TANH, weights=W0.copy(), source_var="tanh_op/r",
                          target_var="li_op/r_in", input_var="li_op/I_ext",
                          output_var="tanh_op/r", float_precision="float32")
        q.add_edge("inp", "p", weights=np.ones((N, 1), dtype=np.float32))
        q.add_edge("p", "p", weights=np.full(N, 0.2, dtype=np.float32),
                   delays=np.arange(1, N + 1), feedback=True)
        return q

    model = load_network(export_network(_net(False), str(tmp_path / "fb"), T=T))
    got = np.concatenate([model(INP), model(INP)])
    want = _out(_net(False).run(np.concatenate([INP, INP]), verbose=False))
    np.testing.assert_array_equal(got, want)
    jgot = j_load(j_export(_net(True), str(tmp_path / "j"), T=T))(INP)
    np.testing.assert_allclose(got[:T], jgot, rtol=1e-6, atol=1e-7)


def test_bundle_is_model_definition_free(tmp_path):
    """The bundle holds the programs, the npz snapshot and JSON metadata: no
    pickle (not even the programs' sample inputs), no Python, no YAML."""
    path = export_network(_rate_net(False), str(tmp_path / "clean"), T=T, n_in=1)
    assert sorted(os.listdir(path)) == ["meta.json", "snapshot.npz", "step.pt2"]
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["T"] == T and meta["n_leaves"] >= 1
    assert meta["device"] == "cpu" and meta["platforms"] == ["cpu"]
    with zipfile.ZipFile(os.path.join(path, "step.pt2")) as z:
        for info in z.infolist():
            if info.filename.endswith((".pkl", ".pt", ".py", ".yaml")):
                assert info.file_size == 0, info.filename
    np.load(os.path.join(path, "snapshot.npz"), allow_pickle=False)["leaf_00000"]


def test_serving_batched_ensemble(tmp_path):
    """batch=B exports the ensemble step (run_batch semantics: shared params,
    per-trial state): each trial equals the single-trial bundle fed its
    input, JAX's batched bundle, and per-trial state carries."""
    B = 3
    single = load_network(export_network(_rate_net(False), str(tmp_path / "s1"), T=T, n_in=1))
    batched = load_network(export_network(_rate_net(False), str(tmp_path / "sB"), T=T,
                                          n_in=1, batch=B))
    jbatched = j_load(j_export(_rate_net(True), str(tmp_path / "jB"), T=T, n_in=1, batch=B))
    ins = np.random.default_rng(5).normal(size=(B, T, 1)).astype(np.float32)
    got = batched(ins)
    assert got.shape == (B, T, N)
    np.testing.assert_allclose(got, jbatched(ins), rtol=1e-6, atol=1e-7)
    for b in range(B):
        single.reset()
        np.testing.assert_allclose(got[b], single(ins[b]), rtol=1e-6, atol=1e-7)
    got2 = batched(ins)
    np.testing.assert_allclose(got2, jbatched(ins), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="exported shape"):
        batched(ins[0])


@pytest.mark.parametrize("case", ["fused", "int8"])
def test_batched_bundles_name_the_batched_operators(tmp_path, case):
    """A batched fused QIF bundle calls rectipy::qif_sfa_rows_step and a
    batched frozen-int8 one rectipy::int8_mm; each trial's records equal
    run_batch's bit for bit."""
    B, T2 = 4, 60
    if case == "fused":
        build, op = (lambda: _qif_net(False, fused=True)), "rectipy::qif_sfa_rows_step"
    else:
        build, op = (lambda: _rate_net(False, coupling_dtype="int8")), "rectipy::int8_mm"
    ins = np.random.default_rng(6).normal(size=(B, T2, 1)).astype(np.float32) * 30.0
    model = load_network(export_network(build(), str(tmp_path / case), T=T2, n_in=1,
                                        batch=B))
    assert model.meta["ops"] == [op]
    np.testing.assert_array_equal(model(ins), build().run_batch(ins, verbose=False)["out"])


def test_serving_vendored_module_no_package(tmp_path):
    """serving.py loaded STANDALONE (by file path; the package never
    imports) serves a bundle without operators with torch and numpy
    alone."""
    path = export_network(_rate_net(False), str(tmp_path / "v"), T=T, n_in=1)
    np.save(str(tmp_path / "oracle.npy"), _out(_rate_net(False).run(INP, verbose=False)))
    np.save(str(tmp_path / "inp.npy"), INP)
    serving_py = os.path.join(ROOT, "rectipy_tpu_torch", "serving.py")
    code = f"""
import importlib.util, sys
import numpy as np
spec = importlib.util.spec_from_file_location("serving_v", {serving_py!r})
m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)
model = m.load_network({path!r})
got = model(np.load({str(tmp_path / "inp.npy")!r}))
np.testing.assert_array_equal(got, np.load({str(tmp_path / "oracle.npy")!r}))
bad = [k for k in sys.modules if k.split(".")[0] in ("rectipy_tpu", "rectipy_tpu_torch", "jax")]
assert not bad, bad
print("VENDORED-OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr
    assert "VENDORED-OK" in out.stdout


def test_serving_validation(tmp_path):
    net = _rate_net(False)
    with pytest.raises(ValueError, match="T=0"):
        export_network(net, str(tmp_path / "x"), T=0)
    with pytest.raises(ValueError, match="n_in"):
        export_network(net, str(tmp_path / "x"), T=T, n_in=3)
    with pytest.raises(ValueError, match="platforms"):
        export_network(net, str(tmp_path / "x"), T=T, platforms=["tpu"])
    model = load_network(export_network(net, str(tmp_path / "y"), T=T, n_in=1))
    with pytest.raises(ValueError, match="exported shape"):
        model(np.zeros((T + 1, 1), dtype=np.float32))
    with pytest.raises(ValueError, match="may be served on"):
        load_network(str(tmp_path / "y"), device="cuda")
    meta_path = tmp_path / "y" / "meta.json"
    meta = json.load(open(meta_path))
    meta["platforms"], meta["device"] = ["cuda"], "cuda"
    json.dump(meta, open(meta_path, "w"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_network(str(tmp_path / "y"))
    meta["format_version"] = 999
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(ValueError, match="format"):
        load_network(str(tmp_path / "y"))


def _lif_generic():
    from rectipy_tpu_torch import attach_generic_fused_step

    net = Network(1e-3, device="cpu")
    net.add_diffeq_node("lif", LIF, weights=np.full((8, 8), 0.5), source_var="s",
                        target_var="s_in", input_var="I_ext", output_var="s", op="lif_op",
                        spike_var="spike", reset_var="v", spike_threshold=1.0,
                        spike_reset=0.0)
    net.compile()
    attach_generic_fused_step(net.get_node("lif"))
    return net


def _block_int8():
    from rectipy_tpu_torch import block_random_connectivity

    net = Network(1e-3, device="cpu")
    A = block_random_connectivity(64, 64, 32, block_size=16, seed=0)
    net.add_diffeq_node("qif", QIF_SFA, weights=A, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", spike_var="spike", spike_def="v",
                        op="qif_sfa_op", spike_threshold=30.0, spike_reset=-30.0,
                        coupling_dtype="int8")
    return net


class _OpLog(TorchDispatchMode):
    """The operators that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(str(func))
        return func(*args, **(kwargs or {}))


# each case's network, and the operators its single-trial and its batch=2
# program call: together every operator of ops/library.py
OP_CASES = {
    "fused": (lambda: _qif_net(False, fused=True), "qif_sfa_step", "qif_sfa_rows_step"),
    "int8": (lambda: _rate_net(False, coupling_dtype="int8"), "int8_mv", "int8_mm"),
    "int4": (lambda: _rate_net(False, coupling_dtype="int4"), "int4_mv", "int4_mm"),
    "generic": (_lif_generic, "generic_fused_step", "generic_fused_rows"),
    "block_int8": (_block_int8, "block_int8_mv", "block_int8_mv"),
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_eager_runs_never_enter_an_operator_and_the_program_does(tmp_path, case):
    """Eager run and run_batch call the wrappers (no rectipy:: operator
    reaches the dispatcher); the exported single-trial and batch=2 programs
    call the operators, and their outputs equal run's and run_batch's."""
    build, single_op, rows_op = OP_CASES[case]
    drive = np.random.default_rng(7).normal(size=(20, 1)).astype(np.float32) * 30.0
    drives = np.stack([drive, drive * 0.5])
    net = build()
    with _OpLog() as log:
        net.run(drive, verbose=False)
        net.run_batch(drives, verbose=False)
    assert not any(op.startswith("rectipy.") for op in log.ops), sorted(log.ops)
    model = load_network(export_network(build(), str(tmp_path / case), T=20, n_in=1))
    batched = load_network(export_network(build(), str(tmp_path / f"{case}_B"), T=20, n_in=1,
                                          batch=2))
    for served, ins, op, want in ((model, drive, single_op,
                                   lambda: _out(build().run(drive, verbose=False))),
                                  (batched, drives, rows_op,
                                   lambda: build().run_batch(drives, verbose=False)["out"])):
        with _OpLog() as log:
            got = served(ins)
        assert {op for op in log.ops if op.startswith("rectipy.")} == {f"rectipy.{op}.default"}
        np.testing.assert_array_equal(got, want())
    assert set(library.OPS) == {op for _, single, rows in OP_CASES.values()
                                for op in (single, rows)}
