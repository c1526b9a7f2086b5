"""The mesh cases of ``tests/test_torch_parallel*.py``, shared by the gloo
ranks (``tests/_torch_parallel_worker.py``, which import the port and never
JAX) and the test files (which run the JAX package through the same functions).

A case is ``fn(P, mesh) -> {name: array}``: ``P`` is the package's namespace
(:func:`torch_ns` or the tests' JAX one), ``mesh`` a mesh of that package or
None.  Every input comes from a numpy seed.  ``spawn`` runs a group of cases
on gloo ranks and returns where their records are.
"""

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

TANH = "neuron_model_templates.rate_neurons.leaky_integrator.tanh"
QIF = "neuron_model_templates.spiking_neurons.qif.qif"
QIF_SFA = "rectipy_tpu.models.spiking_neurons.qif.qif_sfa"
IKU = "neuron_model_templates.spiking_neurons.ik.iku"
LIF = "neuron_model_templates.spiking_neurons.lif.lif"

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_parallel_worker.py")


def torch_ns():
    """The port's namespace for the cases (CPU tensors)."""
    import torch

    import rectipy_tpu_torch as pkg
    from rectipy_tpu_torch import inputs

    def net(dt, dtype="float64", feedback=False):
        cls = pkg.FeedbackNetwork if feedback else pkg.Network
        return cls(dt, dtype=getattr(torch, dtype), device="cpu")

    return SimpleNamespace(net=net, inputs=inputs, torch=True,
                           block_random_connectivity=pkg.block_random_connectivity,
                           BlockSparseCoupling=pkg.BlockSparseCoupling,
                           attach_qif=pkg.attach_fused_qif_step,
                           attach_generic=pkg.attach_generic_fused_step)


def _rnn(P, W, dtype="float64", dt=1e-2, **kw):
    net = P.net(dt, dtype)
    net.add_diffeq_node("rnn", TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", **kw)
    net.compile()
    return net


# --------------------------------------------------------- test_parallel.py
def rnn_case(n=32, seed=0, T=20, tau=True):
    """``test_sharded_run_matches_single_device``'s network and drive."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(n, n)) * 0.2
    t = rng.uniform(5.0, 15.0, size=(n,)) if tau else None
    return W, t, rng.normal(size=(T, n))


def build_rnn(P, W, tau=None, dtype="float64", **kw):
    node_vars = {"all/li_op/tau": tau} if tau is not None else None
    return _rnn(P, W, dtype, node_vars=node_vars, **kw)


def build_delay(P, n=32, seed=2):
    """``test_sharded_run_with_delay_edge``: per-source delays onto a
    population; the drive ``(15, n)``."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(n, n)) * 0.2
    delays = rng.integers(0, 5, size=n)
    net = P.net(1e-2)
    net.add_func_node("inp", n, activation_function="identity")
    net.add_diffeq_node("rnn", TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in")
    net.add_edge("inp", "rnn", weights=np.eye(n), delays=delays)
    net.compile()
    return net, rng.normal(size=(15, n))


def build_mixed(P, seed=3):
    """A trainable population of 3 (no model axis of 2 divides it: it runs
    whole) feeding a trainable population of 16 (sharded), whose scalar
    ``tau`` trains too: the train step's gradients of a whole source into a
    shard and of a leaf a shard holds whole."""
    rng = np.random.default_rng(seed)
    net = P.net(1e-2)
    for label, n in (("a", 3), ("b", 16)):
        net.add_diffeq_node(label, TANH, weights=rng.normal(size=(n, n)) * 0.3,
                            input_var="li_op/I_ext", output_var="li_op/v",
                            source_var="tanh_op/r", target_var="li_op/r_in",
                            train_params=["weights", "tau"] if label == "b" else ["weights"])
    net.add_edge("a", "b", weights=rng.normal(size=(16, 3)))
    net.compile()
    return net, rng.normal(size=(4, 6, 3)), rng.normal(size=(4, 6, 16)) * 0.1


def int8_case(P, n=32):
    rng = np.random.default_rng(4)
    W = rng.normal(size=(n, n)) * 0.2
    return _rnn(P, W, "float32", coupling_dtype="int8"), rng.normal(size=(20, n))


def observer_run(P, mesh):
    """``test_public_run_mesh_matches_single_device_including_observer``, in
    two chunks (the second continues from the state the first wrote back)."""
    n = 32
    rng = np.random.default_rng(7)
    W = rng.normal(size=(n, n)) * 0.2
    inp = rng.normal(size=(40, n))
    net = _rnn(P, W)
    out = {}
    for i, chunk in enumerate((inp[:22], inp[22:])):
        obs = net.run(chunk, sampling_steps=3, cutoff=6 if i == 0 else 0, verbose=False,
                      record_vars=[("rnn", "v", True)], mesh=mesh)
        out[f"steps{i}"] = np.asarray(obs["steps"])
        out[f"out{i}"] = obs.to_numpy("out")
        out[f"v{i}"] = obs.to_numpy(("rnn", "v"))
    return out


def block_sparse_run(P, mesh):
    """``test_public_run_mesh_sparse_coupling``."""
    n, bs = 256, 32
    A = P.block_random_connectivity(n, n, 12, block_size=bs, seed=9)
    net = P.net(1e-3, "float32")
    net.add_diffeq_node("qif", QIF_SFA, weights=A, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="qif_sfa_op",
                        spike_var="spike", spike_def="v",
                        spike_threshold=1e2, spike_reset=-1e2)
    net.compile()
    return {"out": net.run(np.full((30, n), 2.0), verbose=False, mesh=mesh).to_numpy("out")}


def budget_net(P, kind, n=64):
    """``test_sharded_scan_collective_budget``'s dense or block coupling."""
    rng = np.random.default_rng(11)
    dense = rng.normal(size=(n, n)) * 0.1
    W = dense if kind == "dense" else P.block_random_connectivity(n, n, 8, block_size=8,
                                                                  seed=1)
    return _rnn(P, W, "float32")


def run_batch_qif(P, mesh):
    """``test_public_run_batch_mesh_matches_single_device``."""
    n, B, T = 16, 4, 30
    rng = np.random.default_rng(41)
    W = np.abs(rng.normal(size=(n, n))) * 0.4
    net = P.net(1e-2, "float32")
    net.add_diffeq_node("qif", QIF, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="qif_op",
                        spike_var="spike", spike_def="v",
                        spike_threshold=100.0, spike_reset=-100.0,
                        node_vars={"all/qif_op/eta": 4.0 + rng.random(n)})
    inputs = rng.normal(size=(B, T, n)).astype(np.float32)
    res = net.run_batch(inputs, sampling_steps=3, mesh=mesh)
    return {"steps": np.asarray(res["steps"]), "out": np.asarray(res["out"])}


def int8_master_run(P, mesh):
    """``test_public_run_mesh_int8_master_matches_single_device``."""
    n = 16
    rng = np.random.default_rng(42)
    W = rng.normal(size=(n, n)) * 0.3
    net = _rnn(P, W, "float32", coupling_dtype="int8_master")
    inp = rng.normal(size=(40, n)).astype(np.float32)
    return {"out": net.run(inp, verbose=False, mesh=mesh).to_numpy("out")}


def delay_matrix_run(P, mesh):
    """``test_public_run_mesh_delay_matrix_edge_matches_single_device``: a
    per-connection delay matrix on a feedback edge."""
    n = 32
    rng = np.random.default_rng(17)
    W = rng.normal(size=(n, n)) * 0.2
    D = rng.integers(0, 6, size=(n, n))
    inp = rng.normal(size=(40, n))
    net = P.net(1e-2, feedback=True)
    net.add_diffeq_node("rnn", TANH, weights=np.zeros((n, n)), input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in")
    net.add_edge("rnn", "rnn", weights=W, delays=D, feedback=True)
    net.compile()
    return {"out": net.run(inp, sampling_steps=2, verbose=False, mesh=mesh).to_numpy("out")}


# ------------------------------------------------------- the other modules
def spec_run(P, mesh):
    """``tests/test_inputs.py``'s ``test_run_mesh_matches_single_device``."""
    N, T = 24, 200
    W = np.random.default_rng(0).normal(size=(N, N)) / N
    net = _rnn(P, W, dt=1e-3)
    spec = (P.inputs.Pulse(T, channels=N, t_on=20, t_off=150, amp=1.5)
            + P.inputs.Sine(T, channels=N, freq=3.0, amp=0.5, phase=0.3)
            + P.inputs.Noise(T, channels=N, scale=0.3, seed=4))
    return {"out": net.run(spec, sampling_steps=7, verbose=False, mesh=mesh).to_numpy("out")}


def spec_run_batch(P, mesh):
    """``tests/test_inputs.py``'s ``test_run_batch_mesh_data_sharded``."""
    N, T, B = 24, 200, 4
    W = np.random.default_rng(0).normal(size=(N, N)) / N
    net = _rnn(P, W, dt=1e-3)
    spec = P.inputs.Noise(T, channels=N, scale=0.5, seed=np.arange(B))
    return {"out": np.asarray(net.run_batch(spec, sampling_steps=5, mesh=mesh)["out"])}


def spikes_run(P, mesh):
    """``tests/test_record_spikes.py``'s ``test_record_spikes_mesh_matches_
    single_device`` (a SpikeResetNet, float64)."""
    N, T = 16, 300
    rng = np.random.default_rng(0)
    W = rng.normal(size=(N, N)) * 0.1 / N
    etas = 3.0 + np.random.default_rng(1).normal(size=N)
    net = P.net(1e-2)
    net.add_diffeq_node("qif", QIF_SFA, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", spike_var="spike", spike_def="v",
                        op="qif_sfa_op", spike_threshold=10.0, spike_reset=-10.0,
                        node_vars={"all/qif_sfa_op/eta": etas})
    obs = net.run(np.full((T, N), 15.0), sampling_steps=5, verbose=False,
                  record_spikes=["qif"], mesh=mesh)
    return {"spikes": obs.to_numpy(("qif", "spikes")), "out": obs.to_numpy("out")}


def sweep_run(P, mesh):
    """``tests/test_run_batch_sweep.py``'s ``test_run_batch_sweep_under_mesh_
    matches_unsharded``: a swept eta, then a shared 2-D drive."""
    n, B, T = 16, 4, 20
    rng = np.random.default_rng(12)
    W = rng.standard_normal((n, n)) * 0.1
    net = P.net(1e-2, "float32")
    net.add_diffeq_node("pop", TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in")
    inp = rng.normal(size=(B, T, n)).astype(np.float32)
    etas = np.linspace(-0.5, 0.5, B).astype(np.float32)
    sweep = {("pop", "li_op/eta"): etas}
    out = net.run_batch(inp, sampling_steps=1, mesh=mesh, batch_vars=sweep)["out"]
    shared = net.run_batch(inp[0], sampling_steps=1, mesh=mesh, batch_vars=sweep)["out"]
    return {"out": np.asarray(out), "shared": np.asarray(shared)}


def fused_qif_run(P, mesh, jax_interpret=None):
    """A node with the fused QIF step on a model axis of two: it runs whole
    on every rank (the JAX package's kernel in interpret mode, the port's
    plain version on CPU tensors); float32, N=64, 120 steps, spiking."""
    n = 64
    rng = np.random.default_rng(5)
    W = rng.normal(size=(n, n)) * 0.1 / n
    net = P.net(1e-2, "float32")
    net.add_diffeq_node("qif", QIF_SFA, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="qif_sfa_op",
                        spike_var="spike", spike_def="v", spike_threshold=10.0,
                        spike_reset=-10.0, dtype="float32",
                        node_vars={"all/qif_sfa_op/eta": 3.0 + rng.normal(size=n)})
    net.compile()
    node = net.get_node("qif")
    if jax_interpret is None:
        P.attach_qif(node)
    else:
        P.attach_qif(node, interpret=True)
    inp = (15.0 + rng.normal(size=(120, n))).astype(np.float32)
    obs = net.run(inp, sampling_steps=4, verbose=False, mesh=mesh,
                  record_vars=[("qif", "v", False)])
    out = {"out": obs.to_numpy("out"), "v": obs.to_numpy(("qif", "v"))}
    res = net.run_batch(np.stack([inp, inp * 0.5]), sampling_steps=4, mesh=mesh)
    out["batch"] = np.asarray(res["out"])
    return out


def reduction_run(P, mesh):
    """A template with population reductions (``iku``: the recovery sees
    ``mean(v)`` and ``mean(spike)``) on a model axis of two, float64."""
    n = 16
    rng = np.random.default_rng(41)
    net = P.net(1e-2)
    net.add_diffeq_node("ik", IKU, weights=np.abs(rng.normal(size=(n, n))) * 0.02,
                        source_var="s", target_var="s_in", input_var="I_ext",
                        output_var="s", op="iku_op", spike_var="spike", reset_var="v",
                        spike_threshold=40.0, spike_reset=-60.0,
                        node_vars={"eta": rng.uniform(150.0, 250.0, n),
                                   "v": rng.uniform(-60.0, 35.0, n)})
    net.compile()
    obs = net.run(np.full((200, n), 20.0), sampling_steps=4, verbose=False, mesh=mesh,
                  record_vars=[("ik", "u", False), ("ik", "v", True)], record_spikes=["ik"])
    return {"out": obs.to_numpy("out"), "u": obs.to_numpy(("ik", "u")),
            "v": obs.to_numpy(("ik", "v")), "spikes": obs.to_numpy(("ik", "spikes"))}


def generic_fused_run(P, mesh, jax_interpret=None):
    """A node with the generic fused step (LIF, float32) on a model axis of
    two, beside a population the axis shards (an edge between them)."""
    n = 48
    rng = np.random.default_rng(1)
    W = np.abs(rng.normal(size=(n, n))) * 0.05
    tau = rng.uniform(10.0, 15.0, size=n)
    net = P.net(1e-2, "float32")
    net.add_diffeq_node("lif", LIF, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="lif_op",
                        spike_var="spike", reset_var="v", spike_threshold=10.0,
                        spike_reset=-10.0, dtype="float32",
                        node_vars={"eta": 10.0, "tau": tau, "tau_s": 5.0})
    net.add_diffeq_node("rnn", TANH, weights=rng.normal(size=(n, n)) * 0.1,
                        input_var="li_op/I_ext", output_var="li_op/v",
                        source_var="tanh_op/r", target_var="li_op/r_in", dtype="float32")
    net.add_edge("lif", "rnn", weights=rng.normal(size=(n, n)) * 0.2)
    net.compile()
    node = net.get_node("lif")
    if jax_interpret is None:
        P.attach_generic(node)
    else:
        P.attach_generic(node, tile=128, interpret=True)
    inp = rng.normal(size=(200, n)).astype(np.float32)
    return {"out": net.run(inp, verbose=False, mesh=mesh).to_numpy("out")}


def readout_run(P, mesh):
    """A sharded population read out by a node the model axis does not
    divide (``n = 3``: it runs whole, from the gathered source), over
    ``B = 3`` trials, which the data axis does not divide either (they run
    replicated, with the JAX package's warning); float64."""
    n, B, T = 16, 3, 25
    rng = np.random.default_rng(31)
    net = P.net(1e-2)
    net.add_diffeq_node("rnn", TANH, weights=rng.normal(size=(n, n)) * 0.3,
                        input_var="li_op/I_ext", output_var="li_op/v",
                        source_var="tanh_op/r", target_var="li_op/r_in")
    net.add_func_node("out", 3, activation_function="identity")
    net.add_edge("rnn", "out", weights=rng.normal(size=(3, n)))
    net.compile()
    res = net.run_batch(rng.normal(size=(B, T, n)), sampling_steps=5, mesh=mesh,
                        record_vars=[("rnn", "v", True)])
    return {"out": np.asarray(res["out"]), "v": np.asarray(res[("rnn", "v")])}


def spawn(group: str, world: int, tmp_path, timeout: float = 240.0) -> str:
    """Run the cases of ``group`` on ``world`` gloo ranks (one process each,
    rendezvous through a FileStore under ``tmp_path``); returns the folder of
    their ``<case>.r<rank>.npz`` records.  A rank that fails, or a group that
    outlasts ``timeout`` seconds, fails the caller."""
    return start(group, world, tmp_path, timeout)()


def start(group: str, world: int, tmp_path, timeout: float = 240.0):
    """:func:`spawn` without the wait: the ranks start, and the returned
    ``finish()`` waits for them and returns the folder of their records (the
    caller works meanwhile, as the JAX side of the tests does)."""
    out = os.path.join(str(tmp_path), f"records_{group}")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(str(tmp_path), f"store_{group}")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(WORKER))] + env.get("PYTHONPATH", "").split(os.pathsep))
    # each rank's stderr goes to a file: a pipe nobody reads while the caller
    # works could fill and stall the rank
    logs = [os.path.join(out, f"rank{r}.err") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, group, str(r), str(world), store, out],
                stdout=subprocess.DEVNULL, stderr=err, env=env))
    start_t = time.monotonic()
    return lambda: _finish(procs, logs, out, start_t + timeout)


def _finish(procs, logs, out: str, deadline: float) -> str:
    errors = []
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            p.wait()
            errors.append(f"rank {r} timed out:\n{_tail(logs[r])}")
            continue
        if p.returncode != 0:
            errors.append(f"rank {r} rc={p.returncode}:\n{_tail(logs[r])}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def _tail(path: str) -> str:
    with open(path) as f:
        return f.read()[-3000:]


def load(out: str, case: str, rank: int) -> dict:
    with np.load(os.path.join(out, f"{case}.r{rank}.npz")) as f:
        return dict(f)
