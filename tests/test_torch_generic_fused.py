"""The port's generic fused step against the JAX package's (CPU).

Each case of ``tests/test_generic_fused.py`` is mirrored: the same network is
built in both packages from the same seeds, the JAX package attaches its
Pallas kernel in interpret mode, the port attaches its own (whose wrapper
runs the plain version on CPU tensors), and the runs agree to the JAX test's
own tolerances (float32; the matvecs sum in other orders).  Then the
rejections, the ``set_param`` refresh, ``load_jax_params`` from a JAX
network with the generic step attached, and the CUDA emitter: every
tile-local template's emitted tail, compiled as host C++ with g++, against
``tile_func``.
"""

import ctypes
import glob
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.dsl.parser import CircuitTemplate as JCircuit
from rectipy_tpu.dsl.parser import NodeTemplate as JNodeTemplate
from rectipy_tpu.ops.generic_fused import attach_generic_fused_step as j_attach
from rectipy_tpu_torch import MultiSpikeResetNet, Network, SpikeNet, load_jax_params
from rectipy_tpu_torch.dsl import lower, parse
from rectipy_tpu_torch.dsl.cuda import emit_tail
from rectipy_tpu_torch.dsl.lower import TileProgram
from rectipy_tpu_torch.dsl.parser import CircuitTemplate, NodeTemplate
from rectipy_tpu_torch.dsl.yaml_lite import load_file
from rectipy_tpu_torch.ops._build import CSRC_DIR
from rectipy_tpu_torch.ops.generic_fused import attach_generic_fused_step

LIF = "neuron_model_templates.spiking_neurons.lif.lif"
QIF_RESET = "neuron_model_templates.spiking_neurons.qif.qif_reset"
IK = "neuron_model_templates.spiking_neurons.ik.ik"
QIF_SFA = "neuron_model_templates.spiking_neurons.qif.qif_sfa"
THETA = "rectipy_tpu.models.spiking_neurons.theta.theta"
TANH = "neuron_model_templates.rate_neurons.leaky_integrator.tanh"
IKU = "neuron_model_templates.spiking_neurons.ik.iku"


def _net(pkg, dt):
    if pkg == "jax":
        return JNetwork(dt, dtype=jnp.float32)
    return Network(dt, device="cpu", dtype=torch.float32)


def _attach(pkg, net, tile):
    node = net.get_node(list(net.nodes)[0])
    if pkg == "jax":
        j_attach(node, tile=tile, interpret=True)
    else:
        attach_generic_fused_step(node)


def _run_both(build, T=300, tile=128, seed=0, atol=2e-4, inp=None):
    """The port's fused run against the JAX package's fused run (interpret
    mode), with the JAX test's tolerance."""
    if inp is None:
        n = build("jax").n_in
        inp = np.random.default_rng(seed).normal(size=(T, n)).astype(np.float32)
    outs = {}
    for pkg in ("jax", "torch"):
        net = build(pkg)
        _attach(pkg, net, tile)
        outs[pkg] = net.run(inp, verbose=False).to_numpy("out")
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=atol, rtol=1e-4)
    return outs["jax"]


def test_generic_fused_lif():
    n = 48
    rng = np.random.default_rng(1)
    W = np.abs(rng.normal(size=(n, n))) * 0.05
    tau = rng.uniform(10.0, 15.0, size=n)

    def build(pkg):
        net = _net(pkg, 1e-2)
        net.add_diffeq_node("lif", LIF, weights=W, source_var="s", target_var="s_in",
                            input_var="I_ext", output_var="s", op="lif_op",
                            spike_var="spike", reset_var="v", dtype=jnp.float32,
                            spike_threshold=10.0, spike_reset=-10.0,
                            node_vars={"eta": 10.0, "tau": tau, "tau_s": 5.0})
        net.compile()
        return net

    ref = _run_both(build, T=400, seed=1)
    assert ref.max() > 0, "no spikes -- weak test"


def test_generic_fused_qif_sfa_matches_specialized():
    n = 64
    rng = np.random.default_rng(2)
    W = (rng.random((n, n)) < 0.2) * 0.02
    etas = rng.normal(size=n) + 100.0

    def build(pkg):
        net = _net(pkg, 1e-3)
        net.add_diffeq_node("qif", QIF_SFA, weights=W, source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            op="qif_sfa_op", spike_var="spike", spike_def="v",
                            dtype=jnp.float32, spike_threshold=30.0, spike_reset=-30.0,
                            node_vars={"all/qif_sfa_op/eta": etas})
        net.compile()
        return net

    ref = _run_both(build, T=500, seed=2)
    assert ref.max() > 0


def test_generic_fused_theta_neuron():
    n = 32
    rng = np.random.default_rng(3)
    W = np.abs(rng.normal(size=(n, n))) * 0.01

    def build(pkg):
        net = _net(pkg, 1e-3)
        net.add_diffeq_node("theta", THETA, weights=W, source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            spike_var="spike", spike_def="theta", dtype=jnp.float32,
                            spike_threshold=np.pi, spike_reset=-np.pi,
                            node_vars={"all/theta_op/eta": 1.0})
        net.compile()
        return net

    ref = _run_both(build, T=2600, seed=3)
    assert ref.max() > 0


def test_generic_fused_spikenet_intrinsic_reset():
    n = 24
    rng = np.random.default_rng(6)
    W = np.abs(rng.normal(size=(n, n))) * 0.01

    def build(pkg):
        net = _net(pkg, 1e-3)
        net.add_diffeq_node("qif", QIF_RESET, weights=W, source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            op="qif_reset_op", spike_var="spike", reset_var="reset",
                            reset=False, dtype=jnp.float32, spike_threshold=10.0,
                            spike_reset=-10.0, node_vars={"eta": 8.0, "k": 0.0})
        net.compile()
        return net

    assert isinstance(build("torch").get_node("qif"), SpikeNet)
    ref = _run_both(build, T=1500, seed=6)
    assert ref.max() > 0, "no spikes -- weak test"


def test_generic_fused_multi_spike_reset():
    n = 16
    rng = np.random.default_rng(7)
    W = np.abs(rng.normal(size=(n, n))) * 0.02

    def build(pkg):
        net = _net(pkg, 1e-2)
        net.add_diffeq_node("ik", IK, weights=W, source_var="s", target_var="s_in",
                            input_var="I_ext", output_var="s", op="ik_op",
                            spike_var=["spike"], reset_var=["v"], dtype=jnp.float32,
                            spike_threshold=40.0, spike_reset=-60.0,
                            node_vars={"eta": 200.0})
        net.compile()
        return net

    assert isinstance(build("torch").get_node("ik"), MultiSpikeResetNet)
    ref = _run_both(build, T=2500, seed=7)
    assert ref.max() > 0, "no spikes -- weak test"


def test_generic_fused_algebraic_output():
    n = 20
    rng = np.random.default_rng(8)
    W = rng.normal(size=(n, n)) * 0.4

    def build(pkg):
        net = _net(pkg, 1e-2)
        net.add_diffeq_node("rnn", TANH, weights=W, input_var="li_op/I_ext",
                            output_var="tanh_op/r", source_var="tanh_op/r",
                            target_var="li_op/r_in", dtype=jnp.float32,
                            node_vars={"all/li_op/eta": 1.0})
        net.compile()
        return net

    _run_both(build, T=300, seed=8, atol=5e-5)


def _tanh_heun(pkg, W, tau, integrator="heun"):
    net = _net(pkg, 1e-2)
    net.add_diffeq_node("rnn", TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", dtype=jnp.float32, integrator=integrator,
                        node_vars={"all/li_op/tau": tau, "all/li_op/eta": 1.0})
    net.compile()
    return net


def test_generic_fused_heun():
    n = 24
    rng = np.random.default_rng(12)
    W = rng.normal(size=(n, n)) * 0.3
    tau = rng.uniform(5.0, 15.0, size=n)
    out_h = _run_both(lambda pkg: _tanh_heun(pkg, W, tau), T=300, seed=12, atol=5e-5)
    # heun and euler must differ (otherwise the case is vacuous)
    inp = np.random.default_rng(12).normal(size=(300, n)).astype(np.float32)
    out_e = _tanh_heun("torch", W, tau, "euler").run(inp, verbose=False).to_numpy("out")
    assert np.abs(out_e - out_h).max() > 1e-4


def test_generic_fused_multi_coupling():
    """Two couplings, the second targeting the input variable itself."""
    n = 24
    rng = np.random.default_rng(9)
    W1 = rng.normal(size=(n, n)) * 0.2
    W2 = rng.normal(size=(n, n)) * 0.1

    def build(pkg):
        nt, ct = (JNodeTemplate, JCircuit) if pkg == "jax" else (NodeTemplate, CircuitTemplate)
        tmpl = nt.from_yaml(TANH)
        circ = ct("c", {f"p{i}": tmpl for i in range(n)})
        circ.add_edges_from_matrix("tanh_op/r", "li_op/r_in", weight=W1)
        circ.add_edges_from_matrix("tanh_op/r", "li_op/I_ext", weight=W2)
        net = _net(pkg, 1e-2)
        net.add_diffeq_node("rnn", circ, input_var="li_op/I_ext", output_var="li_op/v",
                            dtype=jnp.float32)
        net.compile()
        return net

    _run_both(build, T=300, tile=16, seed=9, atol=5e-4)
    assert gfm_step(build("torch")).targets == ("li_op/r_in", "li_op/I_ext")


def gfm_step(net):
    node = net.get_node(list(net.nodes)[0])
    attach_generic_fused_step(node)
    return node._fused_cfg["step"]


def _tanh_net(pkg, n, rng, **kw):
    net = _net(pkg, 1e-2)
    net.add_diffeq_node("rnn", TANH, weights=rng.normal(size=(n, n)) * 0.1,
                        input_var="li_op/I_ext", output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", **{"dtype": jnp.float32, **kw})
    net.compile()
    return net


def test_generic_fused_rejections():
    n = 8
    rng = np.random.default_rng(4)
    for pkg, attach in (("jax", lambda node: j_attach(node, interpret=True)),
                        ("torch", attach_generic_fused_step)):
        # mean-field template: tile_func is global-only
        net = _net(pkg, 1e-2)
        net.add_diffeq_node("ik", IKU, weights=np.zeros((n, n)), source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            op="iku_op", spike_var="spike", reset_var="v", dtype=jnp.float32)
        net.compile()
        with pytest.raises(ValueError, match="reduction"):
            attach(net.get_node("ik"))
        with pytest.raises(ValueError, match="int8"):
            attach(_tanh_net(pkg, n, rng, coupling_dtype="int8").get_node("rnn"))
        net3 = _tanh_net(pkg, n, rng)
        attach(net3.get_node("rnn"))
        with pytest.raises(ValueError, match="already attached"):
            attach(net3.get_node("rnn"))
    # the port's own: float64 state, rk4, an int8_master master, a coupling
    # that is not a dense matrix, weights the kernel does not take
    with pytest.raises(ValueError, match="float32"):
        attach_generic_fused_step(_tanh_net("torch", n, rng, dtype="float64").get_node("rnn"))
    with pytest.raises(ValueError, match="rk4"):
        attach_generic_fused_step(_tanh_net("torch", n, rng, integrator="rk4").get_node("rnn"))
    with pytest.raises(ValueError, match="int8"):
        attach_generic_fused_step(
            _tanh_net("torch", n, rng, coupling_dtype="int8_master").get_node("rnn"))
    node = _tanh_net("torch", n, rng).get_node("rnn")
    node._args["weights"] = node._args["weights"].reshape(1, n, n)
    with pytest.raises(ValueError, match="block-sparse"):
        attach_generic_fused_step(node)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attach_generic_fused_step(_tanh_net("torch", n, rng).get_node("rnn"),
                                  weights_dtype="float16")
    # nothing was attached by a refused call
    assert not getattr(node, "_fused_attached", False)


def test_generic_fused_tanh_algebraic_source():
    n = 40
    rng = np.random.default_rng(5)
    W = rng.normal(size=(n, n)) * 0.3
    tau = rng.uniform(5.0, 15.0, size=n)
    _run_both(lambda pkg: _tanh_heun(pkg, W, tau, "euler"), T=300, seed=5, atol=5e-4)


def _lif(pkg, tau_v, W_v, fused):
    net = _net(pkg, 1e-2)
    net.add_diffeq_node("lif", LIF, weights=W_v, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="lif_op", spike_var="spike",
                        reset_var="v", dtype=jnp.float32, spike_threshold=10.0,
                        spike_reset=-10.0, node_vars={"eta": 10.0, "tau": tau_v, "tau_s": 5.0})
    net.compile()
    if fused:
        _attach(pkg, net, 128)
    return net


def test_generic_fused_set_param_refresh():
    n, T = 48, 100
    rng = np.random.default_rng(9)
    W = np.abs(rng.normal(size=(n, n))) * 0.05
    tau = rng.uniform(10.0, 15.0, size=n)
    tau2 = rng.uniform(10.0, 15.0, size=n)
    W2 = np.abs(rng.normal(size=(n, n))) * 0.05
    inp = rng.normal(size=(T, n)).astype(np.float32)
    # a per-neuron parameter and the coupling set after the attach: the run
    # matches a fresh fused network built with the new values, and the JAX
    # package's refreshed run
    outs = {}
    for pkg in ("jax", "torch"):
        net = _lif(pkg, tau, W, fused=True)
        node = net.get_node("lif")
        node.set_param("tau", tau2)
        node.set_param("weights", W2)
        outs[pkg] = net.run(inp, verbose=False).to_numpy("out")
        with pytest.raises(ValueError, match="baked"):
            node.set_param("tau_s", 2.0)
    ref = _lif("torch", tau2, W2, fused=True).run(inp, verbose=False).to_numpy("out")
    np.testing.assert_allclose(outs["torch"], ref, atol=1e-6)
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=2e-4, rtol=1e-4)
    _lif("torch", tau, W, fused=False).get_node("lif").set_param("tau_s", 2.0)


def test_generic_fused_morris_lecar():
    n = 32
    rng = np.random.default_rng(21)
    W = np.abs(rng.normal(size=(n, n))) * 1.0
    v0 = rng.uniform(-50.0, -30.0, n)

    def build(pkg):
        net = _net(pkg, 0.05)
        net.add_diffeq_node("ml", "rectipy_tpu.models.spiking_neurons.morris_lecar.ml",
                            weights=W, source_var="s", target_var="s_in",
                            input_var="I_ext", output_var="v", dtype=jnp.float32,
                            node_vars={"all/ml_op/v": v0})
        net.compile()
        return net

    rng2 = np.random.default_rng(22)
    inp = (90.0 + rng2.normal(size=(400, n)) * 2.0).astype(np.float32)
    outs = {}
    for pkg in ("jax", "torch"):
        net = build(pkg)
        _attach(pkg, net, 16)
        outs[pkg] = net.run(inp, verbose=False).to_numpy("out")
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=2e-3, rtol=1e-3)
    assert outs["jax"].max() > 0.0  # reached the spike upstroke


def test_generic_fused_qif_gap():
    n = 24
    rng = np.random.default_rng(23)
    Ws = np.abs(rng.normal(size=(n, n))) * 0.05
    G = np.full((n, n), 1.0 / n)
    etas = rng.uniform(-3.0, -1.0, n)

    def build(pkg):
        net = _net(pkg, 1e-3)
        net.add_diffeq_node("qif", "rectipy_tpu.models.spiking_neurons.qif.qif_gap",
                            n=n, edges=[("s", "s_in", Ws), ("v", "v_gap", G)],
                            input_var="I_ext", output_var="v", op="qif_gap_op",
                            spike_var="spike", reset_var="v", dtype=jnp.float32,
                            spike_threshold=100.0, spike_reset=-100.0,
                            node_vars={"all/qif_gap_op/eta": etas,
                                       "all/qif_gap_op/deg": G.sum(axis=1),
                                       "all/qif_gap_op/g_gap": 3.0})
        net.compile()
        return net

    _run_both(build, T=300, tile=8, seed=23, atol=5e-4)


def _to_numpy(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def test_load_jax_params_from_generic_fused_network():
    # a JAX LIF network with the generic step attached (padded state and
    # copies) runs 150 steps; its parameters and state carry into the port,
    # fused or not, and the next 150 steps agree
    n = 48
    rng = np.random.default_rng(31)
    W = np.abs(rng.normal(size=(n, n))) * 0.05
    tau = rng.uniform(10.0, 15.0, size=n)
    inp = rng.normal(size=(300, n)).astype(np.float32)
    jnet = _lif("jax", tau, W, fused=True)
    jnet.run(inp[:150], verbose=False)
    ref = jnet.run(inp[150:], verbose=False).to_numpy("out")
    for fused in (True, False):
        jnet2 = _lif("jax", tau, W, fused=True)
        jnet2.run(inp[:150], verbose=False)
        tnet = _lif("torch", tau * 2.0, W * 0.0, fused=fused)  # overwritten by the load
        params, state = _to_numpy(jnet2.parameters_pytree()), _to_numpy(jnet2.init_state())
        assert any(k.startswith("__row_") for k in params["nodes"]["lif"])
        assert state["nodes"]["lif"].shape[0] > 2 * n  # padded
        load_jax_params(tnet, params, state)
        got = tnet.run(inp[150:], verbose=False).to_numpy("out")
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


# ------------------------------------------------------------ the CUDA emitter
PORT_MODELS = os.path.join(os.path.dirname(CSRC_DIR), "models")
NODE_TEMPLATES = [
    f"rectipy_tpu_torch.models.{os.path.relpath(f, PORT_MODELS)[:-5].replace(os.sep, '.')}.{name}"
    for f in sorted(glob.glob(os.path.join(PORT_MODELS, "**", "*.yaml"), recursive=True))
    for name, spec in load_file(f).items()
    if isinstance(spec, dict) and spec.get("base") == "NodeTemplate"
]


def _emitter_cases():
    """(template, lowered field, per-neuron keys, scalar keys, ext keys) for
    every tile-local node template of the port: the first half of the
    parameters per-neuron, the rest scalars, every input fed externally."""
    cases = []
    for path in NODE_TEMPLATES:
        vf = lower(path, n=64, dtype=torch.float32, device="cpu")
        if not vf.tile_local:
            continue
        params = [k for k in vf.keys if k not in vf.input_vars]
        vec = list(vf.input_vars) + params[: len(params) // 2]
        cases.append((path, vf, vec, params[len(params) // 2:], list(vf.input_vars)))
    return cases


def test_emitter_covers_every_tile_local_template():
    # all but the two templates whose recovery current reads mean(v)
    names = [c[0].rsplit(".", 1)[1] for c in _emitter_cases()]
    assert sorted(set(p.rsplit(".", 1)[1] for p in NODE_TEMPLATES) - set(names)) == [
        "ik_biexp", "iku"]
    assert len(names) == len(NODE_TEMPLATES) - 2


def test_emitted_tails_compiled_with_gxx_match_tile_func(tmp_path):
    gxx = shutil.which("g++") or "/usr/bin/g++"
    if not os.path.exists(gxx):
        pytest.skip("needs g++ to compile the emitted tails as host C++")
    cases = _emitter_cases()
    parts = ['#include "generic_fused_math.cuh"']
    for i, (_, vf, vec, sc, ext) in enumerate(cases):
        parts.append(emit_tail(vf.tile_program, vec, sc, ext, name=f"tail{i}"))
        parts.append(
            f'extern "C" void run{i}(int n, const float* y, const float* p, const double* c, '
            f"const float* e, float* d) {{\n"
            f"  const int V = {len(vf.state_order)}, P = {len(vec)}, E = {len(ext)};\n"
            f"  for (int i = 0; i < n; ++i) tail{i}(y + i * V, P ? p + i * P : p, c, "
            f"E ? e + i * E : e, d + i * V);\n}}\n")
    src = tmp_path / "tails.cpp"
    src.write_text("\n".join(parts))
    lib = tmp_path / "libtails.so"
    proc = subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                           "-D__device__=", "-D__forceinline__=inline", "-I", CSRC_DIR,
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    so = ctypes.CDLL(str(lib))
    rng = np.random.default_rng(0)
    n = 64
    for i, (path, vf, vec, sc, ext) in enumerate(cases):
        # states near their initial values, parameters near their defaults
        y0 = vf.y0.numpy().reshape(len(vf.state_order), n)
        y = (y0 + rng.normal(size=y0.shape) * (0.1 * np.abs(y0) + 0.1)).astype(np.float32)
        p = np.stack([vf.args[k].expand(n).numpy() * rng.uniform(0.9, 1.1, n) for k in vec]
                     ).astype(np.float32) if vec else np.zeros((0, n), np.float32)
        c = np.asarray([float(vf.args[k]) for k in sc], dtype=np.float64)
        e = (rng.normal(size=(len(ext), n))).astype(np.float32)
        states = {q: torch.from_numpy(y[j]) for j, q in enumerate(vf.state_order)}
        a_tile = {k: float(v) for k, v in zip(sc, c)}
        a_tile.update({k: torch.from_numpy(p[j]) for j, k in enumerate(vec)})
        ref = vf.tile_func(states, a_tile, {k: torch.from_numpy(e[j]) for j, k in enumerate(ext)})
        ref = np.stack([ref[q].numpy() for q in vf.state_order])
        got = np.zeros((n, len(vf.state_order)), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        getattr(so, f"run{i}")(
            ctypes.c_int(n), np.ascontiguousarray(y.T).ctypes.data_as(fp),
            np.ascontiguousarray(p.T).ctypes.data_as(fp),
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            np.ascontiguousarray(e.T).ctypes.data_as(fp), got.ctypes.data_as(fp))
        assert np.isfinite(ref).all(), path
        # f32 on both sides; libm's and PyTorch's exp/tanh/... differ by an
        # ulp or so, which the arithmetic after them can grow a little
        np.testing.assert_allclose(got.T, ref, rtol=2e-5, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=path)


def test_emitter_refuses_what_it_cannot_evaluate_per_neuron():
    for fn in ("softmax(v)", "mean(v)", "interp(v, v, v)", "relu(v)"):
        prog = TileProgram(state_order=("op/v",), keys=(), schedule=(), algebraic={},
                           wiring={}, input_defaults={}, odes=(("op/v", parse(fn), "op"),))
        with pytest.raises(ValueError, match=fn.split("(")[0]):
            emit_tail(prog, [], [], [])


def test_emitter_numerics_rules():
    # integer powers are multiplies, others powf; literals meeting a
    # per-neuron value are 9-digit floats; scalar-only arithmetic is double
    prog = TileProgram(
        state_order=("op/v",), keys=("op/a",), schedule=(), algebraic={}, wiring={},
        input_defaults={},
        odes=(("op/v", parse("v^2 + v^2.5 + 0.1*v + a*2.0 + heaviside(v) + round(v) + pi"),
               "op"),))
    src = emit_tail(prog, [], ["op/a"], [])
    assert "gf_pow2(y[0])" in src and "powf(y[0], 2.5f)" in src
    assert "0.100000001f" in src and "(c[0] * 2.0)" in src
    assert "gf_heaviside(y[0])" in src and "rintf(y[0])" in src
    assert "3.141592653589793" in src
