"""Serving bundles of networks whose step reaches the generic fused step,
the int4 products or the int8 block product (``rectipy_tpu_torch.serving``
with the operators of ``ops/library.py``), on the CPU: each bundle against
the port's own ``Network.run`` / ``run_batch`` and against the JAX
package's bundle of the same network (``rectipy_tpu.serving``; its generic
Pallas kernel in interpret mode); a generic bundle served by a fresh
process that builds no network and reads no template; bundles of format 1;
and the refusals (an unknown key, a source that is not its key's).

Tolerances: served against the port's run bit for bit (the same step, the
same arithmetic; a fresh process's exported plain step included); against
JAX's bundle the serving tests' rtol 1e-6, atol 1e-7 at float32
(``tests/test_torch_serving.py``; the spiking LIF records too, at these
sizes); the block int8 bundles at float64 within rtol 1e-9, atol 1e-12, as
``tests/test_torch_serving.py`` holds the int8_master bundle.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import FeedbackNetwork as JFeedbackNetwork
from rectipy_tpu import Network as JNetwork
from rectipy_tpu.dsl.parser import CircuitTemplate as JCircuit
from rectipy_tpu.dsl.parser import NodeTemplate as JNodeTemplate
from rectipy_tpu.ops.generic_fused import attach_generic_fused_step as j_attach
from rectipy_tpu.ops.sparse import BlockSparseCoupling as JBlocks
from rectipy_tpu.ops.sparse import block_random_connectivity as jbrc
from rectipy_tpu.serving import export_network as j_export
from rectipy_tpu.serving import load_network as j_load
from rectipy_tpu_torch import (BlockSparseCoupling, FeedbackNetwork, Network,
                               attach_generic_fused_step, block_random_connectivity)
from rectipy_tpu_torch.dsl.parser import CircuitTemplate, NodeTemplate
from rectipy_tpu_torch.ops import library
from rectipy_tpu_torch.serving import export_network, load_network

PREFIX = {"jax": "rectipy_tpu.models.", "torch": "rectipy_tpu_torch.models."}
LIF = "spiking_neurons.lif.lif"
QIF_SFA = "spiking_neurons.qif.qif_sfa"
TANH = "rate_neurons.leaky_integrator.tanh"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T = 16, 60


def _new(pkg, dt, dtype="float32", cls=None):
    if pkg == "jax":
        return (cls[0] if cls else JNetwork)(dt, dtype=getattr(jnp, dtype))
    return (cls[1] if cls else Network)(dt, device="cpu", dtype=getattr(torch, dtype))


def _attach(pkg, net, label):
    node = net.get_node(label)
    if pkg == "jax":
        j_attach(node, tile=128, interpret=True)
    else:
        attach_generic_fused_step(node)


def _lif(pkg):
    """A LIF population with a generic fused step and a dense coupling."""
    W = np.abs(np.random.default_rng(0).normal(size=(N, N))) * 0.5
    net = _new(pkg, 1e-3)
    net.add_diffeq_node("lif", PREFIX[pkg] + LIF, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="lif_op", spike_var="spike",
                        reset_var="v", spike_threshold=1.0, spike_reset=0.0,
                        float_precision="float32")
    net.compile()
    _attach(pkg, net, "lif")
    return net


def _heun(pkg):
    """A tanh rate population integrated by Heun's method: the kernel in
    derivative mode, twice a step."""
    rng = np.random.default_rng(12)
    net = _new(pkg, 1e-2)
    net.add_diffeq_node("rnn", PREFIX[pkg] + TANH, weights=rng.normal(size=(N, N)) * 0.3,
                        input_var="li_op/I_ext", output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", integrator="heun", float_precision="float32",
                        node_vars={"all/li_op/tau": rng.uniform(5.0, 15.0, size=N),
                                   "all/li_op/eta": 1.0})
    net.compile()
    _attach(pkg, net, "rnn")
    return net


def _two_couplings(pkg):
    """Two couplings (K = 2) through a circuit template, the second into the
    input variable itself."""
    rng = np.random.default_rng(9)
    nt, ct = (JNodeTemplate, JCircuit) if pkg == "jax" else (NodeTemplate, CircuitTemplate)
    circ = ct("c", {f"p{i}": nt.from_yaml(PREFIX[pkg] + TANH) for i in range(N)})
    circ.add_edges_from_matrix("tanh_op/r", "li_op/r_in", weight=rng.normal(size=(N, N)) * 0.2)
    circ.add_edges_from_matrix("tanh_op/r", "li_op/I_ext", weight=rng.normal(size=(N, N)) * 0.1)
    net = _new(pkg, 1e-2)
    net.add_diffeq_node("rnn", circ, input_var="li_op/I_ext", output_var="li_op/v",
                        float_precision="float32")
    net.compile()
    _attach(pkg, net, "rnn")
    return net


def _int4(pkg):
    W = np.random.default_rng(3).normal(scale=0.3, size=(N, N))
    net = _new(pkg, 1e-2)
    net.add_diffeq_node("p", PREFIX[pkg] + TANH, weights=W, source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext",
                        output_var="tanh_op/r", coupling_dtype="int4", float_precision="float32")
    net.compile()
    return net


def _block_node(pkg):
    """A QIF+SFA population with a frozen int8 block coupling."""
    brc = jbrc if pkg == "jax" else block_random_connectivity
    A = brc(64, 64, 32, block_size=16, seed=0)
    net = _new(pkg, 1e-3, dtype="float64")
    net.add_diffeq_node("qif", PREFIX[pkg] + QIF_SFA, weights=A, source_var="s",
                        target_var="s_in", input_var="I_ext", output_var="s", spike_var="spike",
                        spike_def="v", op="qif_sfa_op", spike_threshold=30.0,
                        spike_reset=-30.0, coupling_dtype="int8",
                        node_vars={"all/qif_sfa_op/eta": 3000.0 + 10.0 * np.arange(64.0)})
    net.compile()
    return net


def _block_edge(pkg):
    """A tanh population whose whole coupling is a delayed int8_master
    BlockSparseLinear feedback self-edge."""
    rng = np.random.default_rng(5)
    n_br, cb, bs = 4, 2, 4
    blocks = rng.normal(size=(n_br, cb, bs, bs)) * 0.4
    cols = np.stack([rng.choice(n_br, size=cb, replace=False) for _ in range(n_br)])
    W = (JBlocks if pkg == "jax" else BlockSparseCoupling)(blocks, cols.astype(np.int32))
    net = _new(pkg, 1e-2, dtype="float64", cls=(JFeedbackNetwork, FeedbackNetwork))
    n = n_br * bs
    net.add_diffeq_node("pop", PREFIX[pkg] + TANH, weights=np.zeros((n, n)),
                        source_var="tanh_op/r", target_var="li_op/r_in",
                        input_var="li_op/I_ext", output_var="li_op/v")
    net.add_edge("pop", "pop", weights=W, delays=rng.integers(0, 4, size=(n_br, cb)),
                 feedback=True, block_dtype="int8_master")
    net.compile()
    return net


def _drive(shape, seed, lo=100.0, hi=300.0):
    return (lo + (hi - lo) * np.random.default_rng(seed).random(shape)).astype(np.float32)


def _graph_targets(path, program="step.pt2"):
    ep = torch.export.load(os.path.join(path, program))
    return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]


@pytest.mark.parametrize("batch", [None, 3])
def test_generic_lif_bundle_equals_run_and_jax(tmp_path, batch):
    """The LIF population with the generic step, single and batch=3: the
    program calls rectipy::generic_fused_step (_rows) and every input has a
    static shape, the bundle carries the
    generated source and the plain step exported at its shapes, the served
    records equal run / run_batch bit for bit over two chained requests and
    JAX's bundle (its Pallas kernel in interpret mode)."""
    shape = (T, 1) if batch is None else (batch, T, 1)
    ins = [_drive(shape, 1), _drive(shape, 2)]
    path = export_network(_lif("torch"), str(tmp_path / "b"), T=T, n_in=1, batch=batch)
    op = "generic_fused_step" if batch is None else "generic_fused_rows"
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["ops"] == [f"rectipy::{op}"] and meta["format_version"] == 2
    (key, entry), = meta["generic"].items()
    assert f"rectipy.{op}.default" in _graph_targets(path)
    # every input has a static shape (the kernel's rows view the node's
    # parameters; a symbolic size would keep the program from moving device)
    ep = torch.export.load(os.path.join(path, "step.pt2"))
    assert all(isinstance(d, int) for n in ep.graph.nodes if n.op == "placeholder"
               for d in n.meta["val"].shape)
    source = open(os.path.join(path, entry["source"])).read()
    assert '#include "generic_fused_step.cuh"' in source and len(key) == 16
    assert [p["op"] for p in entry["programs"]] == [op]
    model = load_network(path)
    got = np.concatenate([model(x) for x in ins], axis=-2)
    both = np.concatenate(ins, axis=-2)
    ref = (_lif("torch").run(both, verbose=False).to_numpy("out") if batch is None
           else _lif("torch").run_batch(both, verbose=False)["out"])
    np.testing.assert_array_equal(got, ref)
    assert got.max() > 0, "no spikes -- weak test"
    jmodel = j_load(j_export(_lif("jax"), str(tmp_path / "j"), T=T, n_in=1, batch=batch))
    jgot = np.concatenate([np.asarray(jmodel(x)) for x in ins], axis=-2)
    np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["heun", "two_couplings"])
def test_heun_and_two_coupling_generic_bundles_equal_run(tmp_path, case):
    """Heun's rate net (the kernel in derivative mode, two operator calls a
    step) and the K = 2 circuit: served == run bit for bit, and JAX's
    bundle within the serving tests' tolerance."""
    build = {"heun": _heun, "two_couplings": _two_couplings}[case]
    inp = np.random.default_rng(4).normal(size=(T, N)).astype(np.float32)
    path = export_network(build("torch"), str(tmp_path / case), T=T)
    targets = _graph_targets(path)
    assert targets.count("rectipy.generic_fused_step.default") == (2 if case == "heun" else 1)
    got = load_network(path)(inp)
    np.testing.assert_array_equal(got, build("torch").run(inp, verbose=False).to_numpy("out"))
    jgot = j_load(j_export(build("jax"), str(tmp_path / "j"), T=T))(inp)
    np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("batch", [None, 4])
def test_int4_bundle_equals_run_and_jax(tmp_path, batch):
    """A frozen int4 coupling: the step calls rectipy::int4_mv (int4_mm for
    batch=4) on the packed weights; served == run / run_batch bit for bit,
    and JAX's int4 bundle within rtol 1e-6."""
    shape = (T, 1) if batch is None else (batch, T, 1)
    inp = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    path = export_network(_int4("torch"), str(tmp_path / "i4"), T=T, n_in=1, batch=batch)
    model = load_network(path)
    assert model.meta["ops"] == ["rectipy::int4_mv" if batch is None else "rectipy::int4_mm"]
    got = model(inp)
    ref = (_int4("torch").run(inp, verbose=False).to_numpy("out") if batch is None
           else _int4("torch").run_batch(inp, verbose=False)["out"])
    np.testing.assert_array_equal(got, ref)
    jgot = j_load(j_export(_int4("jax"), str(tmp_path / "j"), T=T, n_in=1, batch=batch))(inp)
    np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["node", "edge"])
def test_block_int8_bundle_equals_run_and_jax(tmp_path, case):
    """A frozen int8 block coupling on a node, and a delayed int8_master
    BlockSparseLinear edge (its gathered stack): the step calls
    rectipy::block_int8_mv and never the plain contraction (no bmm in the
    graph); served == run bit for bit over two chained requests, and JAX's
    bundle within rtol 1e-9 at float64."""
    build = {"node": _block_node, "edge": _block_edge}[case]
    m = 1 if case == "node" else 16
    ins = [np.random.default_rng(s).normal(size=(T // 2, m)) * (40.0 if case == "node" else 1.0)
           for s in (7, 8)]
    path = export_network(build("torch"), str(tmp_path / case), T=T // 2, n_in=m)
    model = load_network(path)
    assert "rectipy::block_int8_mv" in model.meta["ops"]
    targets = _graph_targets(path) + (_graph_targets(path, "prep.pt2")
                                      if model.meta["programs"]["prep"] else [])
    assert "rectipy.block_int8_mv.default" in targets
    assert not any("bmm" in t for t in targets), targets
    got = np.concatenate([model(x) for x in ins])
    ref = build("torch").run(np.concatenate(ins), verbose=False).to_numpy("out")
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got).max() > 0
    jmodel = j_load(j_export(build("jax"), str(tmp_path / "j"), T=T // 2, n_in=m))
    jgot = np.concatenate([np.asarray(jmodel(x)) for x in ins])
    np.testing.assert_allclose(got, jgot, rtol=1e-9, atol=1e-12)


FRESH = r"""
import json, sys
import numpy as np
cfg = json.loads(sys.argv[1])
sys.path.insert(0, cfg["root"])
import rectipy_tpu_torch.network as network
import rectipy_tpu_torch.dsl.parser as parser
import rectipy_tpu_torch.dsl.yaml_lite as yaml_lite

def refuse(*args, **kwargs):
    raise AssertionError("the serving process built a network or read a template")

network.Network.__init__ = refuse
parser.load_file = yaml_lite.load_file = refuse
from rectipy_tpu_torch.ops import library
from rectipy_tpu_torch.serving import load_network

model = load_network(cfg["path"])
assert not library._GENERIC[cfg["key"]].steps, "a live step in the serving process"
got = model(np.load(cfg["inp"]))
np.testing.assert_array_equal(got, np.load(cfg["oracle"]))
bad = [k for k in sys.modules if k.split(".")[0] in ("rectipy_tpu", "jax")]
assert not bad, bad
print("FRESH-OK")
"""


def test_generic_bundle_serves_in_a_fresh_process(tmp_path):
    """A process that builds no Network and reads no template serves the
    LIF bundle on the CPU through the exported plain step alone, equal to
    run bit for bit."""
    inp = _drive((T, 1), 3)
    path = export_network(_lif("torch"), str(tmp_path / "g"), T=T, n_in=1)
    np.save(str(tmp_path / "inp.npy"), inp)
    np.save(str(tmp_path / "oracle.npy"), _lif("torch").run(inp, verbose=False).to_numpy("out"))
    (key,) = json.load(open(os.path.join(path, "meta.json")))["generic"]
    cfg = {"root": ROOT, "path": path, "key": key, "inp": str(tmp_path / "inp.npy"),
           "oracle": str(tmp_path / "oracle.npy")}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", FRESH, json.dumps(cfg)], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr
    assert "FRESH-OK" in out.stdout


def test_format_1_bundles_still_load(tmp_path):
    """A bundle of format 1 (the layout before generic steps: no generic/ and no
    meta['generic']) loads and serves as before."""
    net = _int4("torch")
    inp = np.random.default_rng(9).normal(size=(T, 1)).astype(np.float32)
    path = export_network(net, str(tmp_path / "v1"), T=T, n_in=1)
    meta_path = os.path.join(path, "meta.json")
    meta = json.load(open(meta_path))
    del meta["generic"]
    meta["format_version"] = 1
    json.dump(meta, open(meta_path, "w"))
    np.testing.assert_array_equal(load_network(path)(inp),
                                  _int4("torch").run(inp, verbose=False).to_numpy("out"))


def test_generic_sources_are_checked_and_unknown_keys_raise(tmp_path):
    """A bundle's source whose hash is not its key, or one that is missing,
    raises at load; the operator with an unknown key raises on every
    device; nothing stands in for the kernel."""
    path = export_network(_lif("torch"), str(tmp_path / "g"), T=4, n_in=1)
    meta = json.load(open(os.path.join(path, "meta.json")))
    (key, entry), = meta["generic"].items()
    src = os.path.join(path, entry["source"])
    text = open(src).read()
    with open(src, "w") as f:
        f.write(text + "// edited\n")
    with pytest.raises(ValueError, match="does not hash"):
        load_network(path)
    os.remove(src)
    with pytest.raises(FileNotFoundError):
        load_network(path)
    x = torch.zeros(N)
    args = ([x], [torch.zeros(N, N)], x, [x, x], [x, x, x, x], "0" * 16, [1.0, 1.0, 0.0, 0.5],
            1e-3, 1.0, 0.0)
    with pytest.raises(RuntimeError, match="not known to this process"):
        library.generic_fused_step(*args)
    with pytest.raises(RuntimeError, match="not known to this process"):
        library.generic_fused_rows(*args)
