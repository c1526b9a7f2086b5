"""The batched forms of the generic fused step and the int4 products (CPU).

- ``run_batch`` of a node with the generic fused step against the JAX
  package's ``run_batch`` of the same network with its Pallas kernel
  attached in interpret mode (``vmap`` of the kernel), for every node class
  and mode of ``tests/test_torch_generic_fused.py`` at its tolerances, each
  trial against the port's single-trial run, and one B-row step a time step
  (two for Heun);
- ``generic_fused_rows_plain`` against the single-trial plain step, trial
  by trial, exactly;
- frozen ``int4`` in ``run_batch``, ``int4_master`` in ``fit_bptt_batch``,
  an ``int4_master`` coupling swept per trial through ``batch_vars`` and
  the source gradients through a swept frozen ``int4`` coupling, against
  the JAX package at float32;
- numpy models of ``int4_mm`` and ``int4_mm_t`` (``csrc/int4_matvec.cu``),
  lane by lane: the nibble unpack, the even/odd split of the activations,
  the shared-memory layouts and the chunks of rows, against the plain
  versions bit for bit;
- a numpy model of ``int4_mm``'s tensor-core kernel, lane by lane: the
  k-permutation of the nibbles in the ``mma.sync`` fragments, the split
  stage, the chunks of columns and their passes, and the stride guard of
  the last k-block; and ``int4_mm_route``;
- a numpy model of ``int4_mm_t``'s tensor-core kernel, every lane of every
  warp: the byte transposes and the nibble unpack into the fragments, the
  stage of the activations, the chunks of rows and their passes, the
  stride guard of the last column strip; and ``int4_mm_t_route``;
- a numpy schedule model of the tiled float32 B-row QIF step
  (``csrc/rows_tiled.cuh`` with ``qif_sfa_step.cu``'s geometry): its
  strips, ring stages, copies, lane micro-tiles and K parts, every W read
  once per trial group and inside its row, its float32 sums in the
  kernel's order against the plain step and JAX's ``vmap`` of the Pallas
  kernel in interpret mode;
- the same schedule model for the tiled float32 B-row generic step
  (``generic_fused_step.cuh``'s geometry), once per coupling on its own
  source and row stride, its sums through the plain tail against the plain
  step under ``GENERIC_TOL`` (and, for LIF, JAX's ``vmap`` of the generic
  Pallas kernel in interpret mode), and ``generic_rows_route``'s K limit
  against the shared memory the geometry needs.

Inputs come from numpy seeds.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.dsl.parser import CircuitTemplate as JCircuit
from rectipy_tpu.dsl.parser import NodeTemplate as JNodeTemplate
from rectipy_tpu.ops.generic_fused import attach_generic_fused_step as j_attach
from rectipy_tpu.ops.kernels import make_qif_sfa_pallas_step, pad_coupling
from rectipy_tpu_torch import Network
from rectipy_tpu_torch.dsl.parser import CircuitTemplate, NodeTemplate
from rectipy_tpu_torch.ops import generic_fused as gf
from rectipy_tpu_torch.ops import quant
from rectipy_tpu_torch.ops.kernels import qif_sfa_reference_step
from rectipy_tpu_torch.testing import (GENERIC_CASES, check_generic, generic_case_net,
                                       generic_inputs, lost_eighth_margin)

J, T_ = "neuron_model_templates.", "rectipy_tpu_torch.models."
LIF = "spiking_neurons.lif.lif"
QIF_SFA = "spiking_neurons.qif.qif_sfa"
QIF_RESET = "spiking_neurons.qif.qif_reset"
IK = "spiking_neurons.ik.ik"
TANH = "rate_neurons.leaky_integrator.tanh"


def _net(pkg, dt):
    if pkg == "jax":
        return JNetwork(dt, dtype=jnp.float32), J
    return Network(dt, device="cpu", dtype=torch.float32), T_


F32 = dict(dtype=jnp.float32)  # the node's dtype (both packages take the JAX name)


def _lif(pkg, rng):
    n = 16
    W, tau = np.abs(rng.normal(size=(n, n))) * 0.05, rng.uniform(10.0, 15.0, size=n)
    net, pre = _net(pkg, 1e-2)
    net.add_diffeq_node("lif", pre + LIF, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="lif_op", spike_var="spike",
                        reset_var="v", spike_threshold=10.0, spike_reset=-10.0,
                        node_vars={"eta": 10.0, "tau": tau, "tau_s": 5.0}, **F32)
    return net


def _qif_sfa(pkg, rng):
    n = 32
    W, etas = (rng.random((n, n)) < 0.2) * 0.02, rng.normal(size=n) + 100.0
    net, pre = _net(pkg, 1e-3)
    net.add_diffeq_node("qif", pre + QIF_SFA, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="qif_sfa_op", spike_var="spike",
                        spike_def="v", spike_threshold=30.0, spike_reset=-30.0,
                        node_vars={"all/qif_sfa_op/eta": etas}, **F32)
    return net


def _spikenet(pkg, rng):
    n = 24
    W = np.abs(rng.normal(size=(n, n))) * 0.01
    net, pre = _net(pkg, 1e-3)
    net.add_diffeq_node("qif", pre + QIF_RESET, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="qif_reset_op", spike_var="spike",
                        reset_var="reset", reset=False, spike_threshold=10.0,
                        spike_reset=-10.0, node_vars={"eta": 8.0, "k": 0.0}, **F32)
    return net


def _multi_spike(pkg, rng):
    n = 16
    W = np.abs(rng.normal(size=(n, n))) * 0.02
    net, pre = _net(pkg, 1e-2)
    net.add_diffeq_node("ik", pre + IK, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="ik_op", spike_var=["spike"],
                        reset_var=["v"], spike_threshold=40.0, spike_reset=-60.0,
                        node_vars={"eta": 200.0}, **F32)
    return net


def _tanh_heun(pkg, rng):
    n = 24
    W, tau = rng.normal(size=(n, n)) * 0.3, rng.uniform(5.0, 15.0, size=n)
    net, pre = _net(pkg, 1e-2)
    net.add_diffeq_node("rnn", pre + TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r", target_var="li_op/r_in",
                        integrator="heun", node_vars={"all/li_op/tau": tau,
                                                      "all/li_op/eta": 1.0}, **F32)
    return net


def _ei(pkg, rng):
    """Two couplings, the second into the input variable itself (K = 2)."""
    n = 24
    W1, W2 = rng.normal(size=(n, n)) * 0.2, rng.normal(size=(n, n)) * 0.1
    nt, ct = (JNodeTemplate, JCircuit) if pkg == "jax" else (NodeTemplate, CircuitTemplate)
    net, pre = _net(pkg, 1e-2)
    circ = ct("c", {f"p{i}": nt.from_yaml(pre + TANH) for i in range(n)})
    circ.add_edges_from_matrix("tanh_op/r", "li_op/r_in", weight=W1)
    circ.add_edges_from_matrix("tanh_op/r", "li_op/I_ext", weight=W2)
    net.add_diffeq_node("rnn", circ, input_var="li_op/I_ext", output_var="li_op/v", **F32)
    return net


# name -> (build function, steps, drive (scale, offset of trial 0, of the last),
# atol and JAX tile of test_torch_generic_fused.py's case, spiking?)
ROW_CASES = {
    "lif": (_lif, 150, (3.0, 10.0, 30.0), 2e-4, 128, True),
    "qif_sfa": (_qif_sfa, 200, (1.0, 0.0, 200.0), 2e-4, 128, True),
    "spikenet": (_spikenet, 200, (1.0, 200.0, 600.0), 2e-4, 128, True),
    "multi_spike_reset": (_multi_spike, 250, (1.0, 3000.0, 12000.0), 2e-4, 128, True),
    "tanh_heun": (_tanh_heun, 150, (1.0, -1.0, 1.0), 5e-5, 128, False),
    "two_couplings": (_ei, 150, (1.0, -1.0, 1.0), 5e-4, 16, False),
}


def _build(case, pkg):
    build, *_, tile, _ = ROW_CASES[case]
    net = build(pkg, np.random.default_rng(21))
    net.compile()
    node = net.get_node(list(net.nodes)[0])
    if pkg == "jax":
        j_attach(node, tile=tile, interpret=True)
    else:
        gf.attach_generic_fused_step(node)
    return net


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(gf, name)

    def counted(*args):
        calls.append(1)
        return fn(*args)

    monkeypatch.setattr(gf, name, counted)
    return calls


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_generic_rows_run_batch_matches_jax_and_single_trials(case, monkeypatch):
    _, T, (scale, lo, hi), atol, _, spiking = ROW_CASES[case]
    B = 4
    n_in = _build(case, "torch").n_in
    ins = (np.random.default_rng(22).normal(size=(B, T, n_in)) * scale
           + np.linspace(lo, hi, B)[:, None, None]).astype(np.float32)
    rj = _build(case, "jax").run_batch(ins, verbose=False)
    net = _build(case, "torch")
    rows, single = _counting(monkeypatch, "generic_fused_rows"), _counting(
        monkeypatch, "generic_fused_step")
    rt = net.run_batch(ins, verbose=False)
    heun = case == "tanh_heun"
    assert (len(rows), len(single)) == ((2 if heun else 1) * T, 0)
    np.testing.assert_allclose(rt["out"], np.asarray(rj["out"]), rtol=1e-4, atol=atol)
    monkeypatch.undo()
    for b in (0, B - 1):
        one = _build(case, "torch").run(ins[b], verbose=False).to_numpy("out")
        np.testing.assert_allclose(rt["out"][b], one, rtol=0, atol=1e-6)
    assert np.abs(rt["out"][0] - rt["out"][-1]).max() > 1e-3
    if spiking:
        assert rt["out"].max() > 0, "no spikes -- weak test"


@pytest.mark.parametrize("case", list(GENERIC_CASES))
def test_generic_rows_plain_equals_single_trial_plain(case):
    # trial by trial, bit for bit: states as strided rows of one (B, V*n)
    # buffer, per-trial sources, and a drive shared by every trial (row
    # stride 0) in one of the two calls
    n, B = 24, 4
    W = np.random.default_rng(23).normal(size=(n, n)) / n
    _, node = generic_case_net(case, W, "cpu", seed=23)
    step, _, _, _, vecs = generic_inputs(node, 23)
    V, K = len(step.state_order), len(step.targets)
    Ws = [node.args[f"__w_fused_{c}__"] for c in range(K)]
    rows = [generic_inputs(node, 30 + b)[1:4] for b in range(B)]  # (srcs, drive, states)
    y = torch.stack([torch.cat(st) for _, _, st in rows])  # (B, V*n)
    states = list(y.reshape(B, V, n).unbind(1))
    srcs = [torch.stack([r[0][c] for r in rows]) for c in range(K)]
    drives = torch.stack([r[1] for r in rows])
    for drive in (drives, drives[0]):
        got = gf.generic_fused_rows(step, srcs, Ws, drive, states, vecs)
        assert got.shape == (B, V, n) and states[0].stride(0) == V * n
        for b in range(B):
            one = gf.generic_fused_step_plain(step, [s[b] for s in srcs], Ws,
                                              drive[b] if drive.dim() == 2 else drive,
                                              [s[b].contiguous() for s in states], vecs)
            assert torch.equal(got[b], one)


BF16, F32_T = torch.bfloat16, torch.float32


_K5 = [4096 * (i + 1) for i in range(10)]  # five W and five source bases, all aligned


@pytest.mark.parametrize("w_dtype, n, src_lds, ptrs, route", [
    (BF16, 10_000, [20_000], [4096, 4096 + 200_000_000], "mma"),  # LIF's (B, 2n) state rows
    (BF16, 10_000, [10_000, 0], [4096, 8192, 16384, 32768], "mma"),  # K = 2, one shared row
    (F32_T, 10_000, [20_000], [4096, 4096 + 400_000_000], "tiled"),  # f32 W: the tiled kernel
    (BF16, 9_996, [19_992], [4096, 8192], "vec"),  # n % 8 == 4: the CUDA cores' vector loads
    (F32_T, 9_996, [19_992], [4096, 8192], "tiled"),  # n % 4 is all the tiled kernel needs
    (F32_T, 10_000, [10_000, 0], [4096, 8192, 16384, 32768], "tiled"),  # K = 2, one shared row
    (F32_T, 1_000, [1_000] * 5, _K5, "tiled"),  # K = 5: the sums still fit beside the ring
    (F32_T, 1_000, [1_000] * 6, _K5 + [45056, 49152], "vec"),  # K = 6: they do not
    (F32_T, 1_000, [1_000], [4096 + 8, 8192], "scalar"),  # f32 W not 16-byte aligned
    (F32_T, 1_000, [1_000], [4096, 8192 + 4], "scalar"),  # f32: a source base not aligned
    (F32_T, 1_000, [1_002], [4096, 8192], "scalar"),  # f32: a source row stride % 4 != 0
    (BF16, 1_000, [1_000], [4096 + 8, 8192], "scalar"),  # W not 16-byte aligned
    (BF16, 1_000, [1_000, 1_000], [4096, 4096 + 8, 8192, 12288], "scalar"),  # the second W
    (BF16, 1_000, [1_000], [4096, 8192 + 4], "scalar"),  # a source base not 16-byte aligned
    (BF16, 1_000, [1_002], [4096, 8192], "scalar"),  # a source row stride % 4 != 0
    (BF16, 9_999, [9_999], [4096, 8192], "scalar"),  # odd n
    (F32_T, 1_002, [1_002], [4096, 8192], "scalar"),
])
def test_generic_rows_route(w_dtype, n, src_lds, ptrs, route):
    # the B-row generic step's instance is a pure function of the couplings'
    # dtype, n, their number, the sources' row strides and the W and source
    # addresses: aligned bf16 takes the tensor cores, f32 never does; an
    # aligned f32 W of at most five couplings takes the tiled kernel
    assert gf.generic_rows_route(w_dtype, n, src_lds, ptrs) == route


def test_generic_rows_route_of_a_node_state_view():
    # a LIF node's source s is the view y[:, n:2n] of its (B, 2n) state: the
    # route follows n and the dtype through the view's offset and row stride
    for n, w_dtype, route in ((1_000, BF16, "mma"), (1_024, BF16, "mma"), (1_004, BF16, "vec"),
                              (1_004, F32_T, "tiled"), (1_000, F32_T, "tiled"),
                              (1_003, BF16, "scalar"), (1_002, F32_T, "scalar"),
                              (1_003, F32_T, "scalar")):
        y = torch.zeros((4, 2 * n), dtype=torch.float32)
        W, s = torch.zeros((n, n), dtype=w_dtype), y[:, n:2 * n]
        assert gf.generic_rows_route(w_dtype, n, [s.stride(0)],
                                     [W.data_ptr(), s.data_ptr()]) == route


# ------------------------------------------------------------------- int4
def _rate(pkg, W, coupling, train=False):
    # the output is a state, so that one product runs a step
    net, pre = _net(pkg, 1e-2)
    net.add_diffeq_node("p", pre + TANH, weights=W, source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext",
                        output_var="li_op/v", coupling_dtype=coupling,
                        train_params=["weights"] if train else None)
    return net


def test_frozen_int4_run_batch_matches_jax_and_takes_int4_mm(monkeypatch):
    # the (B, n) sources take int4_mm (its plain version here), one call a
    # step, against JAX's vmap of its int4 dot
    rng = np.random.default_rng(24)
    N, B, T = 20, 5, 40
    W = rng.normal(scale=0.3, size=(N, N))
    ins = rng.normal(size=(B, T, 1)) * np.linspace(0.5, 3.0, B)[:, None, None]
    calls = []
    mm = quant.int4_mm
    monkeypatch.setattr(quant, "int4_mm", lambda *a: calls.append(1) or mm(*a))
    rt = _rate("torch", W, "int4").run_batch(ins, verbose=False)
    assert len(calls) == T
    rj = _rate("jax", W, "int4").run_batch(ins, verbose=False)
    np.testing.assert_allclose(rt["out"], np.asarray(rj["out"]), rtol=1e-5, atol=1e-6)


def test_int4_master_fit_bptt_batch_matches_jax_at_float32(monkeypatch):
    # the chain trajectory's (T, B, n) rows through int4_mm / int4_mm_t
    # (their plain versions) and one dW product, against JAX at float32
    rng = np.random.default_rng(25)
    n, B, T = 12, 4, 40
    W0 = rng.normal(size=(n, n)) * 0.3
    ins, tgts = rng.normal(size=(B, T, 1)), rng.normal(size=(B, T, n)) * 0.1
    kw = dict(n_epochs=3, optimizer="adam", lr=1e-2, verbose=False)
    calls = {"int4_mm": [], "int4_mm_t": []}
    for name in calls:
        fn = getattr(quant, name)
        monkeypatch.setattr(quant, name, lambda *a, fn=fn, c=calls[name]: c.append(1) or fn(*a))
    tn = _rate("torch", W0, "int4_master", train=True)
    lt = np.asarray(tn.fit_bptt_batch(ins, tgts, **kw)["epoch_loss"])
    assert tn.last_fit["trajectory"] == "chain"
    assert (len(calls["int4_mm"]), len(calls["int4_mm_t"])) == (3 * T, 3 * T)
    jn = _rate("jax", W0, "int4_master", train=True)
    lj = np.asarray(jn.fit_bptt_batch(ins, tgts, **kw)["epoch_loss"])
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    wt = tn.get_node("p")["weights"].numpy()
    wj = np.asarray(jn.get_node("p")["weights"])
    np.testing.assert_allclose(wt, wj, rtol=1e-4, atol=1e-6)
    assert np.abs(wt - W0).max() > 1e-4


def test_swept_int4_coupling_preps_per_trial_like_jax(monkeypatch):
    # a per-trial int4_master coupling through batch_vars: quantized and
    # packed per trial once per run, one int4_mv per trial a step
    rng = np.random.default_rng(26)
    N, B, T = 10, 3, 30
    W = rng.normal(scale=0.3, size=(N, N))
    Ws = rng.normal(scale=0.3, size=(B, N, N))
    ins = rng.normal(size=(B, T, 1))
    bv = {("p", "weights"): Ws}
    calls = []
    mv = quant.int4_mv
    monkeypatch.setattr(quant, "int4_mv", lambda *a: calls.append(1) or mv(*a))
    rt = _rate("torch", W, "int4_master").run_batch(ins, verbose=False, batch_vars=bv)
    assert len(calls) == B * T
    monkeypatch.undo()
    rj = _rate("jax", W, "int4_master").run_batch(ins, verbose=False, batch_vars=bv)
    np.testing.assert_allclose(rt["out"], np.asarray(rj["out"]), rtol=0, atol=1e-6)
    for b in range(B):
        one = _rate("torch", Ws[b], "int4_master").run(ins[b], verbose=False).to_numpy("out")
        np.testing.assert_allclose(rt["out"][b], one, rtol=0, atol=1e-6)


@pytest.mark.parametrize("coupling,lo,hi", [("int8", -127, 128), ("int4", -7, 8)])
def test_swept_frozen_coupling_keeps_its_shared_row_scale_like_jax(coupling, lo, hi):
    # a frozen int8/int4 coupling swept per trial: each trial's integer
    # weights with the coupling's one (n,) row scale, as JAX's vmap applies
    # them (the per-trial product once took trial b's scale from that row)
    rng = np.random.default_rng(31)
    n, B, T = 8, 3, 20
    W = rng.normal(size=(n, n)) * 0.3
    Wq = rng.integers(lo, hi, size=(B, n, n)).astype(np.int8)
    ins = rng.normal(size=(B, T, 1))
    cd = {"jax": {"int8": jnp.int8}, "torch": {"int8": torch.int8}}
    rj, rt = (_rate(pkg, W, cd[pkg].get(coupling, coupling)).run_batch(
        ins, verbose=False, batch_vars={("p", "weights"): Wq}) for pkg in ("jax", "torch"))
    np.testing.assert_allclose(rt["out"], np.asarray(rj["out"]), rtol=1e-5, atol=1e-7)
    assert np.abs(rt["out"][0] - rt["out"][-1]).max() > 1e-3


def test_swept_frozen_int4_coupling_passes_source_gradients_like_jax():
    # fit_bptt_batch with a frozen int4 carrier swept per trial and a
    # trained input edge: the straight-through gradient goes through each
    # trial's own (n, n) weights, as JAX's vmap takes it
    rng = np.random.default_rng(30)
    n, B, T = 8, 3, 20
    W = rng.normal(size=(n, n)) * 0.3
    Wq = rng.integers(-7, 8, size=(B, n, n)).astype(np.int8)
    ins, tgts = rng.normal(size=(B, T, 2)), rng.normal(size=(B, T, n)) * 0.1
    W_in = rng.normal(size=(n, 2))
    res = []
    for pkg in ("jax", "torch"):
        # JAX at float32 throughout: its int4 JVP refuses float64 tangents
        # (ROADMAP Queue 3), and tests/conftest.py turns x64 on
        with jax.enable_x64(False):
            net = _rate(pkg, W, "int4")
            net.add_func_node("inp", 2, activation_function="identity")
            net.add_edge("inp", "p", weights=W_in, train="gd")
            obs = net.fit_bptt_batch(ins, tgts, n_epochs=3, optimizer="sgd", lr=2.0,
                                     verbose=False, batch_vars={("p", "weights"): Wq})
            res.append((np.asarray(obs["epoch_loss"]),
                        np.asarray(net.get_edge("inp", "p").params["weights"])))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-5, atol=1e-7)
    assert np.abs(res[1][1] - W_in).max() > 1e-3


# A numpy model of int4_mm_kernel and int4_mm_t_kernel's vector paths
# (csrc/int4_matvec.cu): which bytes each lane or thread loads, the nibble
# unpack (lo_nibbles, hi_nibbles), the even/odd split of the activations and its
# shared-memory word order, the chunks, and every __dp4a.
def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte n of the result is byte
    (sel >> 4n) & 7 of the 8 bytes y:x."""
    both = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(both), dtype=np.uint64)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        out |= ((both >> np.uint64(8 * k)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _sbytes(u):
    """uint32 words -> their 4 signed bytes each (little-endian), int64."""
    u = np.ascontiguousarray(np.asarray(u, np.uint32))
    return u.astype("<u4").view(np.int8).reshape(u.shape + (4,)).astype(np.int64)


def _dp4a(a, b, acc):
    return acc + (_sbytes(a) * _sbytes(b)).sum(axis=-1)


def _nibbles(u, shift):
    """lo_nibbles (shift 0) or hi_nibbles (shift 4): ((u >> shift) &
    0x0F0F0F0F) + 0x78787878, then each byte's top bit flipped."""
    b = (np.asarray(u, np.uint32) >> np.uint32(shift)) & np.uint32(0x0F0F0F0F)
    return ((b + np.uint32(0x78787878)) ^ np.uint32(0x80808080)).astype(np.uint32)


def _pack_bytes(b):
    """(..., 4) integers -> uint32 words of their low bytes."""
    b = (np.asarray(b, np.int64) & 0xFF).astype(np.uint32)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _words(a):
    """int8/uint8 array (..., 4k) -> uint32 words (..., k), little-endian."""
    return np.ascontiguousarray(a).view("<u4")


def _int4_mm_model(wp, xq, rs, act):
    n_out, stride = wp.shape
    B, n_in = xq.shape
    assert n_in % 16 == 0 and stride % 16 == 0
    chunk, words = 1024, 64
    acc = np.zeros((B, n_out, 32), np.int64)  # per lane
    lanes = np.arange(32)
    for k0 in range(0, n_in, chunk):
        # the stage: word w of trial b (activations 16w..16w+15), split into
        # even and odd bytes, at (w & 1) * 32 + w // 2; zeros past the data
        xs = np.zeros((B, words, 4), np.uint32)
        for w in range(words):
            k = k0 + 16 * w
            a = _words(xq[:, k:k + 16]) if k < n_in else np.zeros((B, 4), np.uint32)
            split = np.stack([_byte_perm(a[:, 0], a[:, 1], 0x6420),
                              _byte_perm(a[:, 0], a[:, 1], 0x7531),
                              _byte_perm(a[:, 2], a[:, 3], 0x6420),
                              _byte_perm(a[:, 2], a[:, 3], 0x7531)], axis=1)
            xs[:, (w & 1) * 32 + (w >> 1)] = split
        x0, x1 = xs[:, lanes], xs[:, 32 + lanes]  # (B, 32, 4) each
        # lane l's 16 packed bytes of each row (zero weights past n_in)
        u = np.full((n_out, 32, 4), 0x88888888, np.uint32)
        for lane in lanes:
            k = k0 + 32 * lane
            if k < n_in:
                u[:, lane] = _words(wp[:, k // 2:k // 2 + 16])
        lo, hi = _nibbles(u, 0), _nibbles(u, 4)  # (n_out, 32, 4)
        xw = (x0[..., 0], x0[..., 1], x0[..., 2], x0[..., 3],
              x1[..., 0], x1[..., 1], x1[..., 2], x1[..., 3])
        ws = (lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1],
              lo[..., 2], hi[..., 2], lo[..., 3], hi[..., 3])
        for wv, xv in zip(ws, xw):
            acc = _dp4a(wv[None, :, :], xv[:, None, :], acc)
    total = acc.sum(axis=-1).astype(np.float32)
    return (total * rs[None, :]) * act[:, None]


def _int4_mm_t_model(wp, vq, act, n_in, rows_per_chunk):
    n_out, stride = wp.shape
    B = vq.shape[0]
    assert rows_per_chunk % 4 == 0 and stride % 2 == 0
    cols = np.arange(0, n_in, 4)  # col0 of every thread
    out = np.zeros((B, len(cols), 4), np.int64)
    for r0 in range(0, n_out, rows_per_chunk):
        r1 = min(n_out, r0 + rows_per_chunk)
        acc = np.zeros_like(out)
        for r in range(r0, r1, 4):
            pairs = []
            for k in range(4):  # pair_bytes: 2 packed bytes at col0 / 2, 0x8888 past r1
                if r + k < r1:
                    p = wp[r + k, cols // 2].astype(np.uint32) | (
                        wp[r + k, cols // 2 + 1].astype(np.uint32) << 8)
                else:
                    p = np.full(len(cols), 0x8888, np.uint32)
                pairs.append(p)
            x, y = pairs[0] | (pairs[1] << 16), pairs[2] | (pairs[3] << 16)
            t0, t1 = _byte_perm(x, y, 0x6420), _byte_perm(x, y, 0x7531)
            col = (_nibbles(t0, 0), _nibbles(t0, 4), _nibbles(t1, 0),
                   _nibbles(t1, 4))
            v = np.zeros((B, 4), np.int64)  # the staged word: rows r..r+3, 0 past r1
            m = min(4, r1 - r)
            v[:, :m] = vq[:, r:r + m]
            vw = _pack_bytes(v)
            for c in range(4):
                acc[:, :, c] = _dp4a(col[c][None, :], vw[:, None], acc[:, :, c])
        out += acc  # the reduce kernel adds the chunks' sums
    sums = out.reshape(B, -1)[:, :n_in].astype(np.float32)
    return sums * act[:, None]


def _int4_operands(rng, B, n_out, n_in):
    wq = rng.integers(-8, 8, size=(n_out, n_in))
    wp = quant.pack_int4(torch.as_tensor(wq, dtype=torch.int8))
    xq = rng.integers(-127, 128, size=(B, n_in)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(B, n_out)).astype(np.int8)
    rs = rng.random(n_out).astype(np.float32)
    act = (rng.random(B) + 0.5).astype(np.float32)
    return wq, wp, xq, vq, rs, act


@pytest.mark.parametrize("B,n_out,n_in", [(3, 20, 48), (5, 37, 2064), (2, 9, 16)])
def test_int4_mm_lane_model_equals_plain(B, n_out, n_in):
    # n_in 2064: two chunks of 1,024 inputs and a third of 16, so most lanes
    # of the last load nothing (zero weights against zero activations)
    rng = np.random.default_rng(27)
    wq, wp, xq, _, rs, act = _int4_operands(rng, B, n_out, n_in)
    got = _int4_mm_model(wp.numpy(), xq, rs, act)
    ref = quant.int4_mm(wp, torch.as_tensor(xq), torch.as_tensor(rs), torch.as_tensor(act))
    np.testing.assert_array_equal(got, ref.numpy())
    exact = (xq.astype(np.float64) @ wq.T.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(quant.int4_mm_plain(wp, torch.as_tensor(xq)).numpy(), exact)


@pytest.mark.parametrize("B,n_out,n_in,rows", [(3, 20, 48, 8), (4, 37, 50, 12),
                                                 (2, 33, 7, 4), (5, 64, 1001, 64)])
def test_int4_mm_t_lane_model_equals_plain(B, n_out, n_in, rows):
    # ragged last chunks of rows, and columns past n_in inside a packed byte
    rng = np.random.default_rng(28)
    wq, wp, _, vq, _, act = _int4_operands(rng, B, n_out, n_in)
    got = _int4_mm_t_model(wp.numpy(), vq, act, n_in, rows)
    ref = quant.int4_mm_t(wp, torch.as_tensor(vq), torch.as_tensor(act), n_in)
    np.testing.assert_array_equal(got, ref.numpy())
    exact = (vq.astype(np.float64) @ wq.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(quant.int4_mm_t_plain(wp, torch.as_tensor(vq), n_in).numpy(),
                                  exact)


@pytest.mark.parametrize("B,n_out,n_in", [(7, 13, 31), (1, 16, 16)])
def test_int4_mm_plain_versions_equal_per_row_loops(B, n_out, n_in):
    # bit for bit: the batched products and their epilogues against a loop
    # of the single-vector ones, trial by trial
    rng = np.random.default_rng(29)
    _, wp, xq, vq, rs, act = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                              for a in _int4_operands(rng, B, n_out, n_in))
    mm, mm_t = quant.int4_mm(wp, xq, rs, act), quant.int4_mm_t(wp, vq, act, n_in)
    for b in range(B):
        assert torch.equal(mm[b], quant.int4_mv(wp, xq[b], rs, act[b]))
        assert torch.equal(mm_t[b], quant.int4_mv_t(wp, vq[b], act[b], n_in))


# A numpy model of int4_mm_mma_kernel (csrc/int4_matvec.cu): the chunks of
# columns (one cluster) and their passes; the stage of xq, each 16-byte word
# split into its even and odd bytes (by cp.async and then in place, or byte
# by byte into the split positions); the 16 packed bytes (columns
# 32t..32t+31 of a 128-column k-block) of rows g and g + 8 of each m-tile
# that lane (g, t) loads, read from the packed buffer as the card reads it,
# so that a load past its row's stride would take the next row's bytes; the
# nibbles of word s as k-step s's A registers (low nibbles in k slots
# 4t..4t+3, high ones in 16+4t..16+4t+3) and the staged even and odd bytes
# as its B registers; the PTX ISA's m16n8k32 fragment layouts; and the C
# fragments' (trial, row) in the sums' buffer that the cluster adds up.
_QA_TILES, _QA_BLOCK_K = 4, 128
_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3  # the fragments' group and thread in group


def _mma_m16n8k32(a, b):
    """D = A B of the PTX fragments: a four (..., 32) uint32 registers of
    the 16 x 32 row-major s8 A, b two of the 32 x 8 column-major s8 B (the
    leading axes: a stack of warps); returns the four (..., 32) int64
    registers of the 16 x 8 D."""
    lead = np.broadcast_shapes(*(np.shape(r)[:-1] for r in (*a, *b)))
    A, Bm = np.zeros(lead + (16, 32), np.int64), np.zeros(lead + (32, 8), np.int64)
    for reg, (m_off, k_off) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        A[..., (_G + m_off)[:, None], k_off + 4 * _T[:, None] + np.arange(4)] = _sbytes(a[reg])
    for reg, k_off in enumerate((0, 16)):
        Bm[..., k_off + 4 * _T[:, None] + np.arange(4), _G[:, None]] = _sbytes(b[reg])
    D = A @ Bm
    return [D[..., _G + 8 * (i >> 1), 2 * _T + (i & 1)] for i in range(4)]


def _split_stage(raw, byte_path):
    """The stage of the (32, span) raw activations: each 16-byte word split
    as split_even_odd splits it, or each byte stored at its split position."""
    span = raw.shape[1]
    if byte_path:
        j = np.arange(span)
        pos = (j & ~15) + (j & 8) + (j & 1) * 4 + (j & 7) // 2
        stage = np.zeros_like(raw)
        stage[:, pos] = raw
        return stage
    w = _words(raw).reshape(raw.shape[0], -1, 4)
    split = np.stack([_byte_perm(w[..., 0], w[..., 1], 0x6420),
                      _byte_perm(w[..., 0], w[..., 1], 0x7531),
                      _byte_perm(w[..., 2], w[..., 3], 0x6420),
                      _byte_perm(w[..., 2], w[..., 3], 0x7531)], axis=-1)
    return np.ascontiguousarray(split).view(np.int8).reshape(raw.shape)


def _int4_mma_model(wp, xq, rs, act, cols_per_chunk, pass_cols, byte_path):
    n_out, stride = wp.shape
    n_rows, n_in = xq.shape
    assert stride % 16 == 0 and cols_per_chunk % _QA_BLOCK_K == 0
    assert byte_path or n_in % 16 == 0  # cp.async takes whole 16-byte words
    flat = np.ascontiguousarray(wp).reshape(-1)
    acc = np.zeros((n_rows, n_out), np.int64)  # the sum over chunks (the cluster's reduce)
    for b0 in range(0, n_rows, 32):
        nb = min(32, n_rows - b0)
        ntiles = (nb + 7) // 8
        for c0 in range(0, n_in, cols_per_chunk):
            cols = min(n_in, c0 + cols_per_chunk) - c0
            for p0 in range(0, cols, pass_cols):
                pcols = min(pass_cols, cols - p0)
                blocks = -(-pcols // _QA_BLOCK_K)
                raw = np.zeros((32, blocks * _QA_BLOCK_K), np.int8)
                raw[:nb, :pcols] = xq[b0:b0 + nb, c0 + p0:c0 + p0 + pcols]
                stage = _split_stage(raw, byte_path)
                for row0 in range(0, n_out, 16 * _QA_TILES):  # each warp of each strip
                    c = np.zeros((_QA_TILES, 4, 4, 32), np.int64)  # u, nt, i, lane
                    for kb in range(blocks):
                        k = kb * _QA_BLOCK_K + 32 * _T  # the lane's first column
                        off = (c0 + p0 + kb * _QA_BLOCK_K) // 2 + 16 * _T
                        lo, hi = [], []
                        for m in range(2 * _QA_TILES):
                            r = row0 + 16 * (m >> 1) + 8 * (m & 1) + _G
                            ok = (r < n_out) & (k < pcols)
                            assert np.all(off[ok] + 16 <= stride)  # never the next row
                            u = np.full((32, 4), 0x88888888, np.uint32)
                            for ln in np.flatnonzero(ok):
                                start = r[ln] * stride + off[ln]
                                u[ln] = _words(flat[start:start + 16])
                            lo.append(_nibbles(u, 0))
                            hi.append(_nibbles(u, 4))
                        for nt in range(ntiles):
                            col = kb * _QA_BLOCK_K + 32 * _T[:, None] + np.arange(32)
                            bw = _words(np.ascontiguousarray(stage[8 * nt + _G[:, None], col]))
                            for u, s in np.ndindex(_QA_TILES, 4):
                                d = _mma_m16n8k32((lo[2 * u][:, s], lo[2 * u + 1][:, s],
                                                   hi[2 * u][:, s], hi[2 * u + 1][:, s]),
                                                  (bw[:, 2 * s], bw[:, 2 * s + 1]))
                                for i in range(4):
                                    c[u, nt, i] += d[i]
                    red = np.zeros((32, 16 * _QA_TILES), np.int64)
                    for u, nt, i in np.ndindex(_QA_TILES, 4, 4):
                        red[8 * nt + 2 * _T + (i & 1), 16 * u + _G + 8 * (i >> 1)] = c[u, nt, i]
                    height = min(16 * _QA_TILES, n_out - row0)
                    acc[b0:b0 + nb, row0:row0 + height] += red[:nb, :height]
    return (acc.astype(np.float32) * rs) * act[:, None]


@pytest.mark.parametrize("B,n_out,n_in,cols_per_chunk,pass_cols,byte_path", [
    (32, 20, 10_000, 1792, 2048, False),  # N = 10,000 in 6 chunks: its last k-block holds 16
    (7, 70, 528, 256, 2048, False),  # n_in % 128 == 16 in the last of three chunks; one n-tile
    (1, 37, 1001, 512, 2048, True),  # odd n_in, one trial: the bytes stage
    (7, 45, 600, 512, 256, True),  # n_in % 32 != 0; chunks of three passes, the last short
    (33, 16, 272, 256, 2048, False),  # two trial groups, the second of one trial
    (5, 257, 2064, 1024, 512, False),  # a row past a strip; passes of four k-blocks
])
def test_int4_mm_tensor_core_lane_model_equals_plain(B, n_out, n_in, cols_per_chunk, pass_cols,
                                                     byte_path):
    # the tensor-core kernel's index mapping, modelled lane by lane, gives
    # int4_mm's plain result with its epilogue bit for bit, every load
    # inside its row's stride
    rng = np.random.default_rng(B + n_in)
    wq, wp, xq, _, rs, act = _int4_operands(rng, B, n_out, n_in)
    got = _int4_mma_model(wp.numpy(), xq, rs, act, cols_per_chunk, pass_cols, byte_path)
    ref = quant.int4_mm(wp, torch.as_tensor(xq), torch.as_tensor(rs), torch.as_tensor(act))
    np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("stride,wp_ptr,route", [
    (5008, 4096, "mma"),  # pack_int4 at N = 10,000
    (7168, 4096, "mma"),  # N = 14,336
    (5008, 4096 + 16, "mma"),
    (16, 4096, "mma"),
    (5000, 4096, "scalar"),  # tight rows at N = 10,000: every other row off 16 bytes
    (5008, 4096 + 8, "scalar"),  # packed rows only 8-byte aligned
    (5008, 4096 + 1, "scalar"),  # a view one byte into its buffer
    (520, 4096 + 4, "scalar"),
])
def test_int4_mm_route(stride, wp_ptr, route):
    # int4_mm's instance is a pure function of the packed rows' stride and
    # address: the tensor cores where every row starts 16-byte aligned
    assert quant.int4_mm_route(stride, wp_ptr) == route


@pytest.mark.parametrize("n_in", [1, 31, 10_000, 14_336])
def test_pack_int4_output_takes_the_tensor_cores(n_in):
    wp = quant.pack_int4(torch.zeros((3, n_in), dtype=torch.int8))
    assert wp.shape[1] == quant.int4_stride(n_in)
    for route in (quant.int4_mm_route, quant.int4_mm_t_route):
        assert route(wp.shape[1], wp.data_ptr()) == "mma"
        assert route(wp.shape[1], wp.data_ptr() + 1) == "scalar"


# A numpy model of int4_mm_t's tensor-core instance (mmas8::cols_t_mma_kernel
# with 4 packed bytes a lane, csrc/mma_s8.cuh), every warp of every strip at
# once: the chunks of rows (one cluster) and their passes; the stage of vq
# (16-byte copies, each inside its row of vq, or bytes); the 4 packed bytes
# (columns 8g..8g+7 of the warp's 64) of rows 8t..8t+7 of a k-step that lane
# (g, t) loads, read from the packed buffer as the card reads it, so that a
# load past its row's stride would take the next row's bytes, and zero
# weights (nibbles of 8) where it loads nothing; transpose4 and the nibble
# unpack into the A registers (column 8g + 2u + h is row g + 8h of m-tile
# u); the staged bytes of trial 8nt + g at rows 8t..8t+7 as the B
# registers; the PTX ISA's m16n8k32 fragment layouts; and the C fragments'
# (trial, column) in the sums' buffer that the cluster adds up.
_QT_WARPS, _QT_STEP, _QT_PASS_ROWS = 4, 32, 1024


def _transpose4(r0, r1, r2, r3):
    """Word c of the result holds byte c of the words r0..r3."""
    lo01, hi01 = _byte_perm(r0, r1, 0x5140), _byte_perm(r0, r1, 0x7362)
    lo23, hi23 = _byte_perm(r2, r3, 0x5140), _byte_perm(r2, r3, 0x7362)
    return [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
            _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]


def _int4_mma_t_model(wp, vq, act, n_in, rows_per_chunk, pass_rows=_QT_PASS_ROWS,
                      warps=_QT_WARPS):
    n_out, stride = wp.shape
    n_rows = vq.shape[0]
    assert stride % 16 == 0 and rows_per_chunk % _QT_STEP == 0
    vec_stage = n_out % 16 == 0  # the stage by 16-byte copies
    flat = np.ascontiguousarray(wp).reshape(-1)
    n_warps = -(-n_in // (64 * warps)) * warps  # every warp of every strip
    jw = 64 * np.arange(n_warps)[:, None]  # (warps, 1): the warp's first column
    col_ok = jw + 8 * _G < n_in  # (warps, 32): the lane loads
    off = (jw + 8 * _G) // 2  # its first byte of a row
    assert np.all(off[col_ok] + 4 <= stride)  # its 4 bytes never reach the next row
    acc = np.zeros((n_rows, 64 * n_warps), np.int64)  # the sum over chunks (the cluster's reduce)
    for b0 in range(0, n_rows, 32):
        nb = min(32, n_rows - b0)
        ntiles = (nb + 7) // 8
        for rp, prows in _int4_t_passes(n_out, rows_per_chunk, pass_rows):
            steps = -(-prows // _QT_STEP)
            if vec_stage:  # whole 16-byte copies, each inside its row of vq
                assert prows % 16 == 0 and rp + prows <= n_out
            stage = np.zeros((32, steps * _QT_STEP), np.int8)
            stage[:nb, :prows] = vq[b0:b0 + nb, rp:rp + prows]
            c = np.zeros((4, 4, 4) + col_ok.shape, np.int64)  # u, nt, i, warp, lane
            for s in range(steps):
                words = []  # rows 8t + r of the step at the lane's 4 bytes
                for r in range(8):
                    k = s * _QT_STEP + 8 * _T + r
                    ok = col_ok & (k < prows)
                    u = np.full(col_ok.shape, 0x88888888, np.uint32)
                    start = ((rp + k) * stride + off)[ok]
                    u[ok] = _words(flat[start[:, None] + np.arange(4)]).reshape(-1)
                    words.append(u)
                a, b = _transpose4(*words[:4]), _transpose4(*words[4:])
                lo = [_nibbles(a[q >> 1], 4 * (q & 1)) for q in range(8)]  # rows 8t..8t+3
                hi = [_nibbles(b[q >> 1], 4 * (q & 1)) for q in range(8)]  # rows 8t+4..8t+7
                for nt in range(ntiles):
                    bv = stage[8 * nt + _G[:, None], s * _QT_STEP + 8 * _T[:, None] + np.arange(8)]
                    bx, by = _words(bv[:, :4]).reshape(-1), _words(bv[:, 4:]).reshape(-1)
                    for u in range(4):
                        d = _mma_m16n8k32((lo[2 * u], lo[2 * u + 1], hi[2 * u], hi[2 * u + 1]),
                                          (bx, by))
                        for i in range(4):
                            c[u, nt, i] += d[i]
            red = np.zeros((n_warps, 32, 64), np.int64)  # [warp][trial][column of the warp]
            for u, nt, i in np.ndindex(4, 4, 4):
                red[:, 8 * nt + 2 * _T + (i & 1), 8 * _G + 2 * u + (i >> 1)] = c[u, nt, i]
            acc[b0:b0 + nb] += red[:, :nb].transpose(1, 0, 2).reshape(nb, -1)
    return acc[:, :n_in].astype(np.float32) * act[:, None]


def _int4_t_passes(n_out, rows_per_chunk, pass_rows):
    """(first row, rows) of every pass of every chunk of rows."""
    for r0 in range(0, n_out, rows_per_chunk):
        rows = min(n_out, r0 + rows_per_chunk) - r0
        for p0 in range(0, rows, pass_rows):
            yield r0 + p0, min(pass_rows, rows - p0)


@pytest.mark.parametrize("B,n_out,n_in,rows_per_chunk,pass_rows", [
    # N = 10,000's last strip (16 columns: two lane groups of its first warp
    # load) and its last two chunks of rows (8 chunks of 1,280 at N =
    # 10,000, each in passes of 1,024; the last chunk's 1,040 rows end in a
    # pass of one k-step of 16 rows)
    (32, 2320, 10_000, 1280, 1024),
    (7, 70, 136, 64, 1024),  # 7 trials pad one n-tile; the byte stage; a short last k-step
    (5, 96, 1001, 64, 1024),  # odd n_in: its last byte holds one column; 5 trials
    (33, 45, 264, 32, 1024),  # two trial groups, the second of one trial; the byte stage
    (9, 150, 72, 128, 64),  # chunks of two passes, the last pass of a chunk short
    (3, 1, 33, 32, 1024),  # one row of W
])
def test_int4_mm_t_tensor_core_lane_model_equals_plain(B, n_out, n_in, rows_per_chunk,
                                                       pass_rows):
    # the tensor-core kernel's index mapping, modelled lane by lane, gives
    # int4_mm_t's plain result with its epilogue bit for bit, every load
    # inside its row's stride
    rng = np.random.default_rng(B + n_out + n_in)
    wq, wp, _, vq, _, act = _int4_operands(rng, B, n_out, n_in)
    got = _int4_mma_t_model(wp.numpy(), vq, act, n_in, rows_per_chunk, pass_rows)
    ref = quant.int4_mm_t(wp, torch.as_tensor(vq), torch.as_tensor(act), n_in)
    np.testing.assert_array_equal(got, ref.numpy())
    exact = (vq.astype(np.float64) @ wq.astype(np.float64)).astype(np.float32) * act[:, None]
    np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("stride,wp_ptr,route", [
    (5008, 4096, "mma"),  # pack_int4 at N = 10,000
    (7168, 4096, "mma"),  # N = 14,336
    (5008, 4096 + 32, "mma"),
    (16, 4096, "mma"),
    (5000, 4096, "scalar"),  # tight rows at N = 10,000: every other row off 16 bytes
    (5008, 4096 + 8, "scalar"),  # packed rows only 8-byte aligned
    (5008, 4096 + 2, "scalar"),
    (4, 4096, "scalar"),
])
def test_int4_mm_t_route(stride, wp_ptr, route):
    # int4_mm_t's instance is a pure function of the packed rows' stride and
    # address: the tensor cores where every row's 4-byte loads lie inside a
    # 16-byte-rounded row, as int4_mm's
    assert quant.int4_mm_t_route(stride, wp_ptr) == route


def test_nibble_unpack_by_add_and_xor_is_the_signed_subtraction():
    # lo_nibbles/hi_nibbles (csrc/int4_matvec.cu) take n - 8 of each nibble
    # as ((n + 0x78) ^ 0x80) per byte, which the lane models above share:
    # every nibble value in every byte of a word becomes the signed byte
    # n - 8, and the other nibble of the byte does not leak in
    n = np.arange(16)
    cols = np.stack([n, n[::-1], (n + 5) % 16, (n + 11) % 16], axis=1)  # (16, 4) nibbles
    other = (cols * 7 + 3) % 16  # the byte's other nibble
    for shift in (0, 4):
        packed = (cols << shift) | (other << (4 - shift))
        words = _pack_bytes(packed)
        np.testing.assert_array_equal(_sbytes(_nibbles(words, shift)), cols - 8)



# A numpy schedule model of the tiled float32 B-row QIF step
# (qif_sfa_rows_tiled_kernel; rowtile::block_sums in csrc/rows_tiled.cuh at
# qif_sfa_step.cu's QifTile geometry, read from the source): every block
# (strip of kRows rows x group of 32 trials) at once; each thread's 16-byte
# copies of a chunk into the ring slot c % kStages, started kStages - 1
# chunks ahead as the kernel starts them, read from the flat W and state
# buffers as the card reads them (so that a copy past a row would take the
# next row's values) and counted; the slot a chunk is copied into is never
# one still to be read; each lane's kR x kT micro-tile of its warp's K part,
# one fmaf per input in the kernel's order (emulated in float64, so within
# an ulp of the card's single rounding); the K parts added in order; the
# epilogue in float32.
_CSRC = pathlib.Path(__file__).resolve().parents[1] / "rectipy_tpu_torch" / "csrc"


def _qif_tile():
    """(kR, kT, kRowTiles, kKSplit, kChunk, kStages) of QifTile."""
    m = re.search(r"using QifTile = rowtile::Geometry<([^>]*)>;",
                  (_CSRC / "qif_sfa_step.cu").read_text())
    return tuple(int(v) for v in m.group(1).split(","))


def _fmaf(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _tiled_sums(W, sbuf, s_off, ld_s, B, geometry):
    """s_in (B, n) of the tiled kernel on W and the s rows of the flat
    buffer sbuf (row b at s_off + b * ld_s); asserts its reads."""
    R, T, row_tiles, ksplit, chunk, stages = geometry
    tg_n = 32 // T
    rg_n = 32 // tg_n
    rows = rg_n * R * row_tiles  # of a strip
    warps, quads = row_tiles * ksplit, chunk // 4
    threads, stage_rows = 32 * warps, rows + 32
    copies = -(-stage_rows * quads // threads)
    n = W.shape[0]
    flat = np.ascontiguousarray(W, np.float32).reshape(-1)
    reads = np.zeros(n * n, np.int64)
    chunks, strips = -(-n // chunk), -(-n // rows)
    # each thread's copies of a chunk: staged rows tid / quads + q threads /
    # quads at quad tid % quads; together every (row, quad) once
    tid = np.arange(threads)
    cr = (tid[:, None] // quads + np.arange(copies) * (threads // quads)).reshape(-1)
    cq = np.repeat(tid % quads, copies)
    keep = cr < stage_rows
    cr, cq = cr[keep], cq[keep]
    assert len(set(zip(cr.tolist(), cq.tolist()))) == len(cr) == stage_rows * quads
    four = np.arange(4)
    lane, warp = np.arange(32), np.arange(warps)
    tg, rg = lane % tg_n, lane // tg_n
    tile, part = warp % row_tiles, warp // row_tiles
    # the micro-tiles: lane l of warp w sums rows r_idx[w, l, i] of its strip
    # for trials tg + tg_n j (staged rows rows + trial)
    r_idx = tile[:, None, None] * rg_n * R + rg[None, :, None] + rg_n * np.arange(R)
    t_idx = tg[:, None] + tg_n * np.arange(T)
    out = np.zeros((B, n), np.float32)
    for b0 in range(0, B, 32):
        nb = min(32, B - b0)
        ring = np.full((stages, strips, stage_rows, chunk + 4), np.nan, np.float32)
        pending = []

        def fetch(c):  # chunk c of every strip into slot c % stages
            if c >= chunks:
                return
            assert c % stages not in [q % stages for q in pending]  # a chunk still to be read
            k = c * chunk + 4 * cq
            for st in range(strips):
                dst = ring[c % stages, st]
                row = st * rows + cr
                w_row = cr < rows
                ok = np.where(w_row, row < n, cr - rows < nb) & (k < n)
                dst[cr[~ok, None], 4 * cq[~ok, None] + four] = 0.0  # zeros, no read
                assert np.all(k[ok] + 4 <= n)  # inside its row
                src = np.where(w_row, row * n + k, s_off + (b0 + cr - rows) * ld_s + k)
                wsel, ssel = ok & w_row, ok & ~w_row
                assert np.all(src[wsel] + 4 <= n * n)  # inside W
                np.add.at(reads, src[wsel, None] + four, 1)
                dst[cr[wsel, None], 4 * cq[wsel, None] + four] = flat[src[wsel, None] + four]
                dst[cr[ssel, None], 4 * cq[ssel, None] + four] = sbuf[src[ssel, None] + four]
            pending.append(c)

        for c in range(stages - 1):
            fetch(c)
        acc = np.zeros((strips, warps, 32, R, T), np.float32)
        for c in range(chunks):
            pending.remove(c)
            fetch(c + stages - 1)  # after the chunk's barrier: into chunk c - 1's slot
            st = ring[c % stages]
            for k4 in range(0, chunk // ksplit, 4):
                ks = (part * (chunk // ksplit) + k4)[:, None, None, None] + four  # (W, 1, 1, 4)
                a = st[:, r_idx[..., None], ks]  # (strips, W, 32, R, 4)
                b = st[:, rows + t_idx[None, :, :, None], ks]  # (strips, W, 32, T, 4)
                for comp in range(4):  # inputs k .. k + 3 in turn
                    acc = _fmaf(a[..., None, comp], b[:, :, :, None, :, comp], acc)
        assert np.isfinite(acc).all()  # no pad, no unstaged slot was read
        parts = np.zeros((ksplit, strips, 32, rows), np.float32)  # [part][strip][trial][row]
        for w in warp:
            parts[part[w]][:, np.broadcast_to(t_idx[:, None, :], (32, R, T)),
                           np.broadcast_to(r_idx[w][:, :, None], (32, R, T))] = acc[:, w]
        sums = parts[0]
        for q in range(1, ksplit):  # the K parts in order
            sums = sums + parts[q]
        out[b0:b0 + nb] = sums.transpose(1, 0, 2).reshape(32, strips * rows)[:nb, :n]
    np.testing.assert_array_equal(reads, -(-B // 32))  # every W element once per group
    return out


def _tiled_step(W, y, eta, inp, s_shared, p, geometry):
    """The kernel's (B, 3, n) output on states y (B, 3n) (v | s | x rows of
    one buffer; s_shared: one s row read by every trial, ld 0)."""
    B, n = y.shape[0], W.shape[0]
    flat_y = np.ascontiguousarray(y, np.float32).reshape(-1)
    s_off, ld_s = (n, 0) if s_shared else (n, 3 * n)
    s_in = _tiled_sums(W, flat_y, s_off, ld_s, B, geometry)
    v, x = y[:, :n], y[:, 2 * n:]
    s = np.broadcast_to(y[:1, n:2 * n], (B, n)) if s_shared else y[:, n:2 * n]
    f = np.float32
    reset = (v - f(p["thresh"]) >= 0).astype(f)
    spikes = reset * f(1.0 / p["dt"])
    dv = (v * v + (eta - x) + inp) * f(1.0 / p["tau"]) + f(p["k"]) * s_in
    ds = -s * f(1.0 / p["tau_s"]) + spikes
    dx = -x * f(1.0 / p["tau_x"]) + f(p["alpha"]) * spikes
    dt = f(p["dt"])
    return np.stack([(v + dt * dv) * (1 - reset) + reset * f(p["v_reset"]), s + dt * ds,
                     x + dt * dx], axis=1)


_TILED_PARAMS = dict(dt=1e-4, tau=1.0, tau_s=1.0, tau_x=10.0, k=15.0, alpha=0.05, thresh=100.0,
                     v_reset=-100.0)
_TILED_TOL = {"reset": (1e-5, 1e-4), "coupling": (1e-5, 1e-6)}  # chip_smoke.py's TOL


@pytest.mark.parametrize("B,n,s_shared,case", [
    (32, 172, False, "reset"),  # 3 strips, the last of 12 rows; 2 chunks, the last of 44 inputs
    (32, 172, False, "coupling"),
    (5, 300, True, "coupling"),  # 5 trials read one shared s row (ld 0); 4 strips, 3 chunks
    (33, 300, False, "reset"),  # two trial groups, the second of one trial
    (7, 84, False, "coupling"),  # one strip past its last row by 76 rows
])
def test_tiled_rows_schedule_model_matches_plain_and_jax(B, n, s_shared, case):
    # the tiled f32 B-row kernel's schedule, modelled block by block, reads
    # every W element once per trial group and never past a row or W, and
    # its float32 sums in the kernel's order give the plain step and JAX's
    # vmap of the Pallas kernel (interpret mode) within chip_smoke.py's TOL,
    # with equal reset masks; in the coupling case TOL sees a lost eighth
    rng = np.random.default_rng(B + n)
    p = dict(_TILED_PARAMS, k=1.0 / _TILED_PARAMS["dt"]) if case == "coupling" else _TILED_PARAMS
    if case == "coupling":
        W = rng.random((n, n))
        W /= W.sum(axis=1, keepdims=True)
        y = np.concatenate([rng.normal(size=(B, n)) * 1e-3, rng.random((B, n)),
                            rng.random((B, n)) * 1e-3], axis=1)
        eta, inp = rng.normal(size=(B, n)) * 1e-3, rng.normal(size=(B, n)) * 1e-3
    else:
        W = (rng.random((n, n)) < 0.1) * (1.0 / (0.1 * n))
        y = np.concatenate([rng.normal(size=(B, n)) * 80.0, rng.random((B, n)),
                            rng.random((B, n))], axis=1)
        eta, inp = rng.normal(size=(B, n)), rng.normal(size=(B, n))
    W, y, eta, inp = (a.astype(np.float32) for a in (W, y, eta, inp))
    got = _tiled_step(W, y, eta, inp, s_shared, p, _qif_tile())

    v, s, x = y[:, :n], (y[0, n:2 * n] if s_shared else y[:, n:2 * n]), y[:, 2 * n:]
    tv, ts, tx, te, ti = (torch.as_tensor(np.ascontiguousarray(a)) for a in (v, s, x, eta, inp))
    ref = torch.stack(qif_sfa_reference_step(tv, ts, tx, torch.as_tensor(W), te, ti, **p),
                      dim=-2).numpy()
    rtol, atol = _TILED_TOL[case]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    mask = got[:, 0] == p["v_reset"]
    np.testing.assert_array_equal(mask, ref[:, 0] == p["v_reset"])
    assert mask.any() if case == "reset" else not mask.any()

    step = make_qif_sfa_pallas_step(n, tile=128, interpret=True, **p)
    jv, js, jx = jax.vmap(step, in_axes=(0, None if s_shared else 0, 0, None, 0, 0))(
        *(jnp.asarray(a) for a in (v, s, x)), pad_coupling(W, 128), jnp.asarray(eta),
        jnp.asarray(inp))
    jref = np.stack([np.asarray(jv), np.broadcast_to(np.asarray(js), (B, n)), np.asarray(jx)],
                    axis=1)
    np.testing.assert_allclose(got, jref, rtol=rtol, atol=atol)

    if case == "coupling":  # the tolerance fails a sum that lost every eighth input
        s_cut = np.array(s)
        s_cut[..., ::8] = 0.0
        cut = qif_sfa_reference_step(tv, torch.as_tensor(s_cut), tx, torch.as_tensor(W), te,
                                     ti, **p)[0].numpy()
        margin = (np.abs(cut - ref[:, 0]) / (atol + rtol * np.abs(ref[:, 0]))).min()
        assert margin > 1.0


def test_tiled_geometry_of_the_source():
    # the model's geometry is the kernel's: 80-row strips (125 blocks at
    # N = 10,000), a warp of 32 trials, whole 16-byte reads of every part
    R, T, row_tiles, ksplit, chunk, stages = _qif_tile()
    rows = (32 // (32 // T)) * R * row_tiles
    assert rows == 80 and -(-10_000 // rows) == 125
    assert 32 % T == 0 and chunk % 32 == 0 and (chunk // ksplit) % 4 == 0 and stages >= 2


# A schedule model of the tiled float32 B-row generic step
# (generic_fused_rows_tiled_kernel in csrc/generic_fused_step.cuh, at its
# GenericTile geometry, read from the source): _tiled_sums once per
# coupling, each on its own source and row stride (every W element read once
# per trial group, no read past a row or a W), its float32 sums through the
# plain tail (the plain step with identity couplings and the sums as its
# sources: an f32 product by the identity is exact).
def _generic_tile():
    """(kR, kT, kRowTiles, kKSplit, kChunk, kStages) of GenericTile."""
    m = re.search(r"using GenericTile = rowtile::Geometry<([^>]*)>;",
                  (_CSRC / "generic_fused_step.cuh").read_text())
    return tuple(int(v) for v in m.group(1).split(","))


def _tiled_smem(geometry):
    """(bytes of the ring, bytes of one coupling's [32][kRows] f32 sums)
    of the tiled kernel at ``geometry`` (rowtile::Geometry's kSmem)."""
    R, T, row_tiles, ksplit, chunk, stages = geometry
    tg_n = 32 // T
    rg_n = 32 // tg_n
    rows = rg_n * R * row_tiles
    ring = stages * (rows + 32) * (chunk + 4)
    parts = ksplit * 32 * (rows + (rg_n - rows) % 32)  # the parts' sums, over the ring
    return 4 * max(ring, parts), 4 * 32 * rows


def _model_operands(case, n, B, src, seed):
    """The step, per-coupling Ws, sources and what the kernel reads them
    from, drive, states and per-neuron rows of one B-row launch: trial b's
    rows are ``generic_inputs(node, seed + 1 + b)``'s (the coupling case for
    qif_sfa), the states strided rows of one (B, V*n) buffer.  ``src``:
    "state" (the source is the node's s, a row of that buffer, as a LIF
    node's is y[:, n:2n]), "shared" (the first source one row for every
    trial, ld 0; the others as "rows") or "rows" (each source the second
    half of (B, 2n) rows)."""
    rng = np.random.default_rng(seed)
    Ws = []
    for c in range(2):  # dense, row-normalised; the second negative
        W = rng.random((n, n))
        Ws.append((W / W.sum(axis=1, keepdims=True) * (1.0 if c == 0 else -0.5))
                  .astype(np.float32))
    _, node = generic_case_net(case, Ws[0], "cpu", seed=seed)
    coupling = case == "qif_sfa"
    step, _, _, _, vecs = generic_inputs(node, seed, coupling=coupling)
    K, V = len(step.targets), len(step.state_order)
    Ws = [torch.as_tensor(W) for W in Ws[:K]]
    rows = [generic_inputs(node, seed + 1 + b, coupling=coupling)[1:4] for b in range(B)]
    y = torch.stack([torch.cat(st) for _, _, st in rows])  # (B, V*n)
    states = list(y.reshape(B, V, n).unbind(1))
    drive = torch.stack([r[1] for r in rows])
    srcs, reads = [], []  # reads: (flat buffer, offset of trial 0's row, row stride)
    for c in range(K):
        if src == "state":
            v = next(i for i, q in enumerate(step.state_order) if q.endswith("/s"))
            srcs.append(states[v])
            reads.append((y.numpy().reshape(-1), v * n, V * n))
        elif src == "shared" and c == 0:
            srcs.append(rows[0][0][c])
            reads.append((srcs[-1].numpy(), 0, 0))
        else:
            buf = torch.cat([torch.as_tensor(rng.random((B, n)), dtype=torch.float32),
                             torch.stack([r[0][c] for r in rows])], dim=1)
            srcs.append(buf[:, n:])
            reads.append((buf.numpy().reshape(-1), n, 2 * n))
    return step, Ws, srcs, reads, drive, states, vecs


@pytest.mark.parametrize("case,B,n,src", [
    ("lif", 5, 84, "state"),  # one strip past its last row by 76 rows; one short chunk
    ("lif", 32, 300, "shared"),  # one source row for every trial (ld 0); 4 strips, 3 chunks
    ("two_couplings", 33, 172, "rows"),  # K = 2; two trial groups, the second of one trial
    ("two_couplings", 5, 172, "shared"),  # K = 2; 3 strips, the last of 12 rows; 2 chunks
    ("tanh_heun", 32, 172, "rows"),  # Heun's derivative mode
    ("qif_sfa", 33, 172, "state"),  # the coupling case: v' = s_in + O(1e-3)
])
def test_generic_tiled_rows_schedule_model_matches_plain(case, B, n, src):
    # the tiled f32 B-row generic kernel's schedule, modelled block by block
    # and coupling by coupling, reads every element of every W once per
    # trial group and never past a row or a W; its float32 sums through
    # the plain tail give the plain step within GENERIC_TOL, with equal
    # reset masks; in the coupling case the tolerance sees a lost eighth
    step, Ws, srcs, reads, drive, states, vecs = _model_operands(case, n, B, src, 16 + n)
    geometry = _generic_tile()
    sums = [torch.as_tensor(_tiled_sums(W.numpy(), flat, off, ld, B, geometry))
            for W, (flat, off, ld) in zip(Ws, reads)]
    eye = torch.eye(n)
    got = gf.generic_fused_rows_plain(step, sums, [eye] * len(Ws), drive, states, vecs)
    ref = gf.generic_fused_rows_plain(step, srcs, Ws, drive, states, vecs)
    tol = "coupling" if case == "qif_sfa" else "reset"
    resets = sum(check_generic(got[b], ref[b], step, tol)[1] for b in range(B))
    hard = any(h for _, _, h, _ in step.spike_specs) and not step.derivative
    assert (resets > 0) == (hard and tol == "reset")
    if tol == "coupling":
        for b in (0, B - 1):
            assert lost_eighth_margin(step, [srcs[0][b]], Ws, drive[b],
                                      [s[b].contiguous() for s in states], vecs, ref[b]) > 1.0
    if case == "lif" and src == "state":  # and JAX's generic kernel under vmap (interpret)
        template, kw = GENERIC_CASES[case]
        kw = dict(kw)
        node_vars = dict(kw.pop("node_vars"))
        node_vars[kw.pop("per_neuron")] = np.random.default_rng(16 + n).uniform(5.0, 15.0, n)
        jnet = JNetwork(kw.pop("dt"), dtype=jnp.float32)
        jnet.add_diffeq_node("pop", template.replace(T_, J), weights=Ws[0].numpy(),
                             node_vars=node_vars, **kw, **F32)
        jnet.compile()
        jnode = jnet.get_node("pop")
        j_attach(jnode, tile=128, interpret=True)
        V, n_pad = len(step.state_order), -(-n // 128) * 128
        y = np.stack([s.numpy() for s in states], axis=1)  # (B, V, n)
        y_pad = np.pad(y, ((0, 0), (0, 0), (0, n_pad - n))).reshape(B, V * n_pad)
        jy, _ = jax.vmap(jnode.make_step(), in_axes=(0, None, 0))(
            jnp.asarray(y_pad), jnode.args, jnp.asarray(drive.numpy()))
        jref = torch.as_tensor(np.asarray(jy).reshape(B, V, n_pad)[..., :n].copy())
        for b in range(B):
            check_generic(got[b], jref[b], step, tol)


def test_generic_tiled_geometry_of_the_source():
    # the generic kernel's geometry is read from its header: 80-row strips
    # (125 blocks at N = 10,000), whole 16-byte reads of every part; the
    # ring and the sums of up to generic_rows_route's K limit of couplings
    # fit a block's 227 KB of shared memory, one coupling more does not,
    # and the E/I circuit's two fit
    geometry = _generic_tile()
    R, T, row_tiles, ksplit, chunk, stages = geometry
    rows = (32 // (32 // T)) * R * row_tiles
    assert rows == 80 and -(-10_000 // rows) == 125
    assert 32 % T == 0 and chunk % 32 == 0 and (chunk // ksplit) % 4 == 0 and stages >= 2
    ring, per_coupling = _tiled_smem(geometry)
    assert per_coupling == 10_240 and ring == 177_408  # rows_tiled.cuh's kSmem at 3 x 128
    K = gf._TILED_MAX_K
    assert 2 <= K and ring + K * per_coupling <= 232_448 < ring + (K + 1) * per_coupling
