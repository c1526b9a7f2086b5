"""Inputs and checks that hold the port's kernels to their plain versions;
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` both use them.

The fused adam + requantize kernel: W', m', v' and scale must agree within
rtol ``ADAM_RTOL`` with an atol of ``ADAM_RTOL`` times each tensor's
largest entry (the plain version's kernels
may round a division by a host scalar through its reciprocal: an ulp of the
update, which is large against a W' that nearly cancels); wq must be equal
except where the plain W'/scale lies within 1e-4 of a .5 rounding boundary.

The quantization scales: rows on which a division by the reciprocal of 7
or of 127 parts from the true division (``reciprocal_rows``), and every
scale the port quantizes with, with its integers (``quant_scales``), to be
held bit for bit to the CPU's and to numpy's float32 division.

The B-row QIF step on one route of its C entry (``qif_rows_instance``):
the CUDA cores' f32 vector instance (``"vec"``), which no Python route
picks, is the tiled f32 kernel's yardstick.  The B-row generic step the
same way (``generic_rows_instance``), and the tiled kernel's probes.

The generic fused step: one node of each class and mode
(``GENERIC_CASES``), built through the public API with the kernel attached,
and inputs for one step of it (``generic_inputs``); ``check_generic`` holds
the kernel's rows to the plain version's (see ``GENERIC_TOL``).

The fused STDP update: ``STDP_CASES`` names every variant (hard, soft,
reward), layout (dense, blocks) and type (float32, float64, bfloat16);
``stdp_inputs`` makes random weights, traces, 0/1 spikes and, for blocks,
columns that repeat within a row, at shapes that leave ragged rows and
grids; ``STDP_CHECK_SHAPES`` adds shapes at the tile route's edges;
``stdp_routes`` lists the kernel's routes that the operands allow and
``check_stdp`` launches the kernel (on a route, when asked) and holds it
to the plain version bit for bit.

The tensor cores' int8 product: ``mma_m16n8k32`` is a numpy model of one
``mma.sync`` m16n8k32 s8 on the PTX ISA's fragment layouts, with
``sbytes`` and ``words`` between uint32 registers and their bytes; the
CPU tests' lane-by-lane models of the ``mma`` kernels are built on it.

A model axis of two on one card (``mesh_quant_turns``): NCCL takes one rank
a device, so two gloo ranks, two processes (``mesh_quant_rank``), put their
tensors on the one card and fit the quantized networks of
``MESH_QUANT_FITS`` on ``make_mesh(2, device_type="cuda")``, in turns with
the calling process's fits of the same networks without a mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import torch

from .ops.fused_opt import bias_corrections
from .ops.stdp import stdp_consts, stdp_update, stdp_update_plain, stdp_update_routes

__all__ = ["ADAM_KW", "ADAM_RTOL", "GENERIC_CASES", "GENERIC_TOL", "STDP_CASES",
           "STDP_CHECK_SHAPES", "adam_inputs", "check_adam_requant", "check_generic",
           "check_stdp", "generic_case_net", "generic_inputs", "stdp_inputs", "stdp_routes",
           "generic_rows_instance", "generic_rows_operands", "lost_eighth_margin",
           "mma_m16n8k32", "qif_rows_instance", "quant_scales", "reciprocal_rows", "sbytes",
           "words", "MESH_QUANT_FITS", "mesh_quant_fit", "mesh_quant_rank", "mesh_quant_turns",
           "qif_sharded_net", "qif_sharded_data"]

ADAM_RTOL = 1e-6
ADAM_KW = dict(b1=0.9, b2=0.999, eps=1e-8)


def adam_inputs(n_rows, n_cols, count, seed, device):
    """Adam inputs whose update is of order lr everywhere (m and v of the
    gradient's sign and square), so that it is over 1e3x the W' tolerance.
    Returns ``(w, m, v, g, bc1, bc2, lr)``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(lo, hi):
        return lo + (hi - lo) * torch.rand((n_rows, n_cols), generator=gen, device=device)

    w = torch.randn((n_rows, n_cols), generator=gen, device=device) * 0.01
    g = torch.randn((n_rows, n_cols), generator=gen, device=device)
    g = torch.where(g.abs() < 0.05, torch.full_like(g, 0.05), g)
    if count == 1:
        m, v = torch.zeros_like(w), torch.zeros_like(w)
    else:
        m, v = g * rand(0.5, 1.5), g * g * rand(0.5, 1.5)
    bc1, bc2 = bias_corrections(count, ADAM_KW["b1"], ADAM_KW["b2"])
    return w, m, v, g, bc1, bc2, 1e-2


def check_adam_requant(got, ref, w):
    """Hold the kernel's outputs ``got`` to the plain version's ``ref`` (both
    ``(w', m', v', wq, scale)``); returns (max relative error, entries at a
    rounding boundary, min update over the W' tolerance)."""
    rel = 0.0
    for a, b in zip(got[:3] + (got[4],), ref[:3] + (ref[4],)):
        atol = ADAM_RTOL * float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=ADAM_RTOL, atol=atol)
        rel = max(rel, float(((a - b).abs() / (atol + b.abs())).max()))
    ratio = ref[0] / ref[4][:, None]
    boundary = ((ratio - ratio.floor()) - 0.5).abs() < 1e-4
    differ = got[3] != ref[3]
    if bool((differ & ~boundary).any()):
        raise AssertionError("wq differs away from a rounding boundary")
    # the check's power: the update is far above the tolerance on W'
    tol = ADAM_RTOL * (float(ref[0].abs().max()) + ref[0].abs())
    margin = float(((ref[0] - w).abs() / tol).min())
    if margin < 1e3:
        raise AssertionError(f"the adam update is only {margin}x the W' tolerance")
    return rel, int(boundary.sum()), margin


# --------------------------------------------------------- quantization scales
def reciprocal_rows(rows: int = 256, n: int = 256, seed: int = 12) -> np.ndarray:
    """float32 ``(rows, n)`` values of magnitude U(0.1, 10) and random sign,
    among whose rows' largest magnitudes numpy finds some where the product
    by the float32 reciprocal of 7, and of 127, differs from the true
    division (asserted): where PyTorch's CUDA division by a Python scalar,
    which multiplies by the reciprocal, parts from the CPU's."""
    rng = np.random.default_rng(seed)
    w = (rng.uniform(0.1, 10.0, (rows, n)) * rng.choice([-1.0, 1.0], (rows, n))).astype(
        np.float32)
    amax = np.abs(w).max(axis=-1)
    for d in (7, 127):
        if not (amax * np.float32(1.0 / d) != amax / np.float32(d)).any():
            raise AssertionError(f"no row where the reciprocal of {d} parts from the division")
    return w


def quant_scales(w: torch.Tensor) -> dict:
    """Every quantization of the port on ``w``'s rows, on ``w``'s device:
    name -> (integers, scale) of ``quantize_rows``, ``quantize_rows_i4`` and
    ``quant_vec``, and ``(scale,)`` of the frozen coupling's source scale."""
    from .dsl.lower import _source_scale
    from .ops.quant import quant_vec, quantize_rows, quantize_rows_i4

    return {"quantize_rows": quantize_rows(w), "quantize_rows_i4": quantize_rows_i4(w),
            "quant_vec": quant_vec(w), "source_scale": (_source_scale(w),)}


# ----------------------------------------------------- tensor-core fragments
_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3  # the fragments' group and thread in group


def sbytes(u) -> np.ndarray:
    """uint32 words -> their 4 signed bytes each (little-endian), int64."""
    u = np.ascontiguousarray(np.asarray(u, np.uint32))
    return u.astype("<u4").view(np.int8).reshape(u.shape + (4,)).astype(np.int64)


def words(a) -> np.ndarray:
    """int8/uint8 array (..., 4k) -> uint32 words (..., k), little-endian."""
    return np.ascontiguousarray(a).view("<u4")


def mma_m16n8k32(a, b) -> list:
    """D = A B of the PTX fragments of ``mma.sync`` m16n8k32 s8: ``a`` four
    (..., 32) uint32 registers of the 16 x 32 row-major A, ``b`` two of the
    32 x 8 column-major B (the leading axes broadcast: a stack of warps);
    returns the four (..., 32) int64 registers of the 16 x 8 D."""
    lead = np.broadcast_shapes(*(np.shape(r)[:-1] for r in (*a, *b)))
    A, Bm = np.zeros(lead + (16, 32), np.int64), np.zeros(lead + (32, 8), np.int64)
    for reg, (m_off, k_off) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        A[..., (_G + m_off)[:, None], k_off + 4 * _T[:, None] + np.arange(4)] = sbytes(a[reg])
    for reg, k_off in enumerate((0, 16)):
        Bm[..., k_off + 4 * _T[:, None] + np.arange(4), _G[:, None]] = sbytes(b[reg])
    D = A @ Bm
    return [D[..., _G + 8 * (i >> 1), 2 * _T + (i & 1)] for i in range(4)]


# ---------------------------------------------------------------- generic step
def qif_rows_instance(route: str, W, v, s, x, eta, inp, p) -> torch.Tensor:
    """The B-row QIF step of ``ops.kernels.qif_sfa_rows_step``'s operands
    (``p``: its keyword parameters) through the C entry on ``route``
    (``ops.kernels._ROWS_ROUTES``), on the current CUDA stream; counts no
    launch.  A launch the entry refuses raises."""
    from .ops import kernels

    B, n = v.shape
    out = torch.empty((B, 3, n), dtype=torch.float32, device=v.device)
    lds = [t.stride(0) if t.dim() == 2 else 0 for t in (v, s, x, eta, inp)]
    err = kernels._rows_launch_fn()(
        W.data_ptr(), int(W.dtype == torch.bfloat16), kernels._ROWS_ROUTES[route], v.data_ptr(),
        s.data_ptr(), x.data_ptr(), eta.data_ptr(), inp.data_ptr(), *lds, out.data_ptr(), n, B,
        float(p["dt"]), 1.0 / p["dt"], 1.0 / p["tau"], 1.0 / p["tau_s"], 1.0 / p["tau_x"],
        float(p["k"]), float(p["alpha"]), float(p["thresh"]), float(p["v_reset"]),
        torch.cuda.current_stream(v.device).cuda_stream)
    if err:
        raise RuntimeError(f"qif_sfa_rows_launch ({route}): CUDA error {err}")
    return out


def generic_rows_instance(step, srcs, Ws, drive, states, vecs, route: str, probe: int = 0):
    """A callable that launches the B-row generic step of
    ``ops.generic_fused.generic_fused_rows``'s operands through the C entry
    on ``route`` (``ops.generic_fused._ROWS_ROUTES``; ``"vec"``: the CUDA
    cores' 16-byte loads, the tiled and tensor-core instances' yardstick) on
    the current CUDA stream, into one output, which it returns; counts no
    launch.  ``probe`` (``"tiled"`` only): one of ``csrc/rows_tiled.cuh``'s
    ``kProbe*`` instances instead, whose output is meaningless.  A launch
    the entry refuses raises."""
    import ctypes

    from .ops import generic_fused

    B, n = srcs[0].shape
    V = len(step.state_order)
    out = torch.empty((B, V, n), dtype=torch.float32, device=drive.device)
    per_trial = list(srcs) + [drive] + list(states)
    ptrs = ([W.data_ptr() for W in Ws] + [t.data_ptr() for t in per_trial]
            + [t.data_ptr() for t in vecs] + [out.data_ptr()])
    lds = [t.stride(0) if t.dim() == 2 else 0 for t in per_trial] + [V * n]
    scalars = list(step.scalars.values())
    head = ((ctypes.c_uint64 * len(ptrs))(*ptrs), (ctypes.c_longlong * len(lds))(*lds),
            (ctypes.c_double * max(len(scalars), 1))(*scalars), n, B)
    if probe:
        if route != "tiled":
            raise ValueError(f"the probes are the tiled kernel's, not route {route!r}'s")
        fn = generic_fused.build_generated("generic_fused_step", step.source).lib
        fn = fn.generic_fused_rows_tiled_probe_launch
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        args = head + (probe,)
    else:
        fn = generic_fused._rows_launch_fn(step.source)
        args = head + (int(Ws[0].dtype == torch.bfloat16), generic_fused._ROWS_ROUTES[route],
                       step.dt, step.thresh, step.reset_val)

    def launch():
        err = fn(*args, torch.cuda.current_stream(drive.device).cuda_stream)
        if err:
            raise RuntimeError(f"generic_fused_rows ({route}, probe {probe}): CUDA error {err}")
        return out

    return launch


_SPIKING = dict(input_var="I_ext", output_var="s", source_var="s", target_var="s_in")
# name -> (template, add_diffeq_node keywords); each with the generic kernel
GENERIC_CASES = {
    "qif_sfa": ("rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa", dict(
        _SPIKING, op="qif_sfa_op", spike_var="spike", spike_def="v", spike_threshold=1e2,
        spike_reset=-1e2, node_vars={"alpha": 0.05, "k": 15.0}, per_neuron="eta", dt=1e-4)),
    "lif": ("rectipy_tpu_torch.models.spiking_neurons.lif.lif", dict(
        _SPIKING, op="lif_op", spike_var="spike", reset_var="v", spike_threshold=10.0,
        spike_reset=-10.0, node_vars={"eta": 10.0, "tau_s": 5.0}, per_neuron="tau", dt=1e-2)),
    "qif_reset": ("rectipy_tpu_torch.models.spiking_neurons.qif.qif_reset", dict(
        _SPIKING, op="qif_reset_op", spike_var="spike", reset_var="reset", reset=False,
        spike_threshold=10.0, spike_reset=-10.0, node_vars={}, per_neuron="eta", dt=1e-3)),
    "ik": ("rectipy_tpu_torch.models.spiking_neurons.ik.ik", dict(
        _SPIKING, op="ik_op", spike_var=["spike"], reset_var=["v"], spike_threshold=40.0,
        spike_reset=-60.0, node_vars={}, per_neuron="eta", dt=1e-2)),
    "tanh_heun": ("rectipy_tpu_torch.models.rate_neurons.leaky_integrator.tanh", dict(
        input_var="li_op/I_ext", output_var="li_op/v", source_var="tanh_op/r",
        target_var="li_op/r_in", integrator="heun", node_vars={"all/li_op/eta": 1.0},
        per_neuron="all/li_op/tau", dt=1e-2)),
    # a second coupling into the input variable itself, as a circuit
    "two_couplings": ("rectipy_tpu_torch.models.rate_neurons.leaky_integrator.tanh", dict(
        input_var="li_op/I_ext", output_var="li_op/v", node_vars={}, per_neuron=None,
        dt=1e-2)),
}
# Kernel against plain version on the card, (rtol, atol relative to each
# row's largest entry).  The f32 sums run in another order over n terms, and
# nvcc contracts a*b + c in the tail and the update into FMAs where the plain
# version rounds the product first: differences of a few ulps of the
# intermediate values, so 1e-5 of each row's scale.  The coupling case
# (qif_sfa with k = 1/dt and v, x, eta, drive of order 1e-3, so that
# v' = s_in + O(1e-3) with s_in ~ 0.5) takes the QIF kernel's (1e-5, 1e-6):
# about 6e-6 on s_in, far below a lost eighth of the row sum
# (``lost_eighth_margin``).
GENERIC_TOL = {"reset": (1e-5, 1e-5), "coupling": (1e-5, 1e-6)}


def generic_case_net(case: str, W: np.ndarray, device, seed: int = 0,
                     coupling_dtype: str = "float32", attach: bool = True):
    """The network of ``GENERIC_CASES[case]`` at ``n = len(W)`` on ``device``
    (coupling ``W`` in ``coupling_dtype``; per-neuron values of one
    parameter from ``seed``), with the generic kernel attached unless
    ``attach=False``; returns ``(net, node)``."""
    from .network import Network
    from .ops.generic_fused import attach_generic_fused_step

    template, kw = GENERIC_CASES[case]
    kw = dict(kw)
    n = W.shape[0]
    rng = np.random.default_rng(seed)
    per_neuron, node_vars = kw.pop("per_neuron"), dict(kw.pop("node_vars"))
    if per_neuron is not None:
        node_vars[per_neuron] = rng.uniform(5.0, 15.0, n)
    net = Network(kw.pop("dt"), device=device)
    if case == "two_couplings":
        from .dsl.parser import CircuitTemplate, NodeTemplate

        tmpl = NodeTemplate.from_yaml(template)
        circuit = CircuitTemplate("c", {f"p{i}": tmpl for i in range(n)})
        circuit.add_edges_from_matrix("tanh_op/r", "li_op/r_in", weight=W)
        circuit.add_edges_from_matrix("tanh_op/r", "li_op/I_ext", weight=W)
        net.add_diffeq_node("pop", circuit, node_vars=node_vars, coupling_dtype=coupling_dtype,
                            **kw)
    else:
        net.add_diffeq_node("pop", template, weights=W, node_vars=node_vars,
                            coupling_dtype=coupling_dtype, **kw)
    net.compile()
    node = net.get_node("pop")
    if attach:
        attach_generic_fused_step(node)
    return net, node


def generic_inputs(node, seed: int, coupling: bool = False):
    """``(step, srcs, drive, states, vecs)`` for one kernel launch of the
    node's attached step.  By default every spike-tested state spreads
    across its threshold (the reset case); ``coupling=True`` (qif_sfa only)
    gives the coupling case of ``GENERIC_TOL``."""
    step = node._fused_cfg["step"]
    n, dev = node._fused_cfg["n"], node.device
    rng = np.random.default_rng(seed)

    def row(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev).contiguous()

    spike_rows = {vidx for _, vidx, _, _ in step.spike_specs}
    spread = 0.5 * max(abs(step.thresh - step.reset_val), 1.0)
    states = [row(step.thresh + rng.normal(size=n) * spread) if v in spike_rows
              else row(rng.random(n)) for v in range(len(step.state_order))]
    vecs = [node.args[f"__row_{k}__"] for k in step.vec_keys]
    srcs = [row(rng.random(n)) for _ in step.targets]
    drive = row(rng.normal(size=n))
    if coupling:
        small = {"qif_sfa_op/v", "qif_sfa_op/x"}
        states = [row(rng.normal(size=n) * 1e-3) if q in small else st
                  for q, st in zip(step.state_order, states)]
        vecs = [row(rng.normal(size=n) * 1e-3) if k == "qif_sfa_op/eta" else r
                for k, r in zip(step.vec_keys, vecs)]
        drive = row(rng.normal(size=n) * 1e-3)
        step = dataclasses.replace(step, scalars={**step.scalars, "qif_sfa_op/k": 1.0 / step.dt})
    return step, srcs, drive, states, vecs


def generic_rows_operands(step, n: int, B: int, rng, device) -> tuple:
    """B trials' operands of one B-row generic step at width n, as
    ``generic_inputs`` draws one trial's (spike-tested states spread across
    the threshold, U(0, 1) sources and other states, normal drive;
    per-neuron rows U(5, 15), as ``generic_case_net``'s) from the numpy
    generator ``rng``: the states as strided rows of one (B, V*n) buffer,
    as the node's state is.  Returns (srcs, drive, states, vecs)."""
    def on(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    V = len(step.state_order)
    spike_rows = {vidx for _, vidx, _, _ in step.spike_specs}
    spread = 0.5 * max(abs(step.thresh - step.reset_val), 1.0)
    y = np.concatenate([step.thresh + rng.normal(size=(B, n)) * spread if v in spike_rows
                        else rng.random((B, n)) for v in range(V)], axis=1)
    states = list(on(y).reshape(B, V, n).unbind(1))
    srcs = [on(rng.random((B, n))) for _ in step.targets]
    vecs = [on(rng.uniform(5.0, 15.0, n)) for _ in step.vec_keys]
    return srcs, on(rng.normal(size=(B, n))), states, vecs


def check_generic(got, ref, step, case: str = "reset"):
    """Hold the kernel's rows ``got`` to the plain version's ``ref`` under
    ``GENERIC_TOL[case]``; hard-reset masks must be equal.  Returns (max abs
    error, number of hard-reset neurons)."""
    rtol, atol = GENERIC_TOL[case]
    for v in range(ref.shape[0]):
        row_atol = atol if case == "coupling" else atol * float(ref[v].abs().max())
        torch.testing.assert_close(got[v], ref[v], rtol=rtol, atol=row_atol)
    resets = 0
    if not step.derivative:
        for _, vidx, hard, _ in step.spike_specs:
            if hard:
                mask, ref_mask = got[vidx] == step.reset_val, ref[vidx] == step.reset_val
                if not torch.equal(mask, ref_mask):
                    raise AssertionError("the kernel's reset mask differs from the plain version's")
                resets += int(ref_mask.sum())
    return float((got - ref).abs().max()), resets


def lost_eighth_margin(step, srcs, Ws, drive, states, vecs, ref) -> float:
    """The coupling check's power: the plain step with every eighth term of
    each row sum lost (as a kernel that dropped one of its eight warps'
    partial sums would lose it), over the coupling tolerance on the
    spike-tested row; above 1 on every row means the check would fail it."""
    from .ops.generic_fused import generic_fused_step_plain

    rtol, atol = GENERIC_TOL["coupling"]
    cut_srcs = [s.clone() for s in srcs]
    for s in cut_srcs:
        s[::8] = 0.0
    cut = generic_fused_step_plain(step, cut_srcs, Ws, drive, states, vecs)
    v = step.spike_specs[0][1]
    return float(((cut[v] - ref[v]).abs() / (atol + rtol * ref[v].abs())).min())


STDP_CASES = [(mode, layout, dtype) for mode in ("hard", "soft", "reward")
              for layout in ("dense", "blocks") for dtype in ("float32", "float64", "bfloat16")]
# dense: 37 rows of 1,003 (rows longer than a thread block, not a multiple
# of it); blocks: 5 block rows of 3 blocks of 20 x 20 (rows shorter than a
# thread block), columns drawn with repeats
STDP_SHAPES = {"dense": (37, 1003), "blocks": (5, 3, 20, 8)}
# the shapes every route is held to the plain version at: dense rows of
# 1,003 (route "tile" at no type), 1,004 (float32 and float64, not
# bfloat16), 1,000 (every type) and the path's 10,000; blocks of 20 (not
# bfloat16), 24, 128 and the path's 512, columns drawn with repeats
STDP_CHECK_SHAPES = {"dense": [(37, 1003), (37, 1004), (37, 1000), (3, 10_000)],
                     "blocks": [(5, 3, 20, 8), (5, 3, 24, 2), (3, 4, 128, 3), (2, 4, 512, 6)]}


def stdp_inputs(layout: str, dtype: str, seed: int, device, shape=None) -> dict:
    """Random operands of one STDP update: ``W`` within the bounds [0, 0.5],
    decayed traces in [0, 2), 0/1 spikes (30%), for reward mode ``E``
    (normal, 1e-2) and ``r`` (0-dim), for blocks ``cols`` (int64, with
    repeats); ``c`` the constants (a_plus 0.01, a_minus 0.012, d_e 0.95).
    ``shape``: dense ``(n_out, n_in)`` or blocks ``(n_br, cb, bs, nb_in)``."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    shape = shape or STDP_SHAPES[layout]
    if layout == "dense":
        n_out, n_in = shape
        w_shape, cols = (n_out, n_in), None
    else:
        n_br, cb, bs, nb_in = shape
        n_out, n_in, w_shape = n_br * bs, nb_in * bs, (n_br, cb, bs, bs)
        cols = torch.as_tensor(rng.integers(0, nb_in, size=(n_br, cb)), device=device)

    def on(a):
        return torch.as_tensor(a, device=device).to(dt)

    return dict(W=on(rng.uniform(0.0, 0.5, w_shape)), x_pre=on(rng.random(n_in) * 2.0),
                x_post=on(rng.random(n_out) * 2.0), spk_pre=on(rng.random(n_in) < 0.3),
                spk_post=on(rng.random(n_out) < 0.3), cols=cols,
                E=on(rng.normal(size=w_shape) * 1e-2), r=on(rng.normal()),
                c=stdp_consts(dt, device, 0.01, 0.012, 0.0, 0.5, d_e=0.95))


def stdp_routes(mode: str, ops: dict) -> tuple:
    """The kernel's routes that ``stdp_inputs``' operands allow in ``mode``."""
    W = ops["W"]
    streamed = (W, ops["x_pre"], ops["spk_pre"]) + ((ops["E"],) if mode == "reward" else ())
    return stdp_update_routes(W.dtype, W.shape[-1], [t.data_ptr() for t in streamed])


def check_stdp(mode: str, ops: dict, route: str = None) -> dict:
    """Launch the kernel on ``stdp_inputs``' operands (on ``route``, default
    the wrapper's choice) and hold ``W'`` (and ``E'``) to the plain version
    bit for bit; returns ``{"launches", "tile_launches", "moved",
    "max_abs_err"}`` (``moved``: entries the update changed)."""
    args = (ops["W"], ops["x_pre"], ops["x_post"], ops["spk_pre"], ops["spk_post"], ops["c"],
            mode == "soft", ops["cols"])
    E, r = (ops["E"], ops["r"]) if mode == "reward" else (None, None)
    before = stdp_update.launches, stdp_update.tile_launches
    got = stdp_update(*args, E, r, route=route)
    launches = stdp_update.launches - before[0]
    tile_launches = stdp_update.tile_launches - before[1]
    ref = stdp_update_plain(*args, E, r)
    err = 0.0
    for a, b in zip(got, ref):
        if b is None:
            continue
        if not torch.equal(a, b):
            raise AssertionError(f"stdp_update ({mode}, {b.dtype}, {tuple(b.shape)}) differs "
                                 f"from its plain version on {int((a != b).sum())} entries")
        err = max(err, float((a.double() - b.double()).abs().max()))
    return {"launches": launches, "tile_launches": tile_launches,
            "moved": int((ref[0] != ops["W"]).sum()), "max_abs_err": err}


# ------------------------------------------------- two gloo ranks on one card
QIF = "rectipy_tpu_torch.models.spiking_neurons.qif.qif"
QIF_SFA = "rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa"
# the fits of a model axis of two on one card: (a) examples/qif_100k_sharded.py's
# training, (b) bench.py:331-370's N = 10,000 QIF network with an int4_master
# coupling and (c) its fit_bptt_batch, the trials on data 1 x model 2
MESH_QUANT_FITS = ("qif_sharded", "int4_fit_bptt", "int4_fit_bptt_batch")


def qif_sharded_net(n: int, bs: int = 512, fan_in: int = 1000, device=None,
                    dtype=torch.float32, ns=None):
    """``examples/qif_100k_sharded.py``'s training network (its ``QIF_TRAIN=1``
    part with ``QIF_COUPLING=int8_master``) at ``n`` neurons (a multiple of
    ``bs``): the block coupling of ``block_random_connectivity(n, n, fan_in,
    block_size=bs, seed=0)``, dt 1e-3, etas 100 + 20 N(0, 1) (seed 2), a
    one-channel drive through an ``(n, 1)`` edge and the per-neuron delays
    0-7 (seed 1) of its diagonal feedback gains (0.3), which train by
    gradient descent with the coupling.  ``ns``: what builds it in another
    package with this package's API (``net(dt)``, an empty
    ``FeedbackNetwork``; ``block_random_connectivity``; ``template``, its
    ``qif_sfa`` template); default: this package's, on ``device`` at
    ``dtype``."""
    if ns is None:
        from . import FeedbackNetwork, block_random_connectivity

        ns = SimpleNamespace(
            net=lambda dt: FeedbackNetwork(dt, dtype=dtype, device=device),
            block_random_connectivity=block_random_connectivity, template=QIF_SFA)
    A = ns.block_random_connectivity(n, n, fan_in, block_size=bs, seed=0)
    rng = np.random.default_rng(1)
    delays = rng.integers(0, 8, size=n)
    rng.normal(size=(n, 1))  # the input weights of the example's forward network
    etas = 100.0 + 20.0 * np.random.default_rng(2).standard_normal(n)
    net = ns.net(1e-3)
    net.add_func_node("inp", 1, activation_function="identity")
    net.add_diffeq_node("qif", ns.template, weights=A, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", spike_var="spike", spike_def="v",
                        op="qif_sfa_op", spike_threshold=1e2, spike_reset=-1e2,
                        node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/alpha": 0.05,
                                   "all/qif_sfa_op/k": 15.0},
                        coupling_dtype="int8_master", train_params=["weights"])
    net.add_edge("inp", "qif", weights=rng.normal(size=(n, 1)).astype(np.float32))
    net.add_edge("qif", "qif", weights=np.full(n, 0.3, dtype=np.float32), delays=delays,
                 feedback=True, train="gd")
    net.compile()
    return net


def qif_sharded_data(n: int, T: int) -> tuple:
    """The example's training drive (3.0 from step ``T // 4``) and targets,
    ``(T, 1)`` and ``(T, n)`` float32."""
    inp = np.zeros((T, 1), dtype=np.float32)
    inp[T // 4:, 0] = 3.0
    tgt = (0.05 + 0.01 * np.sin(np.linspace(0, 8 * np.pi, T)))[:, None].astype(np.float32)
    return inp, tgt * np.ones((1, n), dtype=np.float32)


def _bench_qif_net(n: int, T: int, device):
    """bench.py:331-370's network (QIF, dt 5e-3, 10% fan-in of 1 / (0.1 n),
    tan etas; seed 2) with an ``int4_master`` coupling, and the first ``T``
    steps of its drive and targets."""
    from . import Network

    rng = np.random.default_rng(2)
    W = (rng.random((n, n)) < 0.1) * (1.0 / (0.1 * n))
    etas = -5.0 + np.tan((np.pi / 2) * (2.0 * np.arange(1, n + 1) - n - 1) / (n + 1))
    inp, tgt = rng.normal(size=(500, n))[:T], rng.normal(size=(500, n))[:T]
    net = Network(5e-3, device=device)
    net.add_diffeq_node("qif", QIF, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="qif_op", spike_var="spike",
                        spike_def="v", spike_threshold=1e2, spike_reset=-1e2,
                        node_vars={"all/qif_op/eta": etas}, coupling_dtype="int4_master",
                        train_params=["weights"])
    net.compile()
    return net, inp, tgt


def mesh_quant_fit(name: str, sizes: dict, device, cache: dict = None):
    """``(net, fit, launches)`` of fit ``name`` of :data:`MESH_QUANT_FITS` at
    ``sizes`` (``qif_n``, ``qif_bs``, ``qif_fan``, ``qif_T``, ``epochs``,
    ``int4_n``, ``int4_T``, ``B``, ``B_T``): the network (built once; the
    two int4 fits share bench.py's network through ``cache``),
    ``fit(mesh)`` (the trained leaves set back to their start first; it
    returns the losses and the trained leaves) and the launch counts a fit
    must give, ``{"kernel.counter": count}`` (each rank's on a mesh)."""
    from .ops import quant

    epochs = sizes["epochs"]
    if name == "qif_sharded":
        n, T = sizes["qif_n"], sizes["qif_T"]
        net = qif_sharded_net(n, sizes["qif_bs"], sizes["qif_fan"], device)
        inp, tgt = (torch.as_tensor(a, device=device) for a in qif_sharded_data(n, T))

        def train(mesh):
            return net.fit_bptt([inp] * epochs, [tgt] * epochs, optimizer="adam", lr=1e-3,
                                verbose=False, fused_bptt=True, mesh=mesh)["epoch_loss"]

        leaves = {"weights": ("nodes", "qif", "weights"), "gains": ("edges", "qif->qif", "weights")}
        launches = {"block_int8_mv.launches": epochs * T, "block_int8_mv.mma_launches": epochs * T}
    else:
        n, T = sizes["int4_n"], (sizes["int4_T"] if name == "int4_fit_bptt" else sizes["B_T"])
        cache = {} if cache is None else cache
        if "bench" not in cache:
            cache["bench"] = _bench_qif_net(n, sizes["int4_T"], device)
        net, inp, tgt = cache["bench"]
        leaves = {"weights": ("nodes", "qif", "weights")}
        if name == "int4_fit_bptt":
            inp, tgt = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (inp, tgt))

            def train(mesh):
                return net.fit_bptt([inp] * epochs, [tgt] * epochs, optimizer="adam", lr=1e-4,
                                    verbose=False, mesh=mesh)["epoch_loss"]

            launches = {"int4_mv.launches": epochs * T, "int4_mv_t.launches": epochs * T}
        else:
            rng = np.random.default_rng(7)
            ins, tgts = (torch.as_tensor(rng.normal(size=(sizes["B"], T, n)).astype(np.float32),
                                         device=device) for _ in range(2))

            def train(mesh):
                return net.fit_bptt_batch(ins, tgts, n_epochs=1, optimizer="adam", lr=1e-4,
                                          verbose=False, mesh=mesh)["train_loss"]

            launches = {f"{k}.{c}": T for k in ("int4_mm", "int4_mm_t")
                        for c in ("launches", "mma_launches")}
    start = {key: net.parameters_pytree()[kind][label][k].clone()
             for key, (kind, label, k) in leaves.items()}

    def fit(mesh):
        tree = {"nodes": {}, "edges": {}}
        for key, (kind, label, k) in leaves.items():
            tree[kind].setdefault(label, {})[k] = start[key].clone()
        net._write_back(params=tree)
        for counter in launches:
            k, c = counter.split(".")
            setattr(getattr(quant, k), c, 0)
        loss = np.asarray(train(mesh), dtype=np.float64)
        pt = net.parameters_pytree()
        return {"loss": loss, **{key: pt[kind][label][k] for key, (kind, label, k)
                                 in leaves.items()}}

    return net, fit, launches


def _counts(launches: dict) -> dict:
    from .ops import quant

    return {c: getattr(getattr(quant, c.split(".")[0]), c.split(".")[1]) for c in launches}


def _fingerprint(t: torch.Tensor) -> list:
    """Two int64 sums of ``t``'s bits (plain and position-weighted): equal
    tensors give equal fingerprints, compared across processes."""
    bits = t.detach().contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    weights = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 8191 + 1
    return [int(bits.sum()), int((bits * weights).sum())]


def _wait(path: str, deadline: float) -> None:
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"waited for {path}")
        time.sleep(0.005)


def mesh_quant_rank(cfg_json: str) -> None:
    """One gloo rank of :func:`mesh_quant_turns` (a process of its own):
    joins the group of ``cfg["world"]`` ranks through the FileStore
    ``cfg["store"]``, makes ``make_mesh(world, device_type="cuda")`` with its
    tensors on the card, builds each fit's network, and for each turn waits
    for the caller's ``go_<fit>_<turn>`` file, fits on the mesh (both ranks
    start together) and writes ``<fit>_<turn>.r<rank>.json``: the losses,
    the fit's seconds, its launches, ``comm.tally()`` and the trained
    leaves' fingerprints; rank 0 also saves the last turn's trained leaves
    (``<fit>.pt``)."""
    import torch.distributed as dist

    import torch.fx.experimental.symbolic_shapes  # noqa: F401 (autograd.grad's first
    # call with grad_outputs imports it: seconds, here before the timed turns)

    from .parallel import comm, make_mesh

    cfg = json.loads(cfg_json)
    rank, d = cfg["rank"], cfg["dir"]
    cuda = cfg["device_type"] == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=cfg["world"],
                            store=dist.FileStore(cfg["store"], cfg["world"]),
                            timeout=timedelta(seconds=cfg["timeout"]))
    deadline = time.monotonic() + cfg["timeout"]
    try:
        mesh = make_mesh(cfg["world"], device_type=cfg["device_type"])
        cache = {}
        for name in cfg["fits"]:
            net, fit, launches = mesh_quant_fit(name, cfg["sizes"], dev, cache)
            launches = launches if cuda else {}  # the counters count CUDA launches
            for turn in range(cfg["turns"]):
                _wait(os.path.join(d, f"go_{name}_{turn}"), deadline)
                dist.barrier()
                comm.reset()
                sync()
                t0 = time.perf_counter()
                rec = fit(mesh)
                sync()
                seconds = time.perf_counter() - t0
                out = {"loss": rec["loss"].tolist(), "seconds": seconds,
                       "launches": _counts(launches), "tally": comm.tally(),
                       "fingerprints": {k: _fingerprint(v) for k, v in rec.items()
                                        if k != "loss"}}
                if rank == 0 and turn == cfg["turns"] - 1:
                    torch.save({k: v.cpu() for k, v in rec.items() if k != "loss"},
                               os.path.join(d, f"{name}.pt"))
                with open(os.path.join(d, f"{name}_{turn}.r{rank}.json"), "w") as f:
                    json.dump(out, f)
                del rec
            del net, fit
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()


def mesh_quant_turns(sizes: dict, tmp: str, fits=MESH_QUANT_FITS, turns: int = 2,
                     world: int = 2, timeout: float = 600.0, tol: dict = None,
                     device_type: str = "cuda") -> dict:
    """The fits of :data:`MESH_QUANT_FITS` on a model axis of ``world``
    gloo ranks on the one card, in turns with this process's fits of the
    same networks without a mesh (plain, mesh, plain, mesh for two turns).
    Each rank runs :func:`mesh_quant_rank` in a process of its own (started
    first: its imports and CUDA context overlap this process's builds);
    ``tmp`` holds the store and the records.  ``device_type="cpu"``
    rehearses the same turns on CPU tensors (no card).

    Checks, raising ``AssertionError``: every turn's launches equal the
    counts a fit must give (this process's, and each rank's); the ranks'
    losses and trained leaves identical, and each turn's equal to the first
    turn's (as this process's); the mesh fit's losses and leaves within
    ``tol[fit] = {"loss": rtol, "<leaf>": atol}`` of the fit without a mesh
    (absent: bit for bit).  Returns ``{fit: report}``: the seconds of each
    turn, launches, the ranks' ``comm.tally()`` of a fit and the largest
    differences."""
    tol = tol or {}
    procs, logs = [], []
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    for r in range(world):
        cfg = {"rank": r, "world": world, "store": os.path.join(tmp, "store"), "dir": tmp,
               "sizes": sizes, "fits": list(fits), "turns": turns, "timeout": timeout,
               "device_type": device_type}
        logs.append(os.path.join(tmp, f"rank{r}.err"))
        with open(logs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys; from rectipy_tpu_torch.testing import "
                 "mesh_quant_rank; mesh_quant_rank(sys.argv[1])", json.dumps(cfg)],
                stdout=subprocess.DEVNULL, stderr=err, env=env))
    deadline = time.monotonic() + timeout
    cuda = device_type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    reports, cache = {}, {}
    try:
        for name in fits:
            net, fit, launches = mesh_quant_fit(name, sizes, dev, cache)
            launches = launches if cuda else {}  # the counters count CUDA launches
            plain_s, mesh_s, first = [], [], None
            for turn in range(turns):
                sync()
                t0 = time.perf_counter()
                rec = fit(None)
                sync()
                plain_s.append(time.perf_counter() - t0)
                got = _counts(launches)
                if got != launches:
                    raise AssertionError(f"{name} without a mesh: launches {got}, want "
                                         f"{launches}")
                if first is None:
                    first = rec
                elif not all(torch.equal(rec[k], first[k]) if k != "loss" else
                             np.array_equal(rec[k], first[k]) for k in rec):
                    raise AssertionError(f"{name} without a mesh: turn {turn} parts from turn 0")
                del rec
                open(os.path.join(tmp, f"go_{name}_{turn}"), "w").close()
                recs = []
                for r in range(world):
                    path = os.path.join(tmp, f"{name}_{turn}.r{r}.json")
                    while not os.path.exists(path):
                        if any(p.poll() not in (None, 0) for p in procs) \
                                or time.monotonic() > deadline:
                            raise AssertionError(f"{name}: a rank failed or timed out: " + " | "
                                                 .join(open(lg).read()[-2000:] for lg in logs))
                        time.sleep(0.005)
                    time.sleep(0.01)  # the json written whole
                    with open(path) as f:
                        recs.append(json.load(f))
                mesh_s.append(max(r["seconds"] for r in recs))
                for r, rec in enumerate(recs):
                    if rec["launches"] != launches:
                        raise AssertionError(f"{name} rank {r}: launches {rec['launches']}, "
                                             f"want {launches}")
                    for key in ("loss", "fingerprints"):
                        if rec[key] != recs[0][key] or (turn and rec[key] != reports[name][key]):
                            raise AssertionError(f"{name} rank {r} turn {turn}: {key} parts "
                                                 f"from rank 0's or from turn 0's")
                reports[name] = {"loss": recs[0]["loss"], "fingerprints": recs[0]["fingerprints"],
                                 "tally": [r["tally"] for r in recs],
                                 "launches": recs[0]["launches"]}
            mesh_leaves = torch.load(os.path.join(tmp, f"{name}.pt"), map_location=dev)
            diffs = {"loss": float(np.max(np.abs(np.asarray(reports[name]["loss"]) - first["loss"])
                                          / np.abs(first["loss"])))}
            for k, v in mesh_leaves.items():
                diffs[k] = float((v - first[k]).abs().max())
            limits = tol.get(name, {})
            bad = {k: v for k, v in diffs.items() if v > limits.get(k, 0.0)}
            if bad:
                raise AssertionError(f"{name}: the mesh fit parts from the fit without a mesh: "
                                     f"{bad} (limits {limits})")
            reports[name].update(
                plain_s=plain_s, mesh_s=mesh_s, diffs=diffs, limits=limits,
                bit_identical=not any(diffs.values()), leaves={k: list(v.shape) for k, v in
                                                               mesh_leaves.items()})
            del net, fit, first, mesh_leaves
            if cuda:
                torch.cuda.empty_cache()
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        if any(p.returncode for p in procs):
            raise AssertionError("a rank failed: " + " | ".join(open(lg).read()[-2000:]
                                                              for lg in logs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return reports
