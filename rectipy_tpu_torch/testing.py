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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.fused_opt import bias_corrections

__all__ = ["ADAM_KW", "ADAM_RTOL", "GENERIC_CASES", "GENERIC_TOL", "adam_inputs",
           "check_adam_requant", "check_generic", "generic_case_net", "generic_inputs",
           "generic_rows_instance", "generic_rows_operands", "lost_eighth_margin",
           "qif_rows_instance", "quant_scales", "reciprocal_rows"]

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
