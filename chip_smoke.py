#!/usr/bin/env python3
"""Smoke run of rectipy_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: the card's name and power limit (nvidia-smi), PyTorch and CUDA.
2. build: compiles the four CUDA sources of rectipy_tpu_torch/csrc/ and the
   generic fused step's generated sources (one per template structure this
   script attaches, into rectipy_tpu_torch/_build/gen/) with nvcc (sm_90a),
   one nvcc per source, all started together, and prints the compile times
   and ptxas's register report.
3. kernel_check: the fused QIF+SFA step kernel against its plain PyTorch
   version on the same card, at N = 10,000 with the main path's coupling,
   in f32 and bf16: once with v across the threshold (the reset) and once
   with inputs on which the coupling sets v' (the matvec).
4. main_path: the bench network (qif_sfa SpikeResetNet with a seeded 10%
   row-normalised coupling, fed by a tanh node through a Linear edge) built
   through the public API, the kernel attached, and Network.run over 20,000
   steps, for a bf16 and an f32 coupling; the launch counter must equal the
   step count and the records must be finite; neuron-updates/s from the best
   of 3 timed runs.
5. fused_vs_plain: the bf16 network with and without the kernel over 2,000
   steps; the population-mean s records must agree.
6. timing: per kernel, its ms per step, the derived bound, the plain
   version's ms and torch.mv's ms (the matvec alone, a yardstick); and the
   main path's whole network step timed on the device alone, which with
   the end-to-end step gives the device's idle share.
7. train_kernel_check: the int8 matvecs (bit for bit) and the fused adam +
   requantize kernel (rtol 1e-6; wq equal away from rounding boundaries)
   against their plain versions at the training path's shapes.
8. train_path: bench.py's north-star training (QIF SpikeResetNet, N =
   10,000, T = 500, dt = 5e-3, int8_master coupling, adam lr 1e-4, 16
   epochs) through Network.fit_bptt with RECTIPY_FUSED_ADAM=on: a 2-epoch
   warm fit and one timed fit; the launch counts must be 16 adam_requant and
   8,000 of each int8 matvec per fit, the losses finite.
9. train_split_vs_fused: 4 epochs with RECTIPY_FUSED_ADAM=off and =on on
   fresh networks: epoch 0's loss equal, later ones within rtol 1e-4.
10. train_timing: one epoch split by CUDA events into the forward loop, the
   backward loop, the dW matmul and the optimizer tail; the device's idle
   share over one epoch from torch.profiler; each training kernel's ms,
   bound and plain ms.

Phases 11-14 (run after phase 6, while the main path's networks exist):

11. generic_kernel_check and generic_timing: one step of the generic fused
   step kernel against its plain version at N = 10,000 with the main
   path's coupling, in f32 and bf16 W, for every case of
   rectipy_tpu_torch.testing.GENERIC_CASES (qif_sfa, lif, ik
   MultiSpikeResetNet, qif_reset SpikeNet, the tanh RateNet in Heun's
   derivative mode, two couplings one of which targets the input); the
   qif_sfa case also on inputs where the coupling sets v' (the lost-eighth
   margin must exceed 1); then each instance's ms, bound, plain ms and
   torch.mv ms (the matvecs alone).
12. generic_path: examples/fused_kernels.py's LIF network (bf16 coupling)
   with attach_generic_fused_step and Network.run over 20,000 steps; one
   launch per step, finite records, neuron-updates/s from the best of 3.
13. generic_vs_specialized: the main path's bf16 network with the generic
   kernel in place of attach_fused_qif_step over 2,000 steps, in turns
   with the specialized one; the records must agree under fused_vs_plain's
   rule.
14. generic_ei_path: examples/ei_circuit_multi_coupling.py's E/I circuit
   (two f32 couplings through CircuitTemplate) over 2,000 steps.
The kernels line lists the instances that phases 12-14 ran.

Phases 15-17 (after phase 14; the int4 couplings and the packed-int4 kernels
of csrc/int4_matvec.cu, the counterpart of benchmarks/i4pack_microbench.py):

15. int4_kernel_check: int4_mv and int4_mv_t against their plain versions
   on the card, bit for bit: (a) on the packed W that the int4 path's
   network made in its own prep (N = 10,000); (b) the microbenchmark's own
   case at its N = 14,336 (weights in [-8, 7], x in [-127, 127], seed 0),
   also equal to x @ wt in float64; (c) a 1,001 x 999 shape with unpadded
   500-byte rows, which takes the scalar instantiations.
16. int4_path: the main path's network (phase 4) without a fused kernel,
   with coupling_dtype="int4" and, in turns, "int8" (bench.py's default),
   20,000 steps through Network.run, int4 best of 3 and int8 of 2 in
   turns; one int4_mv (or int8_mv) launch per step, finite records, the correlation of the int4 and int8
   records, each path's device-only step and idle share; then the same int4
   network on the CPU over 200 steps, held to the card's run under
   fused_vs_plain's rule (int4_path_vs_cpu).
17. int4_timing: at N = 10,000 and 14,336, each int4 kernel's ms, bytes,
   bound and achieved bytes/s, its plain version's ms on the card and
   int8_mv/int8_mv_t on the same integers (the microbenchmark's A/B).

Phases 18-19 (after phase 10, on the training path's data):

18. int4_train_path: phase 8's network with coupling_dtype="int4_master":
   one warm and one timed 16-epoch fit; 8,000 launches each of int4_mv and
   int4_mv_t per fit, none of the int8 kernels or adam_requant; finite
   losses; ms/epoch and trained neuron-updates/s.
19. bf16_master_train_path: the same network with "bfloat16_master", 4
   epochs (no hand-written kernel: bf16 x bf16 products with float32 sums
   as a PyTorch matvec, as the JAX package leaves them to XLA).

Each phase prints one JSON line; then come the ``kernels`` line, the card's
nvidia-smi line and, last, the contract line.  Any failed check raises and
the script exits non-zero.  Without a CUDA device it exits 2 and prints
nothing on stdout.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N = 10_000
DT = 1e-4
STEPS = 20_000
PLAIN_STEPS = 2_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
INT8_OPS = 1979e12  # H100 SXM data sheet, int8 (the int4 weights multiply as int8 bytes)
QIF_SFA = "rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa"
QIF = "rectipy_tpu_torch.models.spiking_neurons.qif.qif"
LIF = "rectipy_tpu_torch.models.spiking_neurons.lif.lif"
TANH = "rectipy_tpu_torch.models.rate_neurons.leaky_integrator.tanh"
KERNEL_SOURCE = "rectipy_tpu_torch/csrc/qif_sfa_step.cu"
TPU_KERNEL = "rectipy_tpu/ops/kernels.py:53"
SOURCES = ("qif_sfa_step", "int8_matvec", "adam_requant", "int4_matvec")
GENERIC_SOURCE = "rectipy_tpu_torch/csrc/generic_fused_step.cuh"
GENERIC_TPU_KERNEL = "rectipy_tpu/ops/generic_fused.py:46"
I4_SOURCE = "rectipy_tpu_torch/csrc/int4_matvec.cu"
I4_TPU_KERNEL = "benchmarks/i4pack_microbench.py:54"
N_I4PACK = 14_336  # i4pack_microbench.py's default N
CPU_STEPS = 200  # the int4 path's CPU comparison window
# the training path: bench.py:331-370
T_TRAIN, DT_TRAIN, EPOCHS, LR = 500, 5e-3, 16, 1e-4
WARM_EPOCHS = 2  # the int8_master path's warm fit
SPLIT_VS_FUSED_RTOL = 1e-4
# kernel vs plain on the card, (rtol, atol), for the two input cases of the
# kernel check; W is the main path's in both.  Both W types take the same
# tolerance: f32 does the same f32 arithmetic, summed in another order over
# 10,000 terms; bf16 sums exact products of bf16 values in f32 (s is rounded
# to bf16 on both sides), so only the order differs there too.
# - "reset": v spread across the threshold, to hold the reset mask and the
#   epilogue.  Here the coupling adds only dt*k*s_in ~ 7.5e-4 to a v' of
#   order 100, so this case cannot see a wrong matvec.
# - "coupling": k = 1/dt and v, eta, x, inp of order 1e-3, all below the
#   threshold, so v' = s_in + O(1e-3) with s_in ~ 0.5 (a row-normalised W
#   averages s).  The tolerance on v' is then 1e-6 + 1e-5*|v'| ~ 6e-6 on
#   s_in, 1.2e-5 of it; one term of a row averages 5e-4 (a W entry is 1e-3),
#   and the check asserts that losing every eighth term fails on every row.
TOL = {"reset": (1e-5, 1e-4), "coupling": (1e-5, 1e-6)}
# The generic kernel is held to rectipy_tpu_torch.testing.GENERIC_TOL, which
# the GPU tests share: "reset" (rtol 1e-5, atol 1e-5 of each output row's
# largest entry), because the f32 sums run in another order and nvcc
# contracts a*b + c into FMAs in the tail and the update where the plain
# version rounds the product first (a few ulps of values up to ~1e4);
# "coupling" (rtol 1e-5, atol 1e-6) on the qif_sfa inputs where v' = s_in +
# O(1e-3), as TOL["coupling"] above, held to a lost-eighth margin above 1.


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls.

    The card first spins for ~0.1 s while the host queues every call, so the
    events time the device work alone, not the host's launch rate.  The
    calls must fit the device's launch queue (about a thousand kernels), or
    the host blocks until the spin ends."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        raise AssertionError("the spin ended before the host had queued the timed calls")
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_inputs(steps: int) -> np.ndarray:
    inp = np.zeros((steps, 1), dtype=np.float32)
    inp[steps // 4: 3 * steps // 4, 0] = 3.0
    return inp


def bench_training_data(n: int):
    """bench.py's north-star training data (bench.py:334-338), seed 2."""
    rng = np.random.default_rng(2)
    W = (rng.random((n, n)) < 0.1) * (1.0 / (0.1 * n))
    etas = -5.0 + np.tan((np.pi / 2) * (2.0 * np.arange(1, n + 1) - n - 1) / (n + 1))
    inp = rng.normal(size=(T_TRAIN, n))
    tgt = rng.normal(size=(T_TRAIN, n))
    return W, etas, inp, tgt


def build_train_net(W, etas, device=None, coupling="int8_master"):
    from rectipy_tpu_torch import Network

    net = Network(DT_TRAIN, device=device)  # default: the current CUDA device; float32
    net.add_diffeq_node("qif", QIF, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="qif_op", spike_var="spike",
                        spike_def="v", spike_threshold=1e2, spike_reset=-1e2,
                        node_vars={"all/qif_op/eta": etas}, coupling_dtype=coupling,
                        train_params=["weights"])
    net.compile()
    return net


def fit(net, inp_d, tgt_d, epochs: int, mode: str):
    """One fit_bptt of ``epochs`` epochs; returns (seconds, losses)."""
    os.environ["RECTIPY_FUSED_ADAM"] = mode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obs = net.fit_bptt([inp_d] * epochs, [tgt_d] * epochs, optimizer="adam", lr=LR,
                       verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = [float(x) for x in obs["epoch_loss"]]
    if len(losses) != epochs or not np.all(np.isfinite(losses)):
        raise AssertionError(f"fit_bptt ({mode}): bad losses {losses}")
    return seconds, losses


def profile_device_time(fn):
    """(device busy ms, top device ops) of one call of ``fn`` under
    torch.profiler; (None, reason) when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies, fills): a CPU op that
        # launches a kernel through ctypes also reports that kernel's time
        # as its own "self" device time, which would count it twice
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    if not rows:
        return None, "torch.profiler recorded no device time"
    rows.sort(key=lambda r: -r[1])
    top = [{"op": k[:80], "ms": us / 1e3, "count": c} for k, us, c in rows[:12]]
    return sum(r[1] for r in rows) / 1e3, top


def train_phases(dev, data) -> list:
    """Phases 7-10: the training path and its three kernels, on
    ``bench_training_data``'s ``data`` (and the seconds it took to make).
    Returns their entries of the ``kernels`` line."""
    from rectipy_tpu_torch.ops import bptt
    from rectipy_tpu_torch.ops.fused_opt import (adam_requant, adam_requant_plain,
                                                 bias_corrections)
    from rectipy_tpu_torch.ops.quant import (int8_dot_plain, int8_dot_t_plain, int8_mv,
                                             int8_mv_t, quant_vec, quantize_rows)

    from rectipy_tpu_torch.testing import ADAM_KW, ADAM_RTOL, adam_inputs, check_adam_requant

    W_np, etas, inp, tgt, data_s = data

    # ------------------------------------------------ 7. train kernel check
    W = torch.as_tensor(W_np, dtype=torch.float32, device=dev)
    wq, ws = quantize_rows(W)
    gen = torch.Generator(device=dev).manual_seed(3)
    xq, xs = quant_vec(torch.randn(N, generator=gen, device=dev))
    vq, vs = quant_vec(torch.randn(N, generator=gen, device=dev) * 1e-3)
    mv, mv_ref = int8_mv(wq, xq, ws, xs), (int8_dot_plain(wq, xq) * ws) * xs
    mv_t, mv_t_ref = int8_mv_t(wq, vq, vs), int8_dot_t_plain(wq, vq) * vs
    torch.cuda.synchronize()
    if not (torch.equal(mv, mv_ref) and torch.equal(mv_t, mv_t_ref)):
        raise AssertionError("an int8 matvec kernel differs from its plain version")
    if not (bool((mv != 0).any()) and bool((mv_t != 0).any())):
        raise AssertionError("the int8 check is vacuous: all outputs are zero")
    emit({"phase": "train_kernel_check", "kernel": "int8_mv/int8_mv_t", "n": N,
          "bit_identical": True, "wq_nonzero": int((wq != 0).sum()), "data_s": data_s})
    adam_err = 0.0
    for count in (1, 7):
        w, m, v, g, bc1, bc2, lr = adam_inputs(N, N, count, 5, dev)
        got = adam_requant(w, m, v, g, bc1, bc2, lr, **ADAM_KW)
        torch.cuda.synchronize()
        ref = adam_requant_plain(w, m, v, g, bc1, bc2, lr, **ADAM_KW)
        rel, at_boundary, margin = check_adam_requant(got, ref, w)
        err = max(float((a - b).abs().max()) for a, b in zip(got[:3] + (got[4],),
                                                              ref[:3] + (ref[4],)))
        adam_err = max(adam_err, err)
        emit({"phase": "train_kernel_check", "kernel": "adam_requant", "shape": [N, N],
              "count": count, "max_abs_err": err, "max_rel_err": rel, "rtol": ADAM_RTOL,
              "wq_differ": int((got[3] != ref[3]).sum()), "wq_at_rounding_boundary": at_boundary,
              "min_update_over_tolerance": margin})
        del got, ref, w, m, v, g
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 8. train path
    inp_d = torch.as_tensor(inp, dtype=torch.float32, device=dev)
    tgt_d = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    net = build_train_net(W_np, etas)
    build_s = time.perf_counter() - t0
    # a short warm fit, then one timed fit (the run's time limit)
    warm_s, warm_losses = fit(net, inp_d, tgt_d, WARM_EPOCHS, "on")
    torch.cuda.reset_peak_memory_stats()
    int8_mv.launches = int8_mv_t.launches = adam_requant.launches = 0
    seconds, losses = fit(net, inp_d, tgt_d, EPOCHS, "on")
    launches = {"adam_requant": adam_requant.launches, "int8_mv": int8_mv.launches,
                "int8_mv_t": int8_mv_t.launches}
    want = {"adam_requant": EPOCHS, "int8_mv": EPOCHS * T_TRAIN, "int8_mv_t": EPOCHS * T_TRAIN}
    if launches != want:
        raise AssertionError(f"launch counts {launches}; expected {want}")
    if net.last_fit != {"trajectory": "chain", "fused_adam": True}:
        raise AssertionError(f"the fit did not take the fused path: {net.last_fit}")
    best = seconds / EPOCHS
    emit({"phase": "train_path", "n": N, "T": T_TRAIN, "epochs": EPOCHS, "coupling": "int8_master",
          "fused_adam": "on", "build_s": build_s, "warm_fit_s": warm_s,
          "warm_epochs": WARM_EPOCHS, "fit_s": seconds, "ms_per_epoch": best * 1e3,
          "trained_neuron_updates_per_s": T_TRAIN * N / best, "launches_per_fit": launches,
          "first_loss": warm_losses[0], "last_loss": losses[-1], "losses_timed_fit": losses,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})

    # ----------------------------------------------- 9. split vs fused
    del net
    torch.cuda.empty_cache()
    sv = {}
    for mode in ("off", "on"):
        net = build_train_net(W_np, etas)
        seconds, losses = fit(net, inp_d, tgt_d, 4, mode)
        sv[mode] = (seconds / 4, losses)
        del net
        torch.cuda.empty_cache()
    l_off, l_fused = np.asarray(sv["off"][1]), np.asarray(sv["on"][1])
    if l_off[0] != l_fused[0]:
        raise AssertionError(f"epoch 0 losses differ: {l_off[0]} vs {l_fused[0]}")
    dev_rel = float(np.max(np.abs(l_fused - l_off) / np.abs(l_off)))
    if dev_rel > SPLIT_VS_FUSED_RTOL:
        raise AssertionError(f"split vs fused losses differ by {dev_rel} (rtol "
                             f"{SPLIT_VS_FUSED_RTOL})")
    emit({"phase": "train_split_vs_fused", "epochs": 4, "losses_off": list(l_off),
          "losses_on": list(l_fused), "max_rel_deviation": dev_rel,
          "rtol": SPLIT_VS_FUSED_RTOL, "ms_per_epoch_off": sv["off"][0] * 1e3,
          "ms_per_epoch_on": sv["on"][0] * 1e3})

    # ------------------------------------------------------ 10. timing
    net = build_train_net(W_np, etas)
    node = net.get_node("qif")
    traj_p, wkeys, preps = bptt.make_coupled_traj_prepped(node)
    p = bptt._node_pieces(node)
    args = {k: v for k, v in node.args.items() if k not in wkeys}
    Wm = node.args["weights"]
    wp = (preps[0](Wm),)
    y0 = node.y
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    # the epoch as fit_bptt runs it: the trajectory's forward, then its
    # backward (the reverse loop and the dW matmul) called by the autograd
    # engine; the dW matmul is timed again alone at the same shapes, and the
    # optimizer tail is the fused kernel
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    W_leaf = Wm.detach().requires_grad_(True)
    with torch.enable_grad():
        ev[0].record()
        _, outs = traj_p(wp, {"weights": W_leaf}, args, y0, inp_d)
        ev[1].record()
        (gW,) = torch.autograd.grad(torch.mean((outs - tgt_d) ** 2), W_leaf)
        ev[2].record()
    deltas = torch.randn((T_TRAIN, N), device=dev)
    ev[3].record()
    p.grad_ws[0](deltas, deltas)
    ev[4].record()
    bc1, bc2 = bias_corrections(1, 0.9, 0.999)
    zeros = torch.zeros_like(Wm)
    adam_requant(Wm, zeros, zeros, gW, bc1, bc2, LR, **ADAM_KW)
    ev[5].record()
    torch.cuda.synchronize()
    split_wall_s = time.perf_counter() - t0
    fwd, bwd_all, dw = (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                        ev[3].elapsed_time(ev[4]))
    parts = [fwd, bwd_all - dw, dw, ev[4].elapsed_time(ev[5])]
    del outs, gW, deltas, zeros
    busy_ms, top = profile_device_time(lambda: fit(net, inp_d, tgt_d, 1, "on"))
    epoch_ms = best * 1e3
    emit({"phase": "train_timing_top_device_ops", "top": top})
    emit({"phase": "train_timing", "epoch_split_ms": dict(zip(
        ("forward_loop", "backward_loop", "dW_matmul", "optimizer_tail"), parts)),
        "split_wall_s": split_wall_s, "profiled_device_busy_ms": busy_ms,
        "ms_per_epoch": epoch_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / epoch_ms})

    # per-kernel times at the training shapes
    w, m, v, g, bc1, bc2, lr = adam_inputs(N, N, 7, 5, dev)
    entries = []
    specs = [
        ("int8_mv", "rectipy_tpu_torch/csrc/int8_matvec.cu", "rectipy_tpu/ops/quant.py:65",
         lambda: int8_mv(wq, xq, ws, xs), lambda: (int8_dot_plain(wq, xq) * ws) * xs,
         N * N + N + 4 * N + 4 + 4 * N, 2 * N * N + 2 * N, INT8_OPS, 0.0),
        ("int8_mv_t", "rectipy_tpu_torch/csrc/int8_matvec.cu", "rectipy_tpu/ops/quant.py:73",
         lambda: int8_mv_t(wq, vq, vs), lambda: int8_dot_t_plain(wq, vq) * vs,
         N * N + N + 4 + 4 * N, 2 * N * N + N, INT8_OPS, 0.0),
        ("adam_requant", "rectipy_tpu_torch/csrc/adam_requant.cu",
         "rectipy_tpu/ops/fused_opt.py:88",
         lambda: adam_requant(w, m, v, g, bc1, bc2, lr, **ADAM_KW),
         lambda: adam_requant_plain(w, m, v, g, bc1, bc2, lr, **ADAM_KW),
         29 * N * N + 4 * N, 15 * N * N + 3 * N, F32_FLOPS, adam_err),
    ]
    for name, source, replaces, fn, plain, n_bytes, n_ops, peak, err in specs:
        ms = cuda_ms(fn, reps=50 if name == "adam_requant" else 200)
        plain_ms = cuda_ms(plain, reps=5)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(t_bytes, t_ops) * 1e3,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
        entries.append(entry)
        emit({"phase": "train_timing", **entry, "bytes": n_bytes, "ops": n_ops,
              "launches_per_epoch": launches[name] // EPOCHS,
              "library_ms_reason": "no single PyTorch call computes this function",
              "achieved_bytes_per_s": n_bytes / (ms * 1e-3)})
    return entries


def lif_net(n: int, device):
    """examples/fused_kernels.py's network at width n: a LIF SpikeResetNet
    with a bf16 coupling W = |normal| * 0.5/n and per-neuron tau ~ U(10, 15)
    from seed 0, eta 10, tau_s 5, threshold +-10, dt 1e-2; the generic
    kernel attached."""
    from rectipy_tpu_torch import Network, attach_generic_fused_step

    rng = np.random.default_rng(0)
    W = np.abs(rng.normal(size=(n, n))) * (0.5 / n)
    tau = rng.uniform(10.0, 15.0, size=n)
    net = Network(1e-2, device=device)
    net.add_diffeq_node("lif", LIF, weights=W, source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", op="lif_op", spike_var="spike",
                        reset_var="v", spike_threshold=10.0, spike_reset=-10.0,
                        node_vars={"eta": 10.0, "tau": tau, "tau_s": 5.0},
                        coupling_dtype="bfloat16")
    net.compile()
    attach_generic_fused_step(net.get_node("lif"))
    return net


def ei_net(n: int, device):
    """examples/ei_circuit_multi_coupling.py's circuit at width n: a tanh
    leaky integrator population with two f32 couplings into li_op/r_in,
    excitatory (fixed fan-in 10%, rows summing to 2) and inhibitory
    (-|normal| * 1.5/n), from seed 0, built through CircuitTemplate; the
    generic kernel attached.  Returns (net, seconds making W, seconds
    building the network)."""
    from rectipy_tpu_torch import (CircuitTemplate, Network, NodeTemplate,
                                   attach_generic_fused_step, random_connectivity)

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    W_exc = random_connectivity(n, n, 0.1, normalize=True, rng=rng) * 2.0
    W_inh = -np.abs(rng.normal(size=(n, n))) * (1.5 / n)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tmpl = NodeTemplate.from_yaml(TANH)
    circuit = CircuitTemplate("ei", {f"p{i}": tmpl for i in range(n)})
    circuit.add_edges_from_matrix("tanh_op/r", "li_op/r_in", weight=W_exc)
    circuit.add_edges_from_matrix("tanh_op/r", "li_op/r_in", weight=W_inh)
    net = Network(1e-2, device=device)
    net.add_diffeq_node("ei", circuit, input_var="li_op/I_ext", output_var="tanh_op/r")
    net.compile()
    attach_generic_fused_step(net.get_node("ei"))
    return net, data_s, time.perf_counter() - t0


def generic_sources() -> list:
    """The generated source of every generic-kernel network of this script,
    from the same builders on CPU tensors at n = 16 (the source depends on
    the template, the node class and which parameters are per-neuron, not on
    n), so that the build phase compiles them beside the csrc/ sources."""
    from rectipy_tpu_torch.testing import GENERIC_CASES, generic_case_net

    W = np.full((16, 16), 1.0 / 16)
    nodes = [generic_case_net(case, W, "cpu")[1] for case in GENERIC_CASES]
    nodes += [lif_net(16, "cpu").get_node("lif"), ei_net(16, "cpu")[0].get_node("ei")]
    return sorted({node._fused_cfg["step"].source for node in nodes})


def tail_ops(program) -> int:
    """Arithmetic operations and function calls of one neuron's tail."""
    def count(ast) -> int:
        if ast[0] in ("num", "var"):
            return 0
        if ast[0] == "neg":
            return 1 + count(ast[1])
        if ast[0] == "bin":
            return 1 + count(ast[2]) + count(ast[3])
        return 1 + sum(count(a) for a in ast[2])

    # each input placeholder adds its wiring and its external slot
    return (sum(count(ast) for ast, _ in program.algebraic.values())
            + sum(count(ast) for _, ast, _ in program.odes) + 2 * len(program.input_defaults))


def generic_instance(name: str, node, w_dtype, seed: int, launches: int, case: str = "reset",
                     report: dict = None):
    """Hold one instance of the generic kernel (a node's attached step, W in
    w_dtype) to its plain version on inputs from ``generic_inputs`` (see
    GENERIC_TOL), then time it: the kernel, the plain version and torch.mv
    of the same W (the matvecs alone).  Prints one ``generic_timing`` line
    and returns the instance's ``kernels`` entry (the coupling case is
    checked only, and returns None)."""
    from rectipy_tpu_torch.ops.generic_fused import generic_fused_step, generic_fused_step_plain
    from rectipy_tpu_torch.testing import (GENERIC_TOL, check_generic, generic_inputs,
                                           lost_eighth_margin)

    step, srcs, drive, states, vecs = generic_inputs(node, seed, coupling=case == "coupling")
    K, V, n = len(step.targets), len(step.state_order), node._fused_cfg["n"]
    Ws = [node.args[f"__w_fused_{c}__"].to(w_dtype) for c in range(K)]
    before = generic_fused_step.launches
    got = generic_fused_step(step, srcs, Ws, drive, states, vecs)
    torch.cuda.synchronize()
    if generic_fused_step.launches != before + 1:
        raise AssertionError(f"{name}: the kernel check did not launch the kernel")
    ref = generic_fused_step_plain(step, srcs, Ws, drive, states, vecs)
    err, resets = check_generic(got, ref, step, case)
    rtol, atol = GENERIC_TOL[case]
    line = {"phase": "generic_kernel_check", "instance": name, "case": case, "n": n,
            "max_abs_err": err, "rtol": rtol,
            "atol": atol if case == "coupling" else f"{atol} x row max",
            "reset_neurons": resets, **(report or {})}
    hard = any(h for _, _, h, _ in step.spike_specs) and not step.derivative
    if case == "reset" and hard and resets == 0:
        raise AssertionError(f"{name}: no neuron was reset")
    if case == "coupling":
        margin = lost_eighth_margin(step, srcs, Ws, drive, states, vecs, ref)
        if resets or margin <= 1.0:
            raise AssertionError(f"{name}: the coupling case reset neurons or would pass a "
                                 f"lost eighth of the row sums (margin {margin})")
        line["lost_eighth_min_margin"] = margin
    emit(line)
    if case == "coupling":
        return None
    ms = cuda_ms(lambda: generic_fused_step(step, srcs, Ws, drive, states, vecs), reps=200)
    plain_ms = cuda_ms(lambda: generic_fused_step_plain(step, srcs, Ws, drive, states, vecs),
                       reps=10)
    s_w = [s.to(w_dtype) for s in srcs]
    library_ms = cuda_ms(lambda: [torch.mv(W, s) for W, s in zip(Ws, s_w)], reps=200)
    # W once, the K sources, drive, V states and P per-neuron rows in, V rows out
    n_bytes = K * n * n * Ws[0].element_size() + 4 * n * (K + 1 + 2 * V + len(vecs))
    n_ops = 2 * K * n * n + n * tail_ops(node._vf.tile_program)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
    entry = {"name": f"generic_fused_step[{name}]", "route": "cuda", "source": GENERIC_SOURCE,
             "replaces": GENERIC_TPU_KERNEL, "launches": launches, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms}
    emit({"phase": "generic_timing", **entry, "bytes": n_bytes, "ops": n_ops,
          "library_call": f"torch.mv x {K} (the matvecs alone)",
          "achieved_bytes_per_s": n_bytes / (ms * 1e-3)})
    return entry


def device_step_ms(net, x, reps: int = 50) -> float:
    """The network's whole step with input ``x`` timed on the device alone
    (no host gaps), as phase 6 times the main path's, on the parameters as
    ``Network.run`` preps them; ``reps`` steps, so that the host queues them
    within cuda_ms's spin even at 1 ms of host time each.  A plain lowered
    step (no fused kernel) launches about 75 kernels: 8 steps keep it within
    the launch queue."""
    step = net.make_step()
    state, params = net.init_state(), net._prep_params(net.parameters_pytree())
    with torch.no_grad():
        return cuda_ms(lambda: step(state, params, x), reps=reps)


def generic_phases(W_np, build_net, spec_net) -> list:
    """Phases 11-14: the generic fused step.  ``W_np`` is the main path's
    coupling, ``build_net`` builds the main path's network and ``spec_net``
    is its bf16 network with the specialized kernel.  Returns the entries of
    the ``kernels`` line: one per instance a path ran."""
    from rectipy_tpu_torch import attach_generic_fused_step
    from rectipy_tpu_torch.ops.generic_fused import generic_fused_step
    from rectipy_tpu_torch.ops.kernels import qif_sfa_step
    from rectipy_tpu_torch.testing import GENERIC_CASES, generic_case_net

    dev = torch.device("cuda", 0)
    # ------------------------------------------- 11. generic kernel check
    # every node class and mode at N with the main path's coupling, the
    # kernel in f32 and in bf16 W; timed per instance (phase generic_timing)
    for case in GENERIC_CASES:
        t0 = time.perf_counter()
        _, node = generic_case_net(case, W_np, dev)
        build_s = time.perf_counter() - t0
        for w_name, w_dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            generic_instance(f"{case},{w_name}", node, w_dtype, 11, 0,
                             report={"build_s": build_s})
            if case == "qif_sfa":
                generic_instance(f"{case},{w_name}", node, w_dtype, 12, 0, case="coupling")
        del node
        torch.cuda.empty_cache()
    entries = []

    # --------------------------------------------------- 12. generic path
    t0 = time.perf_counter()
    net = lif_net(N, None)
    build_s = time.perf_counter() - t0
    run_kw = dict(record_output=False, record_vars=[("lif", "s", True)], sampling_steps=100,
                  verbose=False)
    inputs = np.zeros((STEPS, 1), dtype=np.float32)  # the example's zero drive, broadcast
    generic_fused_step.launches = 0
    t0 = time.perf_counter()
    obs = net.run(inputs, **run_kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = generic_fused_step.launches
    if launches != STEPS:
        raise AssertionError(f"generic_path: {launches} kernel launches for {STEPS} steps")
    rec = obs.to_numpy(("lif", "s"))
    if rec.shape != (STEPS // 100,) or not np.all(np.isfinite(rec)) or not rec.max() > 0.0:
        raise AssertionError(f"generic_path: bad records (shape {rec.shape}, max {rec.max()})")
    times = []
    for _ in range(3):
        net.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = net.run(inputs, **run_kw).to_numpy(("lif", "s"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not np.all(np.isfinite(rec)):
            raise AssertionError("generic_path: non-finite records in a timed run")
    best = min(times)
    dev_ms = device_step_ms(net, torch.zeros(1, device=net.device))
    emit({"phase": "generic_path", "template": "lif", "coupling": "bfloat16", "n": N,
          "steps": STEPS, "kernel_launches": launches, "build_s": build_s,
          "first_run_s": first_s, "run_s": times, "best_s": best,
          "ms_per_step": best / STEPS * 1e3, "neuron_updates_per_s": STEPS * N / best,
          "device_step_ms": dev_ms, "device_idle_share": 1.0 - dev_ms / (best / STEPS * 1e3),
          "mean_s_range": [float(rec.min()), float(rec.max())]})
    entries.append(generic_instance("lif,bfloat16,generic_path", net.get_node("lif"),
                                    torch.bfloat16, 13, launches))
    del net, obs
    torch.cuda.empty_cache()

    # ------------------------------------------ 13. generic vs specialized
    t0 = time.perf_counter()
    gen_net = build_net("bfloat16", fused=False)
    attach_generic_fused_step(gen_net.get_node("qif"))
    build_s = time.perf_counter() - t0
    cmp_kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=10,
                  verbose=False)
    short = bench_inputs(PLAIN_STEPS)
    recs, secs, counts = {}, {"specialized": [], "generic": []}, {}
    for name, net in (("specialized", spec_net), ("generic", gen_net), ("generic", gen_net),
                      ("specialized", spec_net)):
        net.reset()
        qif_sfa_step.launches = generic_fused_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = net.run(short, **cmp_kw).to_numpy(("qif", "s"))
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
        recs.setdefault(name, rec)
        counts[name] = (qif_sfa_step.launches, generic_fused_step.launches)
    if counts != {"specialized": (PLAIN_STEPS, 0), "generic": (0, PLAIN_STEPS)}:
        raise AssertionError(f"generic_vs_specialized: launches (qif_sfa_step, "
                             f"generic_fused_step) {counts}")
    ref, got = recs["specialized"], recs["generic"]
    max_diff = float(np.abs(got - ref).max())
    corr = float(np.corrcoef(got, ref)[0, 1]) if ref.std() > 0 else float("nan")
    if not (corr >= 0.999 and max_diff <= 1e-2 * float(np.abs(ref).max())):
        raise AssertionError(f"generic vs specialized: corr {corr}, max|diff| {max_diff}")
    emit({"phase": "generic_vs_specialized", "coupling": "bfloat16", "n": N,
          "steps": PLAIN_STEPS, "records": int(ref.shape[0]), "corr": corr,
          "max_abs_diff": max_diff, "max_abs_ref": float(np.abs(ref).max()),
          "build_s": build_s, "run_s": secs,
          "ms_per_step": {k: min(v) / PLAIN_STEPS * 1e3 for k, v in secs.items()}})
    entries.append(generic_instance("qif_sfa,bfloat16,generic_vs_specialized",
                                    gen_net.get_node("qif"), torch.bfloat16, 14, PLAIN_STEPS))
    del gen_net
    torch.cuda.empty_cache()

    # ------------------------------------------------- 14. generic E/I path
    net, data_s, build_s = ei_net(N, None)
    inp = (np.random.default_rng(1).normal(size=(PLAIN_STEPS, N)) * 0.1).astype(np.float32)
    ei_kw = dict(record_output=True, sampling_steps=20, verbose=False)
    runs = []
    for _ in range(2):
        net.reset()
        generic_fused_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net.run(inp, **ei_kw).to_numpy("out")
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        launches = generic_fused_step.launches
        if launches != PLAIN_STEPS:
            raise AssertionError(f"generic_ei_path: {launches} launches for {PLAIN_STEPS} steps")
        if out.shape != (PLAIN_STEPS // 20, N) or not np.all(np.isfinite(out)):
            raise AssertionError(f"generic_ei_path: bad records, shape {out.shape}")
    dev_ms = device_step_ms(net, torch.as_tensor(inp[0], device=net.device))
    emit({"phase": "generic_ei_path", "couplings": 2, "coupling": "float32", "n": N,
          "steps": PLAIN_STEPS, "kernel_launches": launches, "w_data_s": data_s,
          "build_s": build_s, "run_s": runs, "ms_per_step": min(runs) / PLAIN_STEPS * 1e3,
          "device_step_ms": dev_ms,
          "device_idle_share": 1.0 - dev_ms / (min(runs) / PLAIN_STEPS * 1e3),
          "neuron_updates_per_s": PLAIN_STEPS * N / min(runs),
          "rate_range": [float(out.min()), float(out.max())],
          "mean_abs_rate": float(np.abs(out).mean())})
    entries.append(generic_instance("ei,float32,generic_ei_path", net.get_node("ei"),
                                    torch.float32, 15, launches))
    del net
    torch.cuda.empty_cache()
    return entries


def int4_check(case: str, wp, ws, xq, xs, vq, vs, n_in: int, exact=None,
               report: dict = None) -> dict:
    """Hold int4_mv and int4_mv_t on (wp, ...) to their plain versions on the
    card, bit for bit (integer sums are exact in any order), and, where
    ``exact`` gives the float64 products ``(W @ xq, W.T @ vq)``, to those.
    Prints one ``int4_kernel_check`` line and returns it."""
    from rectipy_tpu_torch.ops.quant import (int4_dot_plain, int4_dot_t_plain, int4_mv,
                                             int4_mv_t, int4_vector_path)

    before = (int4_mv.launches, int4_mv_t.launches)
    out, out_t = int4_mv(wp, xq, ws, xs), int4_mv_t(wp, vq, vs, n_in)
    torch.cuda.synchronize()
    if (int4_mv.launches, int4_mv_t.launches) != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"int4_kernel_check ({case}): the kernels were not launched")
    ref, ref_t = (int4_dot_plain(wp, xq) * ws) * xs, int4_dot_t_plain(wp, vq, n_in) * vs
    if not (torch.equal(out, ref) and torch.equal(out_t, ref_t)):
        raise AssertionError(f"int4_kernel_check ({case}): a kernel differs from its plain "
                             f"version")
    if not (bool((out != 0).any()) and bool((out_t != 0).any())):
        raise AssertionError(f"int4_kernel_check ({case}): vacuous, all outputs are zero")
    line = {"phase": "int4_kernel_check", "case": case, "shape": [int(wp.shape[0]), n_in],
            "row_bytes": int(wp.shape[1]),
            "path": "vector" if int4_vector_path(wp, xq) else "scalar",
            "bit_identical_to_plain": True, **(report or {})}
    if exact is not None:
        same = (torch.equal(out.double(), exact[0]) and torch.equal(out_t.double(), exact[1]))
        if not same:
            raise AssertionError(f"int4_kernel_check ({case}): not equal to the float64 product")
        line["equal_to_float64_product"] = True
    emit(line)
    return line


def int4_phases(W_np, build_net) -> tuple:
    """Phases 15-17: the int4 kernels against their plain versions, the int4
    path (the main path's network with coupling_dtype="int4", in turns with
    "int8"), and their timing.  Returns (the int4_mv entry of the ``kernels``
    line, the N=10,000 timing of int4_mv_t for the training path's entry)."""
    from rectipy_tpu_torch.ops.quant import (int4_dot_plain, int4_dot_t_plain, int4_mv,
                                             int4_mv_t, int8_mv, int8_mv_t, pack_int4,
                                             quant_vec, unpack_int4)

    dev = torch.device("cuda", 0)
    # --------------------------------------------- 15. int4 kernel check
    # (a) the packed W that the int4 path's network made in its own prep
    t0 = time.perf_counter()
    nets = {c: build_net(c, fused=False) for c in ("int4", "int8")}
    build_s = time.perf_counter() - t0
    node = nets["int4"].get_node("qif")
    wp10, ws10 = node.prep_params(node.args)["weights__q4"], node.args["weights__scale"]
    gen = torch.Generator(device=dev).manual_seed(5)
    xq10, xs10 = quant_vec(torch.rand(N, generator=gen, device=dev))  # s-like, in [0, 1]
    vq10, vs10 = quant_vec(torch.randn(N, generator=gen, device=dev))
    int4_check("int4_path_network", wp10, ws10, xq10, xs10, vq10, vs10, N)
    # (b) i4pack_microbench.py:122-131 at its N: weights in [-8, 7] and x in
    # [-127, 127] from seed 0, against x @ wt (and wt @ x) in float64
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    wt = rng.integers(-8, 8, size=(N_I4PACK, N_I4PACK)).astype(np.int8)
    x = rng.integers(-127, 128, size=N_I4PACK).astype(np.int8)
    data_s = time.perf_counter() - t0
    w14 = torch.as_tensor(wt).to(dev).T.contiguous()  # row j of W = column j of wt
    del wt
    wp14, x14 = pack_int4(w14), torch.as_tensor(x).to(dev)
    w64, x64 = w14.double(), x14.double()
    exact = (torch.mv(w64, x64), torch.mv(w64.T, x64))
    del w64
    one = torch.ones((), dtype=torch.float32, device=dev)
    ones14 = torch.ones(N_I4PACK, dtype=torch.float32, device=dev)
    int4_check("i4pack_microbench", wp14, ones14, x14, one, x14, one, N_I4PACK, exact=exact,
               report={"data_s": data_s})
    # (c) an odd shape with unpadded rows (500 bytes, off the 16-byte grid):
    # the scalar instantiations
    g = torch.Generator(device=dev).manual_seed(6)
    w_odd = torch.randint(-8, 8, (1001, 999), generator=g, device=dev, dtype=torch.int8)
    wp_odd = pack_int4(w_odd)[:, :500].contiguous()
    xq_o, xs_o = quant_vec(torch.randn(999, generator=g, device=dev))
    vq_o, vs_o = quant_vec(torch.randn(1001, generator=g, device=dev))
    line = int4_check("odd_unpadded", wp_odd, torch.rand(1001, generator=g, device=dev) + 0.5,
                      xq_o, xs_o, vq_o, vs_o, 999)
    if line["path"] != "scalar":
        raise AssertionError("int4_kernel_check (odd_unpadded) did not take the scalar path")

    # ------------------------------------------------------ 16. int4 path
    run_kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=100,
                  verbose=False)
    inputs = bench_inputs(STEPS)
    counters = {"int4": int4_mv, "int8": int8_mv}

    def path_run(c):
        int4_mv.launches = int8_mv.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = nets[c].run(inputs, **run_kw).to_numpy(("qif", "s"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        if launches != {k: (STEPS if k == c else 0) for k in counters}:
            raise AssertionError(f"int4_path ({c}): launches {launches} for {STEPS} steps")
        if rec.shape != (STEPS // 100,) or not np.all(np.isfinite(rec)):
            raise AssertionError(f"int4_path ({c}): bad records, shape {rec.shape}")
        return seconds, rec, launches[c]

    runs, recs, launches = {"int4": [], "int8": []}, {}, {}
    # in turns, int4 best of 3 and int8 of 2 (the run's time limit); the
    # kernels were built and run in phase 15
    for c in ("int4", "int8", "int4", "int8", "int4"):
        nets[c].reset()
        seconds, recs[c], launches[c] = path_run(c)
        runs[c].append(seconds)
    corr = float(np.corrcoef(recs["int4"], recs["int8"])[0, 1])
    x_t = torch.full((1,), 3.0, device=dev)
    dev_ms = {c: device_step_ms(nets[c], x_t, reps=8) for c in ("int4", "int8")}
    for c in ("int4", "int8"):
        best = min(runs[c])
        emit({"phase": "int4_path", "coupling": c, "n": N, "steps": STEPS,
              "kernel": counters[c].__name__, "kernel_launches": launches[c],
              "build_s_both": build_s, "run_s": runs[c],
              "best_s": best, "ms_per_step": best / STEPS * 1e3,
              "neuron_updates_per_s": STEPS * N / best, "device_step_ms": dev_ms[c],
              "device_idle_share": 1.0 - dev_ms[c] / (best / STEPS * 1e3),
              "mean_s_range": [float(recs[c].min()), float(recs[c].max())],
              "corr_int4_vs_int8_records": corr})
    # the same int4 network on the CPU over a short window from the card's
    # state after its last run (the population is spiking by then), held to
    # the card's run from that state under fused_vs_plain's rule
    y_end = nets["int4"].get_node("qif").y.detach().cpu().numpy()
    t0 = time.perf_counter()
    cpu_net = build_net("int4", fused=False, device="cpu")
    cpu_build_s = time.perf_counter() - t0
    cmp_kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=10,
                  verbose=False)
    short = bench_inputs(CPU_STEPS)
    cmp, cmp_s = {}, {}
    for name, net in (("card", nets["int4"]), ("cpu", cpu_net)):
        net.reset({"qif": y_end})
        t0 = time.perf_counter()
        cmp[name] = net.run(short, **cmp_kw).to_numpy(("qif", "s"))
        cmp_s[name] = time.perf_counter() - t0
    ref, got = cmp["cpu"], cmp["card"]
    max_diff = float(np.abs(got - ref).max())
    cpu_corr = float(np.corrcoef(got, ref)[0, 1]) if ref.std() > 0 else float("nan")
    if not (cpu_corr >= 0.999 and max_diff <= 1e-2 * float(np.abs(ref).max())):
        raise AssertionError(f"int4 card vs cpu: corr {cpu_corr}, max|diff| {max_diff}")
    emit({"phase": "int4_path_vs_cpu", "coupling": "int4", "n": N, "steps": CPU_STEPS,
          "records": int(ref.shape[0]), "corr": cpu_corr, "max_abs_diff": max_diff,
          "max_abs_ref": float(np.abs(ref).max()), "cpu_build_s": cpu_build_s,
          "card_run_s": cmp_s["card"], "cpu_run_s": cmp_s["cpu"]})
    del cpu_net

    # ---------------------------------------------------- 17. int4 timing
    # per N: int4_mv/int4_mv_t, their plain versions, and int8_mv/int8_mv_t
    # on the same integers (i4pack_microbench.py:170-193's A/B)
    cases = {N: (wp10, ws10, xq10, xs10, vq10, vs10),
             N_I4PACK: (wp14, ones14, x14, one, x14, one)}
    timing = {}
    for n, (wp, ws, xq, xs, vq, vs) in cases.items():
        w_i8 = unpack_int4(wp, n).contiguous()  # the same integers, one per byte
        rows = {}
        for name, fn, plain, i8, i8_bytes, n_bytes in (
                ("int4_mv", lambda: int4_mv(wp, xq, ws, xs),
                 lambda: (int4_dot_plain(wp, xq) * ws) * xs,
                 lambda: int8_mv(w_i8, xq, ws, xs),
                 n * n + 9 * n + 4, n * ((n + 1) // 2) + 9 * n + 4),
                ("int4_mv_t", lambda: int4_mv_t(wp, vq, vs, n),
                 lambda: int4_dot_t_plain(wp, vq, n) * vs,
                 lambda: int8_mv_t(w_i8, vq, vs),
                 n * n + 5 * n + 4, n * ((n + 1) // 2) + 5 * n + 4)):
            ms = cuda_ms(fn, reps=200)
            plain_ms = cuda_ms(plain, reps=5)
            int8_ms = cuda_ms(i8, reps=200)
            n_ops = 2 * n * n
            t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS
            row = {"name": name, "n": n, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": n_bytes, "ops": n_ops, "achieved_bytes_per_s": n_bytes / (ms * 1e-3),
                   "share_of_bound": max(t_bytes, t_ops) * 1e3 / ms,
                   "int8_yardstick": name.replace("int4", "int8"), "int8_ms": int8_ms,
                   "int8_bytes": i8_bytes, "int8_over_int4": int8_ms / ms,
                   "library_ms": None,
                   "library_ms_reason": "no PyTorch call computes an int4 matvec"}
            rows[name] = row
            emit({"phase": "int4_timing", **row})
        timing[n] = rows
        del w_i8
    path_ms = min(runs["int4"]) / STEPS * 1e3
    emit({"phase": "int4_timing", "int4_path_device_step_ms": dev_ms["int4"],
          "int4_path_ms_per_step": path_ms,
          "int4_path_device_idle_share": 1.0 - dev_ms["int4"] / path_ms,
          "int4_mv_share_of_step": timing[N]["int4_mv"]["ms"] / path_ms})
    del nets, w14, wp14, x14, exact
    torch.cuda.empty_cache()
    r = timing[N]["int4_mv"]
    entry = {"name": "int4_mv[int4_path]", "route": "cuda", "source": I4_SOURCE,
             "replaces": I4_TPU_KERNEL, "launches": launches["int4"], "max_abs_err": 0.0,
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None}
    return entry, timing[N]


def int4_train_phases(dev, data, timing10) -> list:
    """Phases 18-19: the training path with an int4_master coupling (one
    warm and one timed 16-epoch fit) and with a bfloat16_master coupling (4
    epochs).  ``timing10`` is phase 17's N=10,000 timing.  Returns the
    int4 kernels' entries of the ``kernels`` line for this path."""
    from rectipy_tpu_torch.ops.fused_opt import adam_requant
    from rectipy_tpu_torch.ops.quant import int4_mv, int4_mv_t, int8_mv, int8_mv_t

    W_np, etas, inp, tgt, _ = data
    inp_d = torch.as_tensor(inp, dtype=torch.float32, device=dev)
    tgt_d = torch.as_tensor(tgt, dtype=torch.float32, device=dev)
    kernels = (int4_mv, int4_mv_t, int8_mv, int8_mv_t, adam_requant)

    def counted_fit(net, epochs):
        for k in kernels:
            k.launches = 0
        seconds, losses = fit(net, inp_d, tgt_d, epochs, "on")
        return seconds, losses, {k.__name__: k.launches for k in kernels}

    # -------------------------------------------------- 18. int4_master
    t0 = time.perf_counter()
    net = build_train_net(W_np, etas, coupling="int4_master")
    build_s = time.perf_counter() - t0
    warm_s, warm_losses, _ = counted_fit(net, EPOCHS)
    seconds, losses, launches = counted_fit(net, EPOCHS)
    want = {"int4_mv": EPOCHS * T_TRAIN, "int4_mv_t": EPOCHS * T_TRAIN, "int8_mv": 0,
            "int8_mv_t": 0, "adam_requant": 0}
    if launches != want:
        raise AssertionError(f"int4_train_path: launches {launches}, expected {want}")
    if net.last_fit != {"trajectory": "chain", "fused_adam": False}:
        raise AssertionError(f"int4_train_path took {net.last_fit}")
    emit({"phase": "int4_train_path", "n": N, "T": T_TRAIN, "epochs": EPOCHS,
          "coupling": "int4_master", "build_s": build_s, "warm_fit_s": warm_s,
          "fit_s": seconds, "ms_per_epoch": seconds / EPOCHS * 1e3,
          "trained_neuron_updates_per_s": T_TRAIN * N * EPOCHS / seconds,
          "launches_per_fit": launches, "first_loss": warm_losses[0],
          "losses_timed_fit": losses})
    del net
    torch.cuda.empty_cache()

    # ------------------------------------------------ 19. bfloat16_master
    net = build_train_net(W_np, etas, coupling="bfloat16_master")
    seconds, losses, launches = counted_fit(net, 4)
    if any(launches.values()) or net.last_fit["trajectory"] != "chain":
        raise AssertionError(f"bf16_master_train_path: launches {launches}, {net.last_fit}")
    emit({"phase": "bf16_master_train_path", "n": N, "T": T_TRAIN, "epochs": 4,
          "coupling": "bfloat16_master", "fit_s": seconds, "ms_per_epoch": seconds / 4 * 1e3,
          "trained_neuron_updates_per_s": T_TRAIN * N * 4 / seconds, "losses": losses})
    del net
    torch.cuda.empty_cache()
    entries = []
    for name in ("int4_mv", "int4_mv_t"):
        r = timing10[name]
        entries.append({"name": f"{name}[int4_train_path]", "route": "cuda", "source": I4_SOURCE,
                        "replaces": I4_TPU_KERNEL, "launches": want[name], "max_abs_err": 0.0,
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rectipy_tpu_torch import Network, attach_fused_qif_step, random_connectivity
    from rectipy_tpu_torch.ops._build import build, build_generated
    from rectipy_tpu_torch.ops.kernels import qif_sfa_reference_step, qif_sfa_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    gen_sources = generic_sources()  # the generic kernel's generated sources
    jobs = [(f"rectipy_tpu_torch/csrc/{name}.cu", build, (name,)) for name in SOURCES] + [
        (f"rectipy_tpu_torch/_build/gen/ ({GENERIC_SOURCE} + a generated tail)",
         build_generated, ("generic_fused_step", src)) for src in gen_sources]
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc per source, together
        builds = list(pool.map(lambda job: job[1](*job[2]), jobs))
    for (source, _, _), built in zip(jobs, builds):
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        emit({"phase": "build", "source": source,
              "seconds": time.perf_counter() - t0, "nvcc_seconds": built.seconds,
              "library": os.path.basename(built.path), "ptxas": ptxas})

    # ------------------------------------------------------ 3. kernel check
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    W_np = random_connectivity(N, N, 0.1, normalize=True, rng=rng)  # bench.py's coupling
    etas = -5.0 + np.tan((np.pi / 2) * (2.0 * np.arange(1, N + 1) - N - 1) / (N + 1))
    w_build_s = time.perf_counter() - t0
    params = dict(dt=DT, tau=1.0, tau_s=1.0, tau_x=10.0, k=15.0, alpha=0.05,
                  thresh=100.0, v_reset=-100.0)

    def on_card(arrays):
        return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]

    cases = {  # inputs (v, s, x, eta, inp) and parameters; see TOL
        "reset": (on_card([rng.normal(size=N) * 80.0, rng.random(N), rng.random(N), etas,
                           rng.normal(size=N)]), params),
        "coupling": (on_card([rng.normal(size=N) * 1e-3, rng.random(N),
                              rng.random(N) * 1e-3, rng.normal(size=N) * 1e-3,
                              rng.normal(size=N) * 1e-3]), dict(params, k=1.0 / DT)),
    }
    v, s, x, eta, inp = cases["reset"][0]  # also the timing phase's inputs
    W32 = torch.as_tensor(W_np, dtype=torch.float32).to(dev)
    Ws = {"float32": W32, "bfloat16": W32.to(torch.bfloat16)}
    max_err = {}
    for name, W in Ws.items():
        for case, (vecs, p) in cases.items():
            out = qif_sfa_step(*vecs[:3], W, *vecs[3:], **p)
            torch.cuda.synchronize()
            ref = qif_sfa_reference_step(*vecs[:3], W, *vecs[3:], **p)
            rtol, atol = TOL[case]
            for got, r in zip(out, ref):
                torch.testing.assert_close(got, r, rtol=rtol, atol=atol)
            err = max(float((g - r).abs().max()) for g, r in zip(out, ref))
            max_err[name] = max(err, max_err.get(name, 0.0))
            mask, ref_mask = out[0] == p["v_reset"], ref[0] == p["v_reset"]
            if not torch.equal(mask, ref_mask):
                raise AssertionError(f"{name}, {case}: the reset masks differ")
            line = {"phase": "kernel_check", "w_dtype": name, "case": case, "n": N,
                    "max_abs_err": err, "rtol": rtol, "atol": atol,
                    "reset_neurons": int(mask.sum()), "coupling_build_s": w_build_s}
            if case == "reset" and not bool(mask.any()):
                raise AssertionError(f"{name}: no neuron was reset")
            if case == "coupling":
                # the check's power: the same step with every eighth term of
                # each row sum lost (as a dropped partial sum of one of the
                # kernel's eight warps would lose it) must fail on every row
                s_cut = vecs[1].clone()
                s_cut[::8] = 0.0
                cut = qif_sfa_reference_step(vecs[0], s_cut, vecs[2], W, *vecs[3:], **p)[0]
                margin = float(((cut - ref[0]).abs() / (atol + rtol * ref[0].abs())).min())
                if bool(mask.any()) or margin <= 1.0:
                    raise AssertionError(f"{name}: the coupling case reset neurons or "
                                         f"would pass a lost eighth of the row sums "
                                         f"(margin {margin})")
                line.update(v_out_range=[float(ref[0].min()), float(ref[0].max())],
                            lost_eighth_min_margin=margin)
            emit(line)

    # ---------------------------------------------------------- 4. main path
    def build_net(coupling: str, fused: bool, device=None):
        net = Network(DT, device=device)  # default: the current CUDA device
        net.add_diffeq_node(
            "qif", QIF_SFA, weights=W_np, source_var="s", target_var="s_in",
            input_var="I_ext", output_var="s", spike_var="spike", spike_def="v",
            op="qif_sfa_op", spike_threshold=1e2, spike_reset=-1e2,
            node_vars={"all/qif_sfa_op/eta": etas, "all/qif_sfa_op/alpha": 0.05,
                       "all/qif_sfa_op/k": 15.0},
            coupling_dtype=coupling)
        net.add_func_node("inp", 1, activation_function="tanh")
        net.add_edge("inp", "qif", rng=np.random.default_rng(1))
        net.compile()
        if fused:
            attach_fused_qif_step(net.get_node("qif"))
        return net

    run_kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=100,
                  verbose=False)
    inputs = bench_inputs(STEPS)
    nets, launches, step_ms = {}, {}, {}
    for coupling in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        net = build_net(coupling, fused=True)
        build_s = time.perf_counter() - t0
        qif_sfa_step.launches = 0
        t0 = time.perf_counter()
        obs = net.run(inputs, **run_kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches[coupling] = qif_sfa_step.launches
        if launches[coupling] != STEPS:
            raise AssertionError(f"{coupling}: {launches[coupling]} kernel launches for "
                                 f"{STEPS} steps")
        rec = obs.to_numpy(("qif", "s"))
        if rec.shape != (STEPS // 100,) or not np.all(np.isfinite(rec)):
            raise AssertionError(f"{coupling}: bad records, shape {rec.shape}")
        times = []
        for _ in range(3):
            net.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            obs = net.run(inputs, **run_kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rec = obs.to_numpy(("qif", "s"))
        if not np.all(np.isfinite(rec)):
            raise AssertionError(f"{coupling}: non-finite records in a timed run")
        best = min(times)
        step_ms[coupling] = best / STEPS * 1e3
        nets[coupling] = net
        emit({"phase": "main_path", "coupling": coupling, "n": N, "steps": STEPS,
              "kernel_launches": launches[coupling], "build_s": build_s,
              "first_run_s": first_s, "run_s": times, "best_s": best,
              "ms_per_step": step_ms[coupling], "neuron_updates_per_s": STEPS * N / best,
              "mean_s_range": [float(rec.min()), float(rec.max())],
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})

    # ----------------------------------------------------- 5. fused vs plain
    plain = build_net("bfloat16", fused=False)
    fused = nets["bfloat16"]
    cmp_kw = dict(record_output=False, record_vars=[("qif", "s", True)], sampling_steps=10,
                  verbose=False)
    short = bench_inputs(PLAIN_STEPS)
    recs = {}
    for name, net in (("plain", plain), ("fused", fused)):
        net.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs[name] = net.run(short, **cmp_kw).to_numpy(("qif", "s"))
        recs[name + "_s"] = time.perf_counter() - t0
    ref, got = recs["plain"], recs["fused"]
    max_diff = float(np.abs(got - ref).max())
    corr = float(np.corrcoef(got, ref)[0, 1]) if ref.std() > 0 else float("nan")
    if not (corr >= 0.999 and max_diff <= 1e-2 * float(np.abs(ref).max())):
        raise AssertionError(f"fused vs plain: corr {corr}, max|diff| {max_diff}")
    emit({"phase": "fused_vs_plain", "coupling": "bfloat16", "steps": PLAIN_STEPS,
          "records": int(ref.shape[0]), "corr": corr, "max_abs_diff": max_diff,
          "max_abs_ref": float(np.abs(ref).max()), "plain_run_s": recs["plain_s"],
          "fused_run_s": recs["fused_s"]})
    del plain

    # ------------------------------------------------------------- 6. timing
    kernels = []
    for name, W in Ws.items():
        itemsize = W.element_size()
        n_bytes = N * N * itemsize + 5 * 4 * N + 3 * 4 * N  # W, 5 vectors in, 3 out
        n_ops = 2 * N * N + 20 * N  # the matvec's FMAs plus the epilogue
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS) * 1e3
        bound_by = "bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / F32_FLOPS else "operations"
        ms = cuda_ms(lambda: qif_sfa_step(v, s, x, W, eta, inp, **params), reps=200)
        plain_ms = cuda_ms(lambda: qif_sfa_reference_step(v, s, x, W, eta, inp, **params),
                           reps=20)
        s_w = s.to(W.dtype)
        library_ms = cuda_ms(lambda: torch.mv(W, s_w), reps=200)
        # the main path's whole network step on the device alone (no host
        # gaps): the kernel plus the step's other small kernels
        step = nets[name].make_step()
        state, net_params = nets[name].init_state(), nets[name].parameters_pytree()
        x_t = torch.full((1,), 3.0, device=dev)
        with torch.no_grad():
            device_step_ms = cuda_ms(lambda: step(state, net_params, x_t), reps=200)
        entry = {"name": f"qif_sfa_step[{name}]", "route": "cuda", "source": KERNEL_SOURCE,
                 "replaces": TPU_KERNEL, "launches": launches[name],
                 "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
        kernels.append(entry)
        emit({"phase": "timing", **entry, "bytes": n_bytes, "ops": n_ops,
              "kernel_share_of_step": ms / step_ms[name], "step_ms": step_ms[name],
              "device_step_ms": device_step_ms,
              "device_idle_share": 1.0 - device_step_ms / step_ms[name],
              "achieved_bytes_per_s": n_bytes / (ms * 1e-3)})

    del Ws, W32, W, s_w, step, state, net_params, cases, v, s, x, eta, inp
    kernels += generic_phases(W_np, build_net, nets["bfloat16"])
    del nets, fused
    torch.cuda.empty_cache()
    entry, timing10 = int4_phases(W_np, build_net)
    kernels.append(entry)
    del W_np
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data = bench_training_data(N)
    data_s = time.perf_counter() - t0
    kernels += train_phases(dev, data + (data_s,))
    kernels += int4_train_phases(dev, data + (data_s,), timing10)

    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
