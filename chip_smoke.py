#!/usr/bin/env python3
"""Smoke run of rectipy_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. device: the card's name and power limit (nvidia-smi), PyTorch and CUDA.
2. build: compiles the CUDA kernel from rectipy_tpu_torch/csrc/ with nvcc
   (sm_90a) and prints the compile time and ptxas's register report.
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

import numpy as np
import torch

N = 10_000
DT = 1e-4
STEPS = 20_000
PLAIN_STEPS = 2_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
QIF_SFA = "rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa"
KERNEL_SOURCE = "rectipy_tpu_torch/csrc/qif_sfa_step.cu"
TPU_KERNEL = "rectipy_tpu/ops/kernels.py:53"
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


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls.

    The card first spins for ~0.1 s while the host queues every call, so the
    events time the device work alone, not the host's launch rate."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rectipy_tpu_torch import Network, attach_fused_qif_step, random_connectivity
    from rectipy_tpu_torch.ops._build import build
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
    built = build("qif_sfa_step")
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": built.seconds,
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
    def build_net(coupling: str, fused: bool):
        net = Network(DT)  # the current CUDA device
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

    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
