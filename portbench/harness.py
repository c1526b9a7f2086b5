"""One cell of the port's benchmark, from its files to its result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness finds everything else by those names:

- ``portbench/configs/<config>.json``: the configuration, whose ``family``
  names ``portbench/families/<family>.py`` (the raw inputs and the program)
  and ``portbench/reference/<family>.py`` (the plain reference);
- ``portbench/traffic/<mix>.json``: the mix (``portbench/calls.py``);
- ``portbench/metrics/<metric>.py``: each per-layer metric's reader;
- ``portbench/counts/<name>.py``: a kernel's or a step's bytes and operations;
- ``portbench/limits/<cell>.json``: the limits of the correctness check.

A run makes the raw inputs from the seed, builds the program, warms up with
calls of the cell's own shapes, measures a closed loop of calls for the
given seconds, and then checks a sample of the window's calls against the
reference (``portbench/check.py``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import re
import sys
import time

import numpy as np
import torch

from portbench import calls as calls_mod
from portbench import check
from portbench.readers import Reading

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rectipy_tpu")
PROGRAM = "rectipy_tpu_torch"


def forbidden_modules(names) -> list:
    """The modules among ``names`` whose top-level name (before the first
    dot), compared whole, is JAX's, Flax's or the JAX package's."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def quantity(metric: str) -> str:
    """What a metric measures: its name up to the first dot.  The rest names
    the cells it is kept for (``nu_per_s.qif1m``: the neuron updates a
    second of the ``qif1m.*`` cells, under a bound of their own)."""
    return metric.split(".")[0]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    name = "portbench_file_" + re.sub(r"\W", "_", os.path.relpath(path, HERE))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of ``BENCHMARK.json`` and the files its names lead to, under
    ``bench_dir`` (the folder of ``portbench``'s data and readers)."""

    def __init__(self, bench_path: str, workload: str, bench_dir: str = HERE):
        self.bench = load_json(bench_path)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no cell {workload!r} in {bench_path}; cells: {sorted(cells)}")
        self.name, self.dir = workload, bench_dir
        self.entry = cells[workload]
        self.cfg = load_json(os.path.join(bench_dir, "configs", self.entry["config"] + ".json"))
        self.mix = load_json(os.path.join(bench_dir, "traffic", self.entry["traffic"] + ".json"))
        self.family = load_module(os.path.join(bench_dir, "families", self.cfg["family"] + ".py"))
        self.reference = load_module(
            os.path.join(bench_dir, "reference", self.cfg["family"] + ".py"))
        limits = os.path.join(bench_dir, "limits", workload + ".json")
        self.limits = load_json(limits) if os.path.exists(limits) else {}

    def metrics(self, kind: str) -> list:
        """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) this cell
        reports: those listing it, and those without a list whose end-to-end
        metric it reports."""
        e2e = {m["name"] for m in self.bench["end_to_end"]
               if "workloads" not in m or self.name in m["workloads"]}
        out = []
        for m in self.bench[kind]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def count(self, name: str) -> dict:
        return self.counts_module(name).count(self.cfg, self.mix)

    def kernels_of(self, name: str) -> tuple:
        return self.counts_module(name).KERNELS

    def reader(self, metric: str):
        """``metrics/<metric>.py``, or the reader of its quantity,
        ``metrics/<quantity(metric)>.py``, where the metric has none of its own."""
        own = os.path.join(self.dir, "metrics", metric + ".py")
        if os.path.exists(own):
            return load_module(own)
        return load_module(os.path.join(self.dir, "metrics", quantity(metric) + ".py"))

    def counts_module(self, name: str):
        return load_module(os.path.join(self.dir, "counts", name + ".py"))


def handwritten_kernels() -> frozenset:
    """The ``__global__`` functions of the program's CUDA sources, read from
    its ``csrc/`` folder (the names its kernels carry in a device trace)."""
    spec = importlib.util.find_spec(PROGRAM)
    csrc = os.path.join(os.path.dirname(spec.origin), "csrc")
    names = set()
    for fname in sorted(os.listdir(csrc)):
        if fname.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, fname)) as f:
                text = f.read()
            names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                                    r"(\w+)\s*\(", text))
    return frozenset(names)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             bench_path: str = None, bench_dir: str = HERE, t_start: float = None,
             log=None) -> tuple:
    """Run one cell.  Returns ``(result, check_lines)``: the result line's
    object and the lines that give each compared number beside its limit.
    ``log(text)`` takes the progress lines (standard error in ``run.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda text: None)
    cell = Cell(bench_path or os.path.join(ROOT, "BENCHMARK.json"), workload, bench_dir)
    cfg, mix, family = cell.cfg, cell.mix, cell.family
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, T, B = cfg["n"], mix["steps"], mix["trials"]

    # set-up: the raw inputs, the program, calls of the cell's shapes
    t0 = time.perf_counter()
    inputs = family.make_inputs(cfg, seed, device)
    sync(device)
    t1 = time.perf_counter()
    program = family.Program(cfg, mix, inputs, device)
    sync(device)
    network_build_s = time.perf_counter() - t1
    del inputs
    gc.collect()
    for i in range(mix["warmup_calls"]):
        program.call(calls_mod.make_call(mix, n, seed, i, device, calls_mod.WARMUP))
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup: inputs from {t0 - t_start:.3f} s, {t1 - t0:.3f} s; network build "
        f"{network_build_s:.3f} s; warm-up calls {setup_s - network_build_s - (t1 - t_start):.3f} "
        f"s; set-up {setup_s:.3f} s; {nvcc_line()}")

    sample = calls_mod.Reservoir(mix["check_calls"], seed)
    call_ms, done = [], [0]

    def one_call(i: int) -> None:
        c0 = time.perf_counter()
        with torch.profiler.record_function(calls_mod.CALL_SPAN):
            with torch.profiler.record_function("portbench.drive"):
                c = calls_mod.make_call(mix, n, seed, i, device)
            records = program.call(c)
        call_ms.append((time.perf_counter() - c0) * 1e3)
        sample.offer(i, records)
        done[0] += 1

    counters0 = family.Program.counters()
    trace_s = min(mix["trace_seconds"], seconds / 2) if trace else 0.0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds - trace_s:
        one_call(done[0])
    w1 = time.perf_counter()
    untraced_calls = done[0]
    tr = None
    if trace:
        from portbench import devtrace

        def calls_for(min_s: float):
            def run() -> int:
                first, s0 = done[0], time.perf_counter()
                while done[0] == first or time.perf_counter() - s0 < min_s:
                    one_call(done[0])
                return (done[0] - first) * T
            return run

        tr = devtrace.trace_stretches(calls_for(trace_s), calls_for(trace_s / 2))
    sync(device)
    w2 = time.perf_counter()
    counters = {k: v - counters0[k] for k, v in family.Program.counters().items()}
    q = np.percentile(call_ms, [5, 50, 95])
    log(f"calls: ms 5th {q[0]:.3f}, median {q[1]:.3f}, 95th {q[2]:.3f}; the first five "
        f"{[round(x, 3) for x in call_ms[:5]]}, the last five {[round(x, 3) for x in call_ms[-5:]]}")
    log(f"window: {done[0]} calls in {w2 - w0:.3f} s ({untraced_calls} in {w1 - w0:.3f} s before "
        f"the profiled stretch); counters {counters}")
    if tr is not None:
        log(f"profiled stretch: {tr.steps} steps in {tr.window_ns * 1e-9:.3f} s "
            f"({tr.window_ns * 1e-6 / max(tr.steps, 1):.5f} ms a step; before it "
            f"{(w1 - w0) * 1e3 / max(untraced_calls * T, 1):.5f}); both stretches and their "
            f"reading took {w2 - w1:.3f} s")
    info = device_info(device, cell.entry["chips"])

    metrics = {}
    if not trace:
        values = {"setup_s": setup_s,
                  "nu_per_s": done[0] * T * B * n / (w2 - w0),
                  "call_ms_p95": float(np.percentile(call_ms, 95))}
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": values[quantity(m["name"])], "unit": m["unit"]}
    else:
        reading = Reading(cfg, mix, cell.count, cell.kernels_of, w1 - w0, untraced_calls * T, tr,
                          handwritten_kernels(), network_build_s)
        for m in cell.metrics("per_layer"):
            value = cell.reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the check, once the program's state is freed
    kept = sorted(sample.kept, key=lambda kv: kv[0])
    del program
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    numbers = check_calls(cell, seed, kept, device)
    correct, compared = check.judge(numbers, cell.limits)
    log(f"check: calls {[i for i, _ in kept]} against the reference in "
        f"{time.perf_counter() - c0:.3f} s")

    result = {"correct": correct, "attempted": done[0], "failed": 0, "metrics": metrics,
              "device": info}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_ns * 1e-9
        result["device"]["window_s"] = tr.window_ns * 1e-9
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["check"] = compared
    lines = [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in compared.items()]
    lines.append(f"correct: {str(correct).lower()}")
    return result, lines


def check_calls(cell: Cell, seed: int, kept: list, device) -> dict:
    """The compared numbers of the calls ``kept`` (``[(index, records)]``)
    against the reference at the configuration's precision, each call made
    again from the seed."""
    cfg, mix = cell.cfg, cell.mix
    inputs = cell.family.make_inputs(cfg, seed, device)
    coupling = cell.reference.Coupling(cfg, inputs, cfg["precision"])
    key = tuple(cell.family.COMPARED)
    worst = 0.0
    for index, records in kept:
        c = calls_mod.make_call(mix, cfg["n"], seed, index, device)
        ref = cell.reference.simulate(cfg, inputs, coupling, mix, c)
        worst = max(worst, check.v_gap_q99(torch.as_tensor(records[key], device=device), ref[key]))
    return {check.NUMBER: worst if kept else math.inf}


def nvcc_line() -> str:
    """The program's kernel builds in this process: nvcc seconds by library
    (0.0 where a build in the checkout was reused)."""
    built = sys.modules.get(PROGRAM + ".ops._build")
    if built is None:
        return "no kernel built"
    libs = {os.path.basename(b.path): round(b.seconds, 3) for b in built._built.values()}
    return f"nvcc seconds {libs}"
