"""Fixtures of portbench's CPU tests: a copy of the benchmark's folder with
toy configurations, mixes and cells beside the real ones, run on the CPU
through the program's plain kernel versions."""

import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TOY_SEED = 2 ** 31 + 4099
TOY_CELLS = {"toy.dense.single": ("toy_dense", "toy_single"),
             "toy.dense.sweep": ("toy_dense", "toy_sweep"),
             "toy.blocks.single": ("toy_blocks", "toy_single"),
             "toy.blocks.sweep": ("toy_blocks", "toy_sweep")}


def _write(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture
def toy_bench(tmp_path):
    """``(bench_json, bench_dir)``: the benchmark's folder copied, with the
    real configurations cut to a toy N and the mixes to 201 steps and at
    most 4 trials, as four cells of their own, and a BENCHMARK.json that
    lists them under the real metrics."""
    src = os.path.join(ROOT, "portbench")
    bench_dir = str(tmp_path / "portbench")
    shutil.copytree(src, bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(src, "configs", "qif_sfa_10k_bf16.json")) as f:
        dense = json.load(f)
    with open(os.path.join(src, "configs", "qif_sfa_1m_blocks_int8.json")) as f:
        blocks = json.load(f)
    _write(os.path.join(bench_dir, "configs", "toy_dense.json"), {**dense, "n": 256, "fan_in": 25})
    _write(os.path.join(bench_dir, "configs", "toy_blocks.json"),
           {**blocks, "n": 512, "block_size": 64, "source_blocks": 2, "fan_in": 40})
    for name, mix in (("toy_single", "single"), ("toy_sweep", "sweep_b32")):
        with open(os.path.join(src, "traffic", mix + ".json")) as f:
            m = json.load(f)
        _write(os.path.join(bench_dir, "traffic", name + ".json"),
               {**m, "steps": 201, "trials": min(m["trials"], 4)})
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    groups = {"qif10k": ("toy.dense.single", "toy.dense.sweep"),
              "qif1m": ("toy.blocks.single", "toy.blocks.sweep")}
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "toy"}
                          for n, (c, t) in TOY_CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({toy for w in m["workloads"]
                                     for toy in groups[w.split(".")[0]]})
    for name in TOY_CELLS:
        _write(os.path.join(bench_dir, "limits", name + ".json"), {"v_gap_q99": {"limit": 1e-5}})
    bench_json = str(tmp_path / "BENCHMARK.json")
    _write(bench_json, bench)
    return bench_json, bench_dir


@pytest.fixture
def cuda_device():
    """The card, or a skip: for the tests marked ``gpu``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
