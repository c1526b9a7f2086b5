"""A run of a cell at toy size on the CPU: its result line and its check."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import calls, harness
from portbench.tests.conftest import ROOT, TOY_CELLS, TOY_SEED

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
def test_result_line(toy_bench, cell):
    bench_json, bench_dir = toy_bench
    result, lines = harness.run_cell(cell, TOY_SEED, 0.3, False, device="cpu",
                                     bench_path=bench_json, bench_dir=bench_dir)
    assert list(result) == RESULT_KEYS  # the check comes last
    json.dumps(result)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    group = "qif10k" if ".dense." in cell else "qif1m"
    want = {f"nu_per_s.{group}", "setup_s"} | ({"call_ms_p95"} if group == "qif10k" else set())
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["check"]["v_gap_q99"]["limit"] == 1e-5
    assert lines[-1] == "correct: true" and lines[0].startswith("check v_gap_q99: ")


def test_run_refuses_without_a_card():
    """No result where the cell's cards are missing (this sandbox has none),
    and none for a cell that is not there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cell in ("qif10k.run", "no.such.cell"):
        proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                               str(TOY_SEED), "--seconds", "1", "--trace", "0"],
                              cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and proc.stdout == ""


def test_calls_repeat_from_the_seed():
    """A call is the same for the same seed and index, another for another
    seed, with the same shapes."""
    with open(os.path.join(ROOT, "portbench", "traffic", "sweep_b32.json")) as f:
        mix = json.load(f)
    a = calls.make_call(mix, 64, TOY_SEED, 5, "cpu")
    b = calls.make_call(mix, 64, TOY_SEED, 5, "cpu")
    c = calls.make_call(mix, 64, TOY_SEED + 1, 5, "cpu")
    assert torch.equal(a.drive, b.drive) and torch.equal(a.v0, b.v0)
    assert torch.equal(a.offsets, b.offsets)
    assert not torch.equal(a.v0, c.v0)
    assert a.drive.shape == c.drive.shape == (mix["steps"], 1) and a.offsets.shape == (32,)
    lo, hi = mix["drive"]["amplitude"]
    assert lo <= float(a.drive.max()) <= hi
    assert int((a.drive > 0).sum()) == int(mix["drive"]["length"] * mix["steps"])


def test_reservoir_keeps_a_seeded_sample():
    def kept(seed, n):
        r = calls.Reservoir(3, seed)
        for i in range(n):
            r.offer(i, None)
        return sorted(i for i, _ in r.kept)

    assert kept(1, 2) == [0, 1]
    assert kept(1, 50) == kept(1, 50)
    assert len(kept(1, 50)) == 3
    assert len({tuple(kept(s, 50)) for s in range(8)}) > 1


def test_gap_percentile():
    from portbench.check import judge, v_gap_q99

    ref = torch.linspace(-100, 100, 1000).reshape(1, 1, 1000)
    assert v_gap_q99(ref.clone(), ref) == 0.0
    got = ref.clone()
    got[0, 0, :5] += 50.0  # five neurons a spike apart: below the 99th percentile
    assert v_gap_q99(got, ref) == 0.0
    got[0, 0, :20] += 50.0  # 2% of the neurons off
    assert v_gap_q99(got, ref) > 0.1
    nan = ref.clone()
    nan[0, 0, :] = float("nan")
    assert v_gap_q99(nan, ref) == float("inf")
    assert judge({"v_gap_q99": 1e-6}, {"v_gap_q99": {"limit": 1e-5}})[0] is True
    assert judge({"v_gap_q99": 1e-4}, {"v_gap_q99": {"limit": 1e-5}})[0] is False
    assert judge({"v_gap_q99": 1e-6}, {})[0] is False
    assert np.isclose(judge({"v_gap_q99": 1e-6}, {"v_gap_q99": {"limit": 1e-5}})[1]
                      ["v_gap_q99"]["limit"], 1e-5)
