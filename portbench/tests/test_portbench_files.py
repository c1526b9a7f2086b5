"""BENCHMARK.json against the rules of its format, and a cell, a mix and a
per-layer metric added as files alone."""

import json
import os
import re

import pytest

from portbench import harness
from portbench.readers import Reading
from portbench.tests.conftest import ROOT, TOY_SEED

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_its_format():
    b = _bench()
    assert set(b) == KEYS
    assert 1 <= len(b["paths"]) <= 16 and b["command"][1].startswith(b["paths"][0] + "/")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in b["end_to_end"] + b["per_layer"])
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert cfg["reduced"] == c["reduced"]
    pairs = set()
    four = 0
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.Cell(os.path.join(ROOT, "BENCHMARK.json"), w["name"])
        reported = [m["name"] for m in cell.metrics("end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2 and cell.metrics("per_layer")
        assert os.path.exists(os.path.join(harness.HERE, "limits", w["name"] + ".json"))
        for m in cell.metrics("per_layer"):
            assert m["moves"] in reported and cell.reader(m["name"]).read
    assert four <= max(1, len(b["workloads"]) // 4)
    assert len(json.dumps(b)) <= 64 * 1024


def test_a_cell_added_as_files_alone(toy_bench):
    """A new configuration, mix, per-layer metric, limits file and cell,
    each a file or an entry of its own, found by name with nothing else
    edited."""
    bench_json, bench_dir = toy_bench
    with open(bench_json) as f:
        bench = json.load(f)
    cfg = harness.load_json(os.path.join(bench_dir, "configs", "toy_dense.json"))
    with open(os.path.join(bench_dir, "configs", "toy_other.json"), "w") as f:
        json.dump({**cfg, "n": 128, "fan_in": 13}, f)
    mix = harness.load_json(os.path.join(bench_dir, "traffic", "toy_sweep.json"))
    with open(os.path.join(bench_dir, "traffic", "toy_pairs.json"), "w") as f:
        json.dump({**mix, "trials": 2, "steps": 101}, f)
    with open(os.path.join(bench_dir, "metrics", "trials_per_call.py"), "w") as f:
        f.write("def read(r):\n    return r.mix['trials']\n")
    with open(os.path.join(bench_dir, "limits", "toy.other.pairs.json"), "w") as f:
        json.dump({"v_gap_q99": {"limit": 1e-5}}, f)
    bench["workloads"].append({"name": "toy.other.pairs", "config": "toy_other",
                               "traffic": "toy_pairs", "chips": 1, "why": "added as files"})
    bench["per_layer"].append({"name": "trials_per_call", "unit": "trials", "better": "higher",
                               "source": "host_clock", "layer": "traffic",
                               "moves": "nu_per_s.qif10k", "workloads": ["toy.other.pairs"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("nu_per_s.qif10k", "call_ms_p95"):
            m["workloads"].append("toy.other.pairs")
    with open(bench_json, "w") as f:
        json.dump(bench, f)
    cell = harness.Cell(bench_json, "toy.other.pairs", bench_dir)
    assert cell.cfg["n"] == 128 and cell.mix["trials"] == 2
    assert "trials_per_call" in [m["name"] for m in cell.metrics("per_layer")]
    reading = Reading(cell.cfg, cell.mix, cell.count, cell.kernels_of, 1.0, 1, None,
                      frozenset(), 0.0)
    assert cell.reader("trials_per_call").read(reading) == 2
    assert cell.reader("step_mfu.qif10k").read(reading) > 0  # the quantity's reader
    result, _ = harness.run_cell("toy.other.pairs", TOY_SEED, 0.3, False, device="cpu",
                                 bench_path=bench_json, bench_dir=bench_dir)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"nu_per_s.qif10k", "call_ms_p95", "setup_s"}


def test_readers_find_nothing_without_a_trace():
    cell = harness.Cell(os.path.join(ROOT, "BENCHMARK.json"), "qif10k.run")
    reading = Reading(cell.cfg, cell.mix, cell.count, cell.kernels_of, 0.0, 0, None,
                      frozenset(), 1.0)
    for m in cell.metrics("per_layer"):
        value = cell.reader(m["name"]).read(reading)
        assert value is None or m["name"] == "network_build_s"
