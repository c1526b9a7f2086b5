"""The check against faults planted underneath a toy run, and against the
control: each has to come out not correct.

The harness runs as it does on the card, but on the CPU (no look for a
card), with the program's timed path broken: a step that returns its state
unchanged; half of the trials left out of each step; an answer altered
where it is produced (one record of one trial).  The control is the plain
reference at the configuration's ``control_precision`` put in the
program's place.  A run on one chip has no exchange between chips to
leave out."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import TOY_CELLS, TOY_SEED
from rectipy_tpu_torch import network


def _run(toy_bench, cell):
    bench_json, bench_dir = toy_bench
    return harness.run_cell(cell, TOY_SEED, 0.3, False, device="cpu", bench_path=bench_json,
                            bench_dir=bench_dir)[0]


def _break_steps(monkeypatch, broken):
    make_step = network.Network.make_step

    def patched(self, *args, **kwargs):
        step = make_step(self, *args, **kwargs)
        return lambda state, params, x: broken(step, state, params, x)

    monkeypatch.setattr(network.Network, "make_step", patched)


def _state_unchanged(step, state, params, x):
    _, out, taps = step(state, params, x)
    return state, out, taps


def _half_left_out(step, state, params, x):
    new, out, taps = step(state, params, x)
    nodes = dict(new["nodes"])
    for label, y in nodes.items():
        if y is not None and y.dim() == 2:  # B trials: the second half keeps its state
            y = y.clone()
            y[y.shape[0] // 2:] = state["nodes"][label][y.shape[0] // 2:]
            nodes[label] = y
    return {**new, "nodes": nodes}, out, taps


@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
def test_unbroken_program_is_correct(toy_bench, cell):
    assert _run(toy_bench, cell)["correct"] is True


@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
def test_state_unchanged_is_caught(toy_bench, monkeypatch, cell):
    _break_steps(monkeypatch, _state_unchanged)
    result = _run(toy_bench, cell)
    assert result["correct"] is False and result["check"]["v_gap_q99"]["value"] > 1e-3


@pytest.mark.parametrize("cell", [c for c in sorted(TOY_CELLS) if c.endswith(".sweep")])
def test_half_of_the_trials_left_out_is_caught(toy_bench, monkeypatch, cell):
    _break_steps(monkeypatch, _half_left_out)
    result = _run(toy_bench, cell)
    assert result["correct"] is False and result["check"]["v_gap_q99"]["value"] > 1e-3


@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
def test_an_answer_altered_is_caught(toy_bench, monkeypatch, cell):
    assemble = network.Network._assemble_windowed_records

    def altered(*args, **kwargs):
        outs, rec_vars = assemble(*args, **kwargs)
        for key, val in rec_vars.items():
            if key == ("qif", "v"):  # the last record of the first trial
                val = val.clone()
                val[(0, -1) if val.dim() == 3 else (-1,)] += 1.0
                rec_vars[key] = val
        return outs, rec_vars

    monkeypatch.setattr(network.Network, "_assemble_windowed_records", staticmethod(altered))
    result = _run(toy_bench, cell)
    assert result["correct"] is False and result["check"]["v_gap_q99"]["value"] > 1e-3


@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
def test_control_is_not_correct(toy_bench, monkeypatch, cell):
    """The reference at the next precision below the configuration's, in
    the program's place."""
    bench_json, bench_dir = toy_bench
    spec = harness.Cell(bench_json, cell, bench_dir)
    cfg, mix, ref = spec.cfg, spec.mix, spec.reference

    class Control:
        def __init__(self, cfg, mix, inputs, device):
            self.inputs = inputs
            self.coupling = ref.Coupling(cfg, inputs, cfg["control_precision"])

        def call(self, call):
            recs = ref.simulate(cfg, self.inputs, self.coupling, mix, call)
            return {k: np.asarray(v) for k, v in recs.items()}

        counters = staticmethod(lambda: {})

    monkeypatch.setattr(spec.family, "Program", Control)
    result = _run(toy_bench, cell)
    assert result["correct"] is False
    assert result["check"]["v_gap_q99"]["value"] > 2 * result["check"]["v_gap_q99"]["limit"]
