"""The reduction of a profiled stretch, on made-up events."""

import pytest
import torch

from portbench import devtrace
from portbench.harness import run_cell
from portbench.tests.conftest import TOY_SEED


class Ev:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU


EVENTS = [
    Ev("portbench.call", 0, 1000, False), Ev("portbench.run", 10, 980, False),
    Ev("aten::mm", 100, 50, False), Ev("cudaLaunchKernel", 120, 10, False),
    Ev("portbench.run", 10, 980, True),  # the span's annotation on the device's timeline
    Ev("kernel_a", 200, 300, True), Ev("kernel_b", 400, 200, True),
    Ev("Memcpy DtoH (Device -> Pageable)", 800, 100, True),
]


def test_device_ops_and_busy_union():
    host, dev = devtrace.split_events(EVENTS)
    assert [n for _, _, n in dev] == ["kernel_a", "kernel_b", "Memcpy DtoH (Device -> Pageable)"]
    tr = devtrace.reduce_device(dev, steps=4, window_ns=1000)
    assert tr.busy_ns == 500  # [200, 600) and [800, 900)
    assert [k for _, k, _ in tr.ops] == ["kernel", "kernel", "copy"]
    assert tr.device_ops[0][0] == "kernel_a" and tr.device_ops[0][1] == pytest.approx(300e-9)


def test_idle_gaps_named_by_the_host():
    gaps = dict(devtrace.idle_gaps(*devtrace.split_events(EVENTS)))
    # [0, 200): its middle at 100 lies in aten::mm inside portbench.run
    assert gaps["portbench.run / aten::mm"] == pytest.approx(200e-9)
    assert gaps["portbench.run"] == pytest.approx(300e-9)  # [600, 800) and [900, 1000)


@pytest.mark.gpu
def test_traced_run_on_the_card(cuda_device):
    """A short traced run of each cell: every per-layer metric read, shares
    within 100%, the device busy within the window."""
    from portbench.harness import Cell, ROOT

    import os

    for cell in ("qif10k.sweep_b32", "qif10k.run"):
        result, _ = run_cell(cell, TOY_SEED, 4.0, True, device=cuda_device)
        want = {m["name"] for m in Cell(os.path.join(ROOT, "BENCHMARK.json"), cell).metrics(
            "per_layer")}
        assert set(result["metrics"]) == want and result["correct"]
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name, m in result["metrics"].items():
            if m["unit"] == "%":
                assert 0 < m["value"] <= 100, name
