"""portbench/counts/ against chip_smoke.py's bounds at the kernel table's
shapes (PERF.md, the kernel table's "bound ms" column: each input read and
each output written once over 3.35 TB/s, or the operations over their
peak, the larger)."""

import pytest

from portbench import harness, peaks

# (count, configuration, trials, bound ms as the kernel table gives it)
TABLE = [
    ("qif_sfa_step", {"n": 10_000, "coupling_dtype": "bfloat16"}, 1, 0.05980),
    ("qif_sfa_step", {"n": 10_000, "coupling_dtype": "float32"}, 1, 0.11950),
    ("qif_sfa_rows", {"n": 10_000, "coupling_dtype": "bfloat16"}, 32, 0.06276),
    ("qif_sfa_rows", {"n": 10_000, "coupling_dtype": "bfloat16"}, 16, 0.06123),
    ("qif_sfa_rows", {"n": 10_000, "coupling_dtype": "float32"}, 32, 0.12246),
    ("block_int8_mv", {"n": 1_000_448, "block_size": 512, "source_blocks": 4}, 1, 0.61431),
    ("block_int8_mv", {"n": 1_000_448, "block_size": 512, "source_blocks": 4}, 16, 0.63671),
    ("block_int8_mv", {"n": 1_000_448, "block_size": 512, "source_blocks": 4}, 32, 0.66060),
]


def _count(name):
    return harness.load_module(f"{harness.HERE}/counts/{name}.py")


@pytest.mark.parametrize("name,cfg,trials,bound_ms", TABLE)
def test_counts_match_the_kernel_table(name, cfg, trials, bound_ms):
    c = _count(name).count(cfg, {"trials": trials})
    least_ms = peaks.least_seconds(c["bytes"], c["ops"], c["peak_ops"]) * 1e3
    assert least_ms == pytest.approx(bound_ms, abs=5e-6)


@pytest.mark.parametrize("name", ["qif_sfa_step", "qif_sfa_rows", "block_int8_mv"])
def test_kernel_names_are_the_programs(name):
    """Each count names kernels that the program's CUDA sources define."""
    assert set(_count(name).KERNELS) <= harness.handwritten_kernels()


@pytest.mark.parametrize("config,trials,gb", [
    ("qif_sfa_10k_bf16", 1, 0.2003), ("qif_sfa_10k_bf16", 32, 0.2090),
    ("qif_sfa_1m_blocks_int8", 1, 2.0809), ("qif_sfa_1m_blocks_int8", 16, 2.5011)])
def test_step_count(config, trials, gb):
    """The whole step: the coupling once (200 MB of bf16 W; 2.05 GB of int8
    blocks and their row scales), 24 bytes a neuron and trial for the three
    states read and written, the etas once (once a trial when swept), the
    input weights; never less than the coupling kernel's stream of W."""
    cfg = harness.load_json(f"{harness.HERE}/configs/{config}.json")
    mix = {"trials": trials}
    step = _count(cfg["step_count"]).count(cfg, mix)
    assert step["bytes"] / 1e9 == pytest.approx(gb, abs=5e-5)
    kernel = "block_int8_mv" if cfg["coupling"] == "blocks" else (
        "qif_sfa_rows" if trials > 1 else "qif_sfa_step")
    k = _count(kernel).count(cfg, mix)
    assert step["peak_ops"] == k["peak_ops"] and step["ops"] >= 0.99 * k["ops"]
