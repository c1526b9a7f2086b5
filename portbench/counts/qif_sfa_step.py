"""One single-trial fused QIF+SFA step: ``qif_sfa_step_kernel`` of
``rectipy_tpu_torch/csrc/qif_sfa_step.cu``.

W read once; the five vectors v, s, x, eta and the input read and the three
states written once, float32; the matvec's multiply-adds and 20 operations
a neuron (``chip_smoke.py``'s count, phase 6)."""

from portbench.peaks import OPS_PEAK

KERNELS = ("qif_sfa_step_kernel",)


def count(cfg: dict, mix: dict) -> dict:
    n = cfg["n"]
    w_bytes = 2 if cfg["coupling_dtype"] == "bfloat16" else 4
    return {"bytes": n * n * w_bytes + 5 * 4 * n + 3 * 4 * n,
            "ops": 2 * n * n + 20 * n,
            "peak_ops": OPS_PEAK[cfg["coupling_dtype"]]}
