"""One B-row fused QIF+SFA step on the tensor cores:
``qif_sfa_rows_mma_kernel`` of ``rectipy_tpu_torch/csrc/qif_sfa_step.cu``.

W read once for the B trials; each trial's v, s, x, eta and input read and
its three states written once, float32; the products and 20 operations a
neuron (``chip_smoke.py``'s count, ``batch_timing``)."""

from portbench.peaks import OPS_PEAK

KERNELS = ("qif_sfa_rows_mma_kernel",)


def count(cfg: dict, mix: dict) -> dict:
    n, B = cfg["n"], mix["trials"]
    w_bytes = 2 if cfg["coupling_dtype"] == "bfloat16" else 4
    return {"bytes": n * n * w_bytes + B * n * 4 * 5 + B * n * 4 * 3,
            "ops": 2 * B * n * n + 20 * B * n,
            "peak_ops": OPS_PEAK[cfg["coupling_dtype"]]}
