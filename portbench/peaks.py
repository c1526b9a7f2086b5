"""The card's published peaks: NVIDIA H100 SXM data sheet, dense rates.

Copied from ``chip_smoke.py`` and frozen here: the rooflines and
``step_mfu`` are shares of these.  The rates assume the card's full power
limit of 700 W; a run prints the limit it found beside its numbers.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_FLOPS = 989e12  # bf16 x bf16 with float32 sums
INT8_OPS = 1979e12

# the peak of a product whose weights are of this type
OPS_PEAK = {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS, "int8": INT8_OPS}


def least_seconds(n_bytes: float, n_ops: float, peak_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory bandwidth and the operations over their peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops)
