"""The B-row fused QIF+SFA step's share of its roofline (``qif_sfa_rows_mma_kernel``)."""
from portbench.readers import kernel_roofline


def read(r):
    return kernel_roofline(r, "qif_sfa_rows")
