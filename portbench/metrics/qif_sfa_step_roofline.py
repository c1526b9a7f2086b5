"""The single-trial fused QIF+SFA step's share of its roofline (``qif_sfa_step_kernel``)."""
from portbench.readers import kernel_roofline


def read(r):
    return kernel_roofline(r, "qif_sfa_step")
