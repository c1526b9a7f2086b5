"""The gathered int8 block contraction's share of its roofline (``block_int8_mma_kernel``)."""
from portbench.readers import kernel_roofline


def read(r):
    return kernel_roofline(r, "block_int8_mv")
