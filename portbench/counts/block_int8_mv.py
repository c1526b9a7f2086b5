"""One gathered int8 block contraction on the tensor cores:
``block_int8_mma_kernel`` of ``rectipy_tpu_torch/csrc/block_int8.cu``.

The int8 blocks, their float32 row scales, the B trials' int8 sources and
the int32 block table read once, the float32 sums written once; every
stored block's multiply-adds (``chip_smoke.py``'s ``block_int8_timing``)."""

from portbench.peaks import INT8_OPS

KERNELS = ("block_int8_mma_kernel",)


def count(cfg: dict, mix: dict) -> dict:
    n, bs, cb, B = cfg["n"], cfg["block_size"], cfg["source_blocks"], mix["trials"]
    n_br = n // bs
    return {"bytes": n_br * cb * bs * bs + n_br * bs * 4 + B * n + n_br * cb * 4 + B * n * 4,
            "ops": 2.0 * B * n_br * cb * bs * bs,
            "peak_ops": INT8_OPS}
