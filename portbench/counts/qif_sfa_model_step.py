"""The whole network step of a qif_sfa configuration, whatever implements it.

The coupling read once (a dense W at its type; the stored int8 blocks and
their row scales); each trial's three states v, s and x read and written
once, its etas read once (once for all trials when they share them); the
drive once (the input weights through a tanh input node, one number a
trial).  Operations: the coupling's multiply-adds over what it stores, and
20 a neuron for the field, the spike and the reset."""

from portbench.peaks import OPS_PEAK


def count(cfg: dict, mix: dict) -> dict:
    n, B = cfg["n"], mix["trials"]
    if cfg["coupling"] == "dense":
        w_bytes = {"bfloat16": 2, "float32": 4, "int8": 1}[cfg["coupling_dtype"]]
        coupling_bytes, stored = n * n * w_bytes, n * n
    else:
        bs, cb = cfg["block_size"], cfg["source_blocks"]
        stored = n * cb * bs
        coupling_bytes = stored + n * 4
    states = B * n * 4 * 3 * 2
    etas = (B if B > 1 else 1) * n * 4
    drive = (n * 4 if cfg["input"] == "tanh_node" else 0) + B * 4
    return {"bytes": coupling_bytes + states + etas + drive,
            "ops": 2.0 * B * stored + 20 * B * n,
            "peak_ops": OPS_PEAK[cfg["coupling_dtype"]]}
