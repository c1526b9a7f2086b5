"""Seconds to build the program's network from the raw inputs (the DSL,
``add_diffeq_node``, ``compile``, the coupling's upload and quantization,
the fused step's attach), synchronised."""


def read(r):
    return r.network_build_s
