"""rectipy_tpu_torch: the PyTorch/CUDA port of rectipy_tpu.

ODE-defined rate and spiking neuron populations authored as YAML templates,
composed into graphs and integrated with explicit Euler on an NVIDIA GPU
(Hopper, ``sm_90a``).  The JAX package ``rectipy_tpu`` is the reference this
package is held against; the two share module names, template files and
parameter/state layouts, and ``convert.load_jax_params`` carries a JAX
network's weights and state across.

Importing the package builds nothing: the CUDA kernels under ``csrc/`` are
compiled at first use.  Everything runs on the current CUDA device unless
``device="cpu"`` is passed.  ``Network.run_batch`` and
``Network.fit_bptt_batch`` run ``B`` independent trials together through
batched kernels (``int8_mm``/``int8_mm_t``, the B-row ``qif_sfa_step``).
The edge family (masks, per-source and per-connection delays, filters,
short-term plasticity) is computed with PyTorch operations.  Block-sparse
couplings (``BlockSparseCoupling``, ``block_random_connectivity``) reach
population scale on nodes and on ``BlockSparseLinear`` edges with per-block
delays; their int8 contraction is the ``block_int8_mv`` kernel.
"""

__version__ = "0.1.0"

from .convert import load_jax_params
from .dsl import CircuitTemplate, NodeTemplate, OperatorTemplate, clear_frontend_caches, lower
from .edges import (RLS, BlockSparseLinear, Linear, LinearFilter, LinearMasked, LinearMemory,
                    LinearMemoryFilter, LinearMemoryMatrix, LinearSTP)
from .network import FeedbackNetwork, Network
from .nodes import InstantNode, MultiSpikeResetNet, RateNet, SpikeNet, SpikeResetNet
from .observer import Observer
from .ops.generic_fused import attach_generic_fused_step
from .ops.kernels import attach_fused_qif_step
from .ops.sparse import BlockSparseCoupling, block_random_connectivity
from .utility import (
    circular_connectivity,
    input_connections,
    line_connectivity,
    normalize,
    random_connectivity,
    wta_score,
)

__all__ = [
    "BlockSparseCoupling",
    "BlockSparseLinear",
    "CircuitTemplate",
    "FeedbackNetwork",
    "InstantNode",
    "Linear",
    "LinearFilter",
    "LinearMasked",
    "LinearMemory",
    "LinearMemoryFilter",
    "LinearMemoryMatrix",
    "LinearSTP",
    "MultiSpikeResetNet",
    "Network",
    "NodeTemplate",
    "Observer",
    "OperatorTemplate",
    "RLS",
    "RateNet",
    "SpikeNet",
    "SpikeResetNet",
    "attach_fused_qif_step",
    "attach_generic_fused_step",
    "block_random_connectivity",
    "circular_connectivity",
    "clear_frontend_caches",
    "input_connections",
    "line_connectivity",
    "load_jax_params",
    "lower",
    "normalize",
    "random_connectivity",
    "wta_score",
]
