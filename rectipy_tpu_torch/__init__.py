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
delays; their int8 contraction is the ``block_int8_mv`` kernel.  Input
specs (``inputs.py``) make a run's drive on the device, and
``fit_bptt_multistart`` and ``fit_es`` train through the batched runs.
Plastic edges (``STDP``, ``BlockSparseSTDP``) learn online in
``Network.fit_stdp`` through the fused ``stdp_update`` kernel, and
``Network.fit_eprop`` trains a readout by a local delta rule.
``rectipy_tpu_torch.parallel`` shards populations over a
``torch.distributed`` device mesh, one process per device (``run(mesh=)``,
``run_batch(mesh=)``).

The tooling keeps the JAX package's module paths and is not exported at
the top level: ``rectipy_tpu_torch.serving`` (bundles through
``torch.export``; the kernels are ``torch.library`` operators of
``ops/library.py``), ``.checkpoint``, ``.analysis``, ``.profiler`` and
``.debugging``.
"""

__version__ = "0.1.0"

from .convert import load_jax_params
from .dsl import CircuitTemplate, NodeTemplate, OperatorTemplate, clear_frontend_caches, lower
from .edges import (RLS, STDP, BlockSparseLinear, BlockSparseSTDP, Linear, LinearFilter,
                    LinearMasked, LinearMemory, LinearMemoryFilter, LinearMemoryMatrix, LinearSTP)
from .inputs import Constant, InputSpec, Noise, Poisson, Pulse, Sine, Sum, Wiener
from .network import FeedbackNetwork, Network
from .nodes import InstantNode, MultiSpikeResetNet, RateNet, SpikeNet, SpikeResetNet
from .observer import Observer
from .ops.generic_fused import attach_generic_fused_step
from .ops.kernels import attach_fused_qif_step
from .ops.sparse import BlockSparseCoupling, block_random_connectivity
from . import parallel
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
    "BlockSparseSTDP",
    "CircuitTemplate",
    "Constant",
    "FeedbackNetwork",
    "InputSpec",
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
    "Noise",
    "Observer",
    "OperatorTemplate",
    "Poisson",
    "Pulse",
    "RLS",
    "STDP",
    "RateNet",
    "Sine",
    "SpikeNet",
    "SpikeResetNet",
    "Sum",
    "Wiener",
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
    "parallel",
    "random_connectivity",
    "wta_score",
]
