"""rectipy_tpu_torch: the PyTorch/CUDA port of rectipy_tpu.

ODE-defined rate and spiking neuron populations authored as YAML templates,
composed into graphs and integrated with explicit Euler on an NVIDIA GPU
(Hopper, ``sm_90a``).  The JAX package ``rectipy_tpu`` is the reference this
package is held against; the two share module names, template files and
parameter/state layouts, and ``convert.load_jax_params`` carries a JAX
network's weights and state across.

Importing the package builds nothing: the CUDA kernels under ``csrc/`` are
compiled at first use.  Everything runs on the current CUDA device unless
``device="cpu"`` is passed.
"""

__version__ = "0.1.0"

from .convert import load_jax_params
from .dsl import CircuitTemplate, NodeTemplate, OperatorTemplate, clear_frontend_caches, lower
from .edges import Linear
from .network import Network
from .nodes import InstantNode, RateNet, SpikeResetNet
from .observer import Observer
from .ops.kernels import attach_fused_qif_step
from .utility import (
    circular_connectivity,
    input_connections,
    line_connectivity,
    normalize,
    random_connectivity,
    wta_score,
)

__all__ = [
    "CircuitTemplate",
    "InstantNode",
    "Linear",
    "Network",
    "NodeTemplate",
    "Observer",
    "OperatorTemplate",
    "RateNet",
    "SpikeResetNet",
    "attach_fused_qif_step",
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
