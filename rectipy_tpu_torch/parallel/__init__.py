"""Multi-device population parallelism on ``torch.distributed``.

Counterpart of ``rectipy_tpu/parallel``.  The execution model is SPMD, one
process per device, as the JAX package's multi-controller runtime runs it:

- every rank builds the same network and calls ``run(mesh=)`` (or
  ``run_batch(mesh=)``) with the same inputs;
- a rank of the mesh's ``model`` axis owns neurons ``[r0, r1)`` of every
  population it shards: their state rows, their rows of each coupling and
  per-neuron parameter, and their rows of each edge into the population;
- each step it all-gathers the source vector of every coupling and edge
  whose source is sharded (once per coupling a step, as GSPMD does), then
  computes its own rows; the hand-written kernels take the local tensors;
- records are formed on the local rows and gathered once, at the end of the
  run; trials of ``run_batch`` and of the train step ride the ``data`` axis.

So a one-population step gathers its source once a step, ``N x itemsize``
bytes, and issues nothing else (``sharded_step_collectives``, counted by the
port's own collectives in ``comm.py``, since PyTorch has no whole-program
HLO to read).  Training a quantized coupling adds, a step, the maximum of
its cotangent's scale over the model group and the sum of the ranks'
integer partial sums (two all-reduces, in place of the source's summed
cotangent); a quantized block edge's stack takes its scales' maxima too.
A node with a fused kernel attached runs whole on every rank of its model
group (the kernel's step is the whole population's), as does a node the
axis does not divide; an edge's state (its source-side history) is whole on
every rank.  The CPU runs it on gloo ranks
(``make_mesh(..., device_type="cpu")``), the card on NCCL, or two gloo
ranks on its tensors where one card must hold a model axis of two
(``chip_smoke.py`` phase 51; NCCL takes one rank a device).
"""

from .diagnostics import collective_stats, sharded_step_collectives
from .sharding import (
    make_mesh,
    shard_network_arrays,
    sharded_run,
    sharded_train_step,
)

__all__ = ["make_mesh", "shard_network_arrays", "sharded_run", "sharded_train_step",
           "collective_stats", "sharded_step_collectives"]
