"""Collective-cost diagnostics of sharded programs.

Counterpart of ``rectipy_tpu/parallel/diagnostics.py``.  PyTorch compiles
no whole program whose collectives could be read off, so the port counts its
own: every collective of a sharded run goes through ``parallel/comm.py``,
which tallies it.  The per-step tally is the regression test of the
execution model (a sharded step of one population gathers its coupling's
source once, ``N x itemsize`` bytes, and issues nothing else).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from . import comm

__all__ = ["collective_stats", "sharded_step_collectives"]


def collective_stats(fn: Callable, *args, steps: int = 1) -> Dict[str, dict]:
    """Run ``fn(*args)`` and tally the collectives it issues:
    ``{op: {"count": k, "bytes": total_output_bytes}}`` for the five ops of
    the JAX package's diagnostics (``all-gather``, ``all-reduce``,
    ``collective-permute``, ``all-to-all``, ``reduce-scatter``), divided by
    ``steps`` (the JAX package counts a scan's body once: pass the number of
    steps ``fn`` runs for per-step counts)."""
    comm.reset()
    fn(*args)
    return {op: {"count": rec["count"] // steps, "bytes": rec["bytes"] // steps}
            for op, rec in comm.tally().items()}


def sharded_step_collectives(net, mesh, T: int = 8) -> Dict[str, dict]:
    """The per-step collectives of ``T`` steps of ``net``'s sharded step on
    ``mesh`` (state and parameters placed as ``Network.run(mesh=)`` places
    them, a zero drive), as :func:`collective_stats` gives them."""
    from .sharding import NetworkShard

    shard = NetworkShard(net, mesh)
    state = shard.place(net.init_state())
    params = net._prep_params(shard.place(net.parameters_pytree()), shard)
    xs = shard.inputs(torch.zeros((T, net.n_in or 1), dtype=net.dtype,
                                  device=net.device).unbind(0))
    step = shard.step()

    def scan():
        st = state
        with torch.no_grad():
            for x in xs:
                st, _, _ = step(st, params, x)

    return collective_stats(scan, steps=T)
