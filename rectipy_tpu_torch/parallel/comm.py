"""The collectives of a population-sharded run, and their tally.

Every collective the port issues under ``mesh=`` goes through this module,
which counts it: ``tally()`` gives ``{op: {"count", "bytes"}}`` for the five
operations of the JAX package's diagnostics, ``bytes`` being each
collective's output bytes (``diagnostics.collective_stats`` reads it).  A
group of one rank is no collective: the functions return their input
unchanged and count nothing.

``gather_last`` all-gathers the last (neuron) axis of a shard's rows across
the ``model`` group.  Its gradient, for training, is the rows of the summed
gradient (``all_reduce`` over the group): every rank's rows of the product
that consumed the gathered vector contribute to every source neuron.
``gather_whole`` is the same gather for a consumer that every rank computes
alike (the loss of the gathered outputs): its gradient is the own rows, with
no collective.  ``to_partial`` marks a value every rank holds whole as
consumed by each rank's rows (identity forward, summed gradient).
``Group`` hands the sum and the maximum to the quantized products of a
population shard (their dynamic scales and integer partial sums).

A gloo group takes these collectives on CUDA tensors as they are (PyTorch
2.11; gloo stages them through the host itself): the two ranks that share
one card in ``chip_smoke.py`` run them on a gloo group, NCCL refusing two
ranks on one device.  No copy is made here.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVES", "tally", "reset", "gather_last", "gather_whole", "gather_first",
           "all_reduce", "all_reduce_max", "to_partial", "Group", "TrajectoryComm"]

COLLECTIVES = ("all-gather", "all-reduce", "collective-permute", "all-to-all",
               "reduce-scatter")
_TALLY: Dict[str, list] = {op: [0, 0] for op in COLLECTIVES}


def reset() -> None:
    for rec in _TALLY.values():
        rec[0] = rec[1] = 0


def tally() -> Dict[str, dict]:
    """``{op: {"count": k, "bytes": b}}`` since the last :func:`reset`."""
    return {op: {"count": c, "bytes": b} for op, (c, b) in _TALLY.items()}


def _count(op: str, out: torch.Tensor) -> None:
    rec = _TALLY[op]
    rec[0] += 1
    rec[1] += out.numel() * out.element_size()


def _gather0(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``(size, *x.shape)``: every rank's ``x``, in rank order."""
    x = x.contiguous().reshape((1,) + tuple(x.shape))
    out = torch.empty((size,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)  # the concatenation on axis 0
    _count("all-gather", out)
    return out


def _gather_last(x: torch.Tensor, group, size: int) -> torch.Tensor:
    out = _gather0(x, group, size)
    if x.dim() <= 1:
        return out.reshape(-1)
    return out.movedim(0, -2).reshape(*x.shape[:-1], size * x.shape[-1])


def all_reduce(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor)."""
    if size == 1:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, group=group)
    _count("all-reduce", out)
    return out


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank, summed):
        ctx.group, ctx.size, ctx.rank, ctx.summed = group, size, rank, summed
        ctx.rows = x.shape[-1]
        return _gather_last(x, group, size)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = all_reduce(g, ctx.group, ctx.size)
        r0 = ctx.rank * ctx.rows
        return g[..., r0:r0 + ctx.rows], None, None, None, None


class _ToPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, ctx.size), None, None


def _grad(x) -> bool:
    return torch.is_grad_enabled() and isinstance(x, torch.Tensor) and x.requires_grad


def gather_last(x: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    """``(..., size * m)`` from every rank's ``(..., m)`` rows, in rank
    order; the gradient is the own rows of the gradient summed over the
    group."""
    if size == 1:
        return x
    if _grad(x):
        return _GatherLast.apply(x, group, size, rank, True)
    return _gather_last(x, group, size)


def gather_whole(x: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
    """:func:`gather_last` for a consumer that every rank computes alike:
    the gradient is the own rows of the (same) gradient."""
    if size == 1:
        return x
    if _grad(x):
        return _GatherLast.apply(x, group, size, rank, False)
    return _gather_last(x, group, size)


def gather_first(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated on the first axis (the trials of the
    data groups)."""
    if size == 1:
        return x
    return _gather0(x, group, size).reshape((size * x.shape[0],) + tuple(x.shape[1:]))


def to_partial(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``x``, whose gradient is summed over the group: a value every rank
    holds whole, consumed by each rank's own rows."""
    if size == 1 or not _grad(x):
        return x
    return _ToPartial.apply(x, group, size)


def all_reduce_max(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x`` (a new tensor)."""
    if size == 1:
        return x
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    _count("all-reduce", out)
    return out


class _Replay(torch.autograd.Function):
    """A gather the forward loop already made, replayed in the backward
    sweep: the saved whole vector, with :func:`gather_last`'s (``summed``)
    or :func:`gather_whole`'s gradient, and no all-gather."""

    @staticmethod
    def forward(ctx, x, box, group, size, rank, summed):
        ctx.group, ctx.size, ctx.rank, ctx.summed = group, size, rank, summed
        ctx.rows = x.shape[-1]
        return box[0].detach()

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = all_reduce(g, ctx.group, ctx.size)
        r0 = ctx.rank * ctx.rows
        return g[..., r0:r0 + ctx.rows], None, None, None, None, None


class Group:
    """A population shard's model group as the quantized products take it
    (``ops/quant.py``): the sum and the elementwise maximum of every rank's
    tensor, counted as above, the group's size, and the gather of a source
    whose consumer gives the whole gradient itself."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def gather_whole(self, x: torch.Tensor) -> torch.Tensor:
        return gather_whole(x, self.group, self.size, self.rank)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.group, self.size)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_max(x, self.group, self.size)


class TrajectoryComm(Group):
    """The collectives of a population shard inside a deferred-gradient
    trajectory (``ops/bptt.py``, ``ops/graph_bptt.py``).

    The forward loop calls :meth:`forward_step` before each step; within a
    step each source is gathered once (``key``: the source and the kind of
    its consumer) and, where the loop keeps its residuals, the gathered
    vectors are logged.  The backward sweep calls :meth:`replay_step` with
    the step's log: the recomputed producers then take the saved vectors
    (no all-gather), and their gradients all-reduce over the model group
    (a source consumed by the shard's rows) or take the own rows (a source
    consumed by a node every rank runs whole).  So a step costs one
    all-gather per sharded source forward and one all-reduce per source
    backward, and the weight gradients contract the saved whole sources
    with the local cotangents, with no gather of the trajectory."""

    def __init__(self, group, size: int, rank: int):
        super().__init__(group, size, rank)
        self._log = None
        self._step = None
        self._replay = False

    def forward_step(self, record: bool) -> None:
        self._replay, self._step = False, {}
        if record:
            if self._log is None:
                self._log = []
            self._log.append(self._step)

    def take_log(self) -> list:
        """The per-step gathers logged since the last call (and stop)."""
        log, self._log, self._step = self._log or [], None, None
        return log

    def replay_step(self, saved: dict) -> None:
        self._replay, self._step = True, saved

    def done(self) -> None:
        self._step, self._replay = None, False

    def gather(self, key, x: torch.Tensor, summed: bool = True) -> torch.Tensor:
        """The whole vector of the shard's rows ``x``."""
        if self._step is None:
            fn = gather_last if summed else gather_whole
            return fn(x, self.group, self.size, self.rank)
        if self._replay:
            if not _grad(x):
                return self._step[key]
            return _Replay.apply(x, [self._step[key]], self.group, self.size, self.rank,
                                 summed)
        if key not in self._step:
            self._step[key] = _gather_last(x.detach(), self.group, self.size)
        return self._step[key]

    def to_partial(self, x: torch.Tensor) -> torch.Tensor:
        return to_partial(x, self.group, self.size)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole ``(..., n, k)`` from every rank's rows ``(..., rows,
        k)`` (a diagonal edge's delay buffer, at the end of a chunk)."""
        return gather_first(x.detach().movedim(-2, 0).clone(), self.group,
                            self.size).movedim(0, -2)
