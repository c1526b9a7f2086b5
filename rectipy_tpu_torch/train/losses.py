"""Loss functions for ``Network.fit_bptt``.

Counterpart of ``rectipy_tpu/train/losses.py``: the reference's torch.nn
loss menu (mse, l1, nll, ce, kld, hinge) with torch's default 'mean'
reduction, written out as the JAX package writes them so the two agree to
rounding.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["get_loss_function"]


def _mse(pred, target):
    return torch.mean((pred - target) ** 2)


def _l1(pred, target):
    return torch.mean(torch.abs(pred - target))


def _nll(pred, target):
    """Negative log-likelihood on log-probability inputs; integer class
    targets (torch.nn.NLLLoss semantics)."""
    target = target.to(torch.int64)
    return -torch.mean(torch.take_along_dim(pred, target[:, None], dim=-1))


def _ce(pred, target):
    """Cross entropy on unnormalized logits.  Integer class targets or
    one-hot/probability targets (torch.nn.CrossEntropyLoss semantics)."""
    logp = torch.log_softmax(pred, dim=-1)
    if target.ndim == pred.ndim - 1 or not torch.is_floating_point(target):
        target = target.to(torch.int64)
        return -torch.mean(torch.take_along_dim(logp, target[:, None], dim=-1))
    return -torch.mean(torch.sum(target * logp, dim=-1))


def _kld(pred, target):
    """KL divergence, pred given as log-probabilities (torch.nn.KLDivLoss
    with the default 'mean' reduction: the elementwise mean)."""
    return torch.mean(target * (torch.log(torch.clamp_min(target, 1e-38)) - pred))


def _hinge(pred, target, margin: float = 1.0):
    """Hinge embedding loss (torch.nn.HingeEmbeddingLoss): target in {-1, 1}."""
    loss = torch.where(target > 0, pred, torch.clamp_min(margin - pred, 0.0))
    return torch.mean(loss)


_LOSSES = {"mse": _mse, "l1": _l1, "nll": _nll, "ce": _ce, "kld": _kld, "hinge": _hinge}


def get_loss_function(loss: str, loss_kwargs: dict = None) -> Callable:
    """Resolve a loss name to ``loss(pred, target) -> scalar``."""
    loss_kwargs = loss_kwargs or {}
    try:
        fn = _LOSSES[loss]
    except KeyError:
        raise ValueError(
            "Invalid loss function choice. Please see the documentation of the "
            "`Network.fit_bptt()` method for valid options."
        )
    if loss_kwargs:
        base = fn
        return lambda p, t: base(p, t, **loss_kwargs)
    return fn
