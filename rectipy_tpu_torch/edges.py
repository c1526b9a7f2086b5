"""Edge runtime: linear projections.

Counterpart of the ``Linear`` edge of ``rectipy_tpu/edges.py``.  An edge
exposes ``init_state()`` and ``make_step() -> (state, params, x) ->
(state', y)``; its parameters live in a ``params`` dict so the Network can
collect them into one parameter tree.

- ``Linear``: ``y = W @ x``; weights auto-transposed when given as
  ``(n_in, n_out)``; 1-D weights are per-neuron gains.

The other edge classes of the JAX package (masked, delay, filter, STP, RLS,
STDP, block-sparse) are not ported yet (ROADMAP Queue 1 items 9, 10 and 12).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .nodes import resolve_device, resolve_dtype

__all__ = ["Linear"]


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(device=device, dtype=dtype)


def _apply_w(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Edge projection: 2-D weights -> matvec; 1-D weights -> diagonal
    (elementwise) gains, which spare an (N, N) identity-like matrix for what
    is an O(N) operation."""
    return w * v if w.ndim == 1 else w @ v


class Linear:
    """Static linear projection ``y = W @ x``.

    ``weights=None`` draws standard-normal weights from ``rng`` (default: an
    unseeded ``numpy.random.default_rng()``, as in RectiPy); pass ``rng`` or
    the weights themselves for reproducible runs.
    """

    _tensors = ["weights"]

    def __init__(self, n_in: int, n_out: int, weights=None, dtype=None,
                 detach: bool = True, rng: Optional[np.random.Generator] = None,
                 device=None, **kwargs):
        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        if weights is None:
            rng = rng or np.random.default_rng()
            weights = rng.standard_normal((n_out, n_in))
        weights = _as_tensor(weights, self.dtype, self.device)
        if weights.ndim == 1:
            # diagonal edge: per-source gains (requires square edge)
            if n_in != n_out or weights.shape[0] != n_in:
                raise ValueError(
                    "1-D (diagonal) edge weights require n_in == n_out == len(weights); "
                    f"got {weights.shape[0]} gains for a ({n_out}, {n_in}) edge."
                )
        # RectiPy parity: a (n_in, n_out)-shaped matrix is auto-transposed --
        # including the square case
        elif tuple(weights.shape) == (n_in, n_out):
            weights = weights.T.contiguous()
        elif tuple(weights.shape) != (n_out, n_in):
            raise ValueError(
                "Shape of the provided weights does not match the input and output dimensions "
                "of the source and target nodes."
            )
        self.n_in = n_in
        self.n_out = n_out
        self.params: Dict[str, torch.Tensor] = {"weights": weights}
        self.train_keys = []
        if not detach:
            train_params = kwargs.pop("train_params", self._tensors)
            self.train_keys = [k for k in self._tensors if k in train_params]

    @property
    def weights(self):
        return self.params["weights"]

    @weights.setter
    def weights(self, w):
        self.params["weights"] = _as_tensor(w, self.dtype, self.device)

    @property
    def train_params(self) -> list:
        return [self.params[k] for k in self.train_keys]

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def parameters(self, recurse: bool = True) -> Iterator:
        for k in self.train_keys:
            yield self.params[k]

    def detach(self):
        self.train_keys = []

    # -- functional protocol ----------------------------------------------------
    def init_state(self):
        return None

    def make_step(self) -> Callable:
        def step(state, params, x):
            return state, _apply_w(params["weights"], x)

        return step

    def forward(self, x, **kwargs):
        _, y = self.make_step()(self.init_state(), self.params,
                                _as_tensor(x, self.dtype, self.device))
        return y
