"""Edge runtime: linear projections and the RLS readout.

Counterpart of the ``Linear`` and ``RLS`` edges of ``rectipy_tpu/edges.py``.
An edge exposes ``init_state()`` and ``make_step() -> (state, params, x) ->
(state', y)``; its parameters live in a ``params`` dict so the Network can
collect them into one parameter tree.

- ``Linear``: ``y = W @ x``; weights auto-transposed when given as
  ``(n_in, n_out)``; 1-D weights are per-neuron gains.
- ``RLS``: a ``Linear`` readout whose weights ``Network.fit_rls`` adapts
  online by recursive least squares, carrying the inverse-correlation
  matrix ``P``.

The other edge classes of the JAX package (masked, delay, filter, STP,
STDP, block-sparse) are not ported yet (ROADMAP Queue 1 items 10 and 12).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .dsl.lower import matvec
from .nodes import resolve_device, resolve_dtype

__all__ = ["Linear", "RLS"]


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(device=device, dtype=dtype)


def _apply_w(w: torch.Tensor, v: torch.Tensor, diag: bool) -> torch.Tensor:
    """Edge projection: a matrix -> matvec; 1-D weights (``diag``) ->
    diagonal (elementwise) gains, which spare an (N, N) identity-like matrix
    for what is an O(N) operation.  The source may carry leading trial axes
    ``(B, n)``, and the weights a per-trial axis (swept by ``run_batch``),
    so ``diag`` comes from the edge, not from ``w``.  Mixed dtypes (a float64
    RLS readout fed by a float32 population) compute in the promoted type,
    as JAX promotes."""
    if w.dtype != v.dtype:
        dtype = torch.promote_types(w.dtype, v.dtype)
        w, v = w.to(dtype), v.to(dtype)
    return w * v if diag else matvec(w, v)


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
        diag = self.params["weights"].ndim == 1

        def step(state, params, x):
            return state, _apply_w(params["weights"], x, diag)

        return step

    def forward(self, x, **kwargs):
        _, y = self.make_step()(self.init_state(), self.params,
                                _as_tensor(x, self.dtype, self.device))
        return y


class RLS(Linear):
    """Extended recursive least squares (FORCE-style online readout learning).

    State: the inverse-correlation matrix ``P = alpha*I`` and the weights;
    per update (the JAX package's ``RLS.update_fn``):

        z = beta^-1 P x
        k = (1 + x.z)^-1
        W += outer(y - k*x.(W + outer(y,z))^T, z)
        P -= k * outer(z, z)
        loss = |y - y_hat|^2

    ``dtype`` defaults to float64 (RectiPy's own RLS default; the JAX package
    takes it only with x64 on).  ``P`` is downdated in place, so an update
    reads P twice and writes it once and never waits on the host.

    References: Principe et al. (2011), Kernel Adaptive Filtering.
    """

    _tensors = ["weights", "P"]

    def __init__(self, n_in: int, n_out: int, weights=None, dtype=torch.float64,
                 beta: float = 1.0, alpha: float = 1.0, device=None, **kwargs):
        if beta > 1 or beta < 0:
            raise ValueError("Parameter beta should be a positive scalar between 0 and 1.")
        if alpha < 0:
            raise ValueError("Parameter alpha should be a positive scalar.")
        if weights is None:
            weights = np.zeros((n_out, n_in))
        super().__init__(n_in, n_out, weights=weights, dtype=dtype, detach=True, device=device)
        self.beta = float(beta) ** (-1)
        self.params["P"] = float(alpha) * torch.eye(n_in, dtype=self.dtype, device=self.device)
        self.loss = 0.0
        self.train_keys = []

    @property
    def P(self):
        return self.params["P"]

    @staticmethod
    def update_fn(beta_inv: float):
        """RLS update ``(W, P, x, y, y_hat) -> (W', P, loss)``, used by
        ``Network.fit_rls``.  ``P`` is downdated in place (``addr_``, with
        the gain ``k`` a 0-d tensor: no host sync) and returned; ``W'`` is a
        new tensor.  The downdate rounds ``(k*z_i)*z_j`` where the JAX
        package rounds ``k*(z_i*z_j)``."""

        def update(W, P, x, y, y_hat):
            z = beta_inv * torch.mv(P, x)
            k = 1.0 / (1.0 + x @ z)
            err = y - y_hat
            W_new = W + torch.outer(y - k * ((W + torch.outer(y, z)) @ x), z)
            P.addr_(k * z, z, alpha=-1.0)
            return W_new, P, err @ err

        return update

    def update(self, x, y, y_hat) -> None:
        x, y, y_hat = (_as_tensor(a, self.dtype, self.device) for a in (x, y, y_hat))
        W, P, loss = self.update_fn(self.beta)(self.params["weights"], self.params["P"], x, y,
                                               y_hat)
        self.params["weights"] = W
        self.params["P"] = P
        self.loss = loss
