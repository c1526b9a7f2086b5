"""Edge runtime: linear projections, delay buffers, filters, short-term
plasticity and the RLS readout.

Counterpart of ``rectipy_tpu/edges.py``.  An edge exposes ``init_state()``
and ``make_step() -> (state, params, x) -> (state', y)``; its parameters
live in a ``params`` dict so the Network can collect them into one parameter
tree, and a stateful edge's ``set_state`` takes its state back after a run.
Every step accepts leading trial axes: a source ``(B, n_in)``, buffers
``(B, n_in, D)``, ``(B, n_in)`` filter and STP states, and per-trial
parameters (a swept coupling ``(B, n_out, n_in)``).

- ``Linear``: ``y = W @ x``; weights auto-transposed when given as
  ``(n_in, n_out)``; 1-D weights are per-neuron gains.
- ``LinearMasked``: ``y = (W * mask) @ x`` with a fixed mask.
- ``LinearMemory``: per-source integer delays in a ring buffer ``(n_in,
  max_delay+1)``: each step shifts the buffer toward slot 0, writes the
  input at each source's own delay and projects slot 0.  Each source keeps
  its own history (RectiPy's fancy-indexed write clobbers other sources';
  neither package copies that).
- ``LinearMemoryMatrix``: per-connection integer (or, ``mode='interp'``,
  continuous and trainable) delays, ``y_i = sum_j W_ij x_j(t - d_ij)``.
- ``LinearFilter``: a synaptic filter ``y <- F @ y + x``, then ``W @ y``.
- ``LinearMemoryFilter``: the rolled ring buffer is filtered before the
  write.
- ``LinearSTP``: Tsodyks-Markram short-term plasticity, a ``(u, x)`` state.
- ``RLS``: a ``Linear`` readout whose weights ``Network.fit_rls`` adapts
  online by recursive least squares, carrying the inverse-correlation
  matrix ``P``.

- ``BlockSparseLinear``: a ``BlockSparseCoupling`` projection with optional
  per-block integer delays read from a circular history ``(nb_in, D1,
  bs)``; ``block_dtype`` bfloat16 or ``'int8_master'``.

The JAX package computes these edges with XLA operations and no Pallas
kernel; the port computes them with PyTorch operations, except the int8
block contraction of an ``int8_master`` block edge, which is the
``block_int8_mv`` kernel (``ops/quant.py``).  ``STDP`` and
``BlockSparseSTDP`` are not ported yet (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .dsl.lower import matvec
from .nodes import resolve_device, resolve_dtype

__all__ = ["BlockSparseLinear", "Linear", "LinearFilter", "LinearMasked", "LinearMemory",
           "LinearMemoryFilter", "LinearMemoryMatrix", "LinearSTP", "RLS"]


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


def _square_filter(filter_weights, n_in: int, dtype, device) -> torch.Tensor:
    filt = _as_tensor(filter_weights, dtype, device)
    if tuple(filt.shape) != (n_in, n_in):
        raise ValueError(
            "Intrinsic weights have to be a square matrix with the number of rows and "
            "columns matching the number of inputs to the edge."
        )
    return filt


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
        # the requested trainables, so that a parameter a subclass registers
        # after this constructor (mask, filter, delays) still trains
        self._train_req: list = []
        if not detach:
            train_params = kwargs.pop("train_params", self._tensors)
            self._train_req = list(train_params)
            self.train_keys = [k for k in self._tensors if k in train_params and k in self.params]

    def _register_param(self, name: str, value: torch.Tensor) -> None:
        """Add a parameter made by a subclass constructor, honouring the
        ``train_params`` request made at ``__init__``."""
        self.params[name] = value
        if name in self._train_req and name in self._tensors and name not in self.train_keys:
            self.train_keys.append(name)

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

    def _eager(self, state, x):
        """One eager step of ``forward``: ``(state', y)``."""
        return self.make_step()(state, self.params, _as_tensor(x, self.dtype, self.device))

    def forward(self, x, **kwargs):
        return self._eager(self.init_state(), x)[1]


class _Stateful(Linear):
    """An edge whose state ``forward`` advances and a run writes back."""

    _state = None

    def init_state(self):
        return self._state

    def set_state(self, state):
        self._state = state

    def forward(self, x, **kwargs):
        self._state, y = self._eager(self._state, x)
        return y


class LinearMasked(Linear):
    """Sparse trainable connectivity: ``y = (W * mask) @ x`` with a fixed
    mask, which follows the weights' transpose rule."""

    _tensors = ["weights", "mask"]

    def __init__(self, n_in: int, n_out: int, mask, weights=None, dtype=None,
                 detach: bool = True, **kwargs):
        kwargs.setdefault("train_params", ["weights"])
        super().__init__(n_in, n_out, weights=weights, dtype=dtype, detach=detach, **kwargs)
        mask = _as_tensor(mask, self.dtype, self.device)
        if tuple(mask.shape) == (n_in, n_out):
            mask = mask.T.contiguous()
        elif tuple(mask.shape) != (n_out, n_in):
            raise ValueError(
                "Shape of the provided mask does not match the input and output dimensions "
                "of the source and target nodes."
            )
        self._register_param("mask", mask)

    @property
    def mask(self):
        return self.params["mask"]

    def make_step(self) -> Callable:
        def step(state, params, x):
            return state, _apply_w(params["weights"] * params["mask"], x, False)

        return step


class LinearMemory(_Stateful):
    """Delay edge: per-source integer delays with a ring buffer ``(n_in,
    max_delay+1)``.  Each step rolls the buffer toward slot 0, writes the
    input at column ``delays[i]`` of row ``i`` (a one-hot mask, no
    scatter) and projects slot 0."""

    _tensors = ["weights", "buffer", "delays"]

    def __init__(self, n_in: int, n_out: int, delays, weights=None, dtype=None,
                 detach: bool = True, **kwargs):
        kwargs.setdefault("train_params", ["weights"])
        super().__init__(n_in, n_out, weights=weights, dtype=dtype, detach=detach, **kwargs)
        delays = np.asarray(delays)
        if len(delays) != n_in:
            raise ValueError("The number of delays must match the number of node inputs.")
        delays = delays.astype(np.int64)
        self.delays = torch.as_tensor(delays, device=self.device)
        self.max_delay = int(delays.max())
        self._state = torch.zeros((n_in, self.max_delay + 1), dtype=self.dtype,
                                  device=self.device)
        eye = np.zeros((n_in, self.max_delay + 1))
        eye[np.arange(n_in), delays] = 1.0
        self._write_mask = torch.as_tensor(eye).to(device=self.device, dtype=self.dtype)

    @property
    def buffer(self):
        return self._state

    def _shift(self, buf, params):
        return torch.roll(buf, -1, dims=-1)

    def make_step(self) -> Callable:
        mask = self._write_mask
        diag = self.params["weights"].ndim == 1

        def step(buf, params, x):
            buf = self._shift(buf, params)
            buf = buf * (1.0 - mask) + mask * x[..., None]
            return buf, _apply_w(params["weights"], buf[..., 0], diag)

        return step


class LinearMemoryFilter(LinearMemory):
    """Delays and a synaptic filter combined: the rolled buffer is filtered
    (``F @ buffer``) before the new input is written."""

    _tensors = ["weights", "buffer", "delays", "filter"]

    def __init__(self, n_in: int, n_out: int, delays, filter_weights, weights=None,
                 dtype=None, detach: bool = True, **kwargs):
        kwargs.setdefault("train_params", ["weights", "filter"])
        super().__init__(n_in, n_out, delays=delays, weights=weights, dtype=dtype,
                         detach=detach, **kwargs)
        self._register_param("filter", _square_filter(filter_weights, n_in, self.dtype,
                                                      self.device))

    @property
    def filter(self):
        return self.params["filter"]

    def _shift(self, buf, params):
        return params["filter"] @ torch.roll(buf, -1, dims=-1)


class LinearFilter(_Stateful):
    """Trainable synaptic filter on the edge: ``y <- F @ y + x`` then
    ``W @ y``."""

    _tensors = ["weights", "filter", "y"]

    def __init__(self, n_in: int, n_out: int, filter_weights, weights=None, dtype=None,
                 detach: bool = True, **kwargs):
        kwargs.setdefault("train_params", ["weights", "filter"])
        super().__init__(n_in, n_out, weights=weights, dtype=dtype, detach=detach, **kwargs)
        self._register_param("filter", _square_filter(filter_weights, n_in, self.dtype,
                                                      self.device))
        self._state = torch.zeros(n_in, dtype=self.dtype, device=self.device)

    @property
    def filter(self):
        return self.params["filter"]

    @property
    def y(self):
        return self._state

    def make_step(self) -> Callable:
        diag = self.params["weights"].ndim == 1

        def step(y, params, x):
            y = matvec(params["filter"], y) + x
            return y, _apply_w(params["weights"], y, diag)

        return step


class LinearSTP(_Stateful):
    """Short-term synaptic plasticity edge (Tsodyks-Markram model; Tsodyks,
    Pawelzik & Markram 1998, Neural Comput 10:821).  Each presynaptic
    channel carries a utilization ``u`` (facilitation) and a resource ``x``
    (depression) that scale transmission:

        m       = clip(r * dt, 0, 1)            # spike mass this step
        u+      = u + U * (1 - u) * m           # facilitation jump
        drive   = u+ * x * r                    # modulated transmission
        x-      = x * (1 - u+ * m)              # resource consumption
        u       <- U + (u+ - U) * exp(-dt/tau_facil)
        x       <- 1 + (x- - 1) * exp(-dt/tau_depress)
        y       = W @ drive

    ``r`` is presynaptic activity per time unit (a rate, a synaptic
    activation, or unit-area impulses of amplitude ``1/dt``).  ``tau_facil=0``
    switches facilitation off (``u`` stays ``U``), ``tau_depress=0``
    depression (``x`` stays 1).  ``dt`` is the network's.  The decays are
    Python floats, so a float32 edge stays float32.  The state is the
    tuple ``(u, x)``.
    """

    _tensors = ["weights"]

    def __init__(self, n_in: int, n_out: int, dt: float, weights=None, dtype=None,
                 detach: bool = True, tau_facil: float = 0.0, tau_depress: float = 0.0,
                 U: float = 0.2, **kwargs):
        if tau_facil < 0 or tau_depress < 0:
            raise ValueError("STP time constants tau_facil/tau_depress must be >= 0 "
                             "(0 disables the corresponding process).")
        if not 0.0 < U <= 1.0:
            raise ValueError("STP baseline utilization U must lie in (0, 1].")
        kwargs.setdefault("train_params", ["weights"])
        super().__init__(n_in, n_out, weights=weights, dtype=dtype, detach=detach, **kwargs)
        self.dt = float(dt)
        self.tau_facil = float(tau_facil)
        self.tau_depress = float(tau_depress)
        self.U = float(U)
        self._state = (torch.full((n_in,), self.U, dtype=self.dtype, device=self.device),
                       torch.ones(n_in, dtype=self.dtype, device=self.device))

    @property
    def u(self):
        return self._state[0]

    @property
    def x(self):
        return self._state[1]

    def make_step(self) -> Callable:
        dt, U = self.dt, self.U
        facil = self.tau_facil > 0
        dep = self.tau_depress > 0
        d_f = float(np.exp(-dt / self.tau_facil)) if facil else 0.0
        d_d = float(np.exp(-dt / self.tau_depress)) if dep else 0.0
        diag = self.params["weights"].ndim == 1

        def step(state, params, r):
            u, x = state
            m = torch.clamp(r * dt, 0.0, 1.0)
            u_plus = u + U * (1.0 - u) * m if facil else u
            drive = u_plus * x * r
            x_minus = x * (1.0 - u_plus * m) if dep else x
            u_new = U + (u_plus - U) * d_f
            x_new = 1.0 + (x_minus - 1.0) * d_d
            return (u_new, x_new), _apply_w(params["weights"], drive, diag)

        return step


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``x`` clipped to ``[lo, hi]`` as ``minimum(maximum(x, lo), hi)``, not
    ``clamp``: a value on a bound passes half its gradient, as the JAX
    package's ``jnp.clip`` does (an integer delay sits on the hat's
    bounds)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _one_hot(idx: torch.Tensor, width: int, dtype: torch.dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(width, device=idx.device)).to(dtype)


def _select(sel: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """``vals[..., j, i] = sum_k buf[..., j, k] * sel[..., j, i, k]``: a
    selector ``(n_in, n_out, K)`` shared by every trial of ``buf (..., n_in,
    K)`` (one batched product, the trials beside the selector's rows), or
    one selector per trial, ``(B, n_in, n_out, K)`` for ``buf (B, n_in,
    K)``."""
    if sel.dim() == buf.dim() + 1:
        return torch.matmul(sel, buf.unsqueeze(-1)).squeeze(-1)
    lead = buf.shape[:-2]
    j, k = buf.shape[-2:]
    b = buf.reshape(-1, j, k).permute(1, 2, 0)  # (n_in, K, L)
    return torch.bmm(sel, b).permute(2, 0, 1).reshape(*lead, j, sel.shape[1])


def _select_factored(oh_q: torch.Tensor, oh_r: torch.Tensor, buf3: torch.Tensor) -> torch.Tensor:
    """The digit-factored read: ``t1[..., j, i, b] = sum_a oh_q[j, i, a] *
    buf3[..., j, a, b]`` (the coarse digit, a batched product), then ``vals
    = sum_b t1 * oh_r`` (the fine digit).  Shared selectors take every trial
    in one product, as ``_select``."""
    if oh_q.dim() == buf3.dim():
        return (torch.matmul(oh_q, buf3) * oh_r).sum(-1)
    lead = buf3.shape[:-3]
    j, q, s = buf3.shape[-3:]
    b = buf3.reshape(-1, j, q, s).permute(1, 2, 0, 3).reshape(j, q, -1)  # (n_in, Q, L*S)
    t1 = torch.bmm(oh_q, b).view(j, oh_q.shape[1], -1, s)
    vals = (t1 * oh_r[:, :, None, :]).sum(-1)  # (n_in, n_out, L)
    return vals.permute(2, 0, 1).reshape(*lead, j, oh_q.shape[1])


class LinearMemoryMatrix(_Stateful):
    """Per-connection integer delays: ``y_i = sum_j W_ij * x_j(t - d_ij)``.

    The state is the source's recent history, ``(n_in, width)``: column
    ``k`` holds ``x(t-k)`` and each step writes the input at column 0 (the
    opposite end from ``LinearMemory``'s ring).  ``delays`` is an
    ``(n_out, n_in)`` matrix of step delays; an ``(n_in, n_out)`` one is
    transposed by the weights' rule, the square case included, so that a
    square ``W[a, b]`` and ``D[a, b]`` given in the same layout pair the
    same connection.  ``d_ij = 0`` is this step's input.  Non-integral
    delays must be rounded explicitly (``np.rint(dist / speed / dt)``)
    unless ``mode='interp'``.

    Reads (``mode``), the JAX package's, each selecting exactly one buffer
    slot per connection, so ``onehot``, ``factored`` and ``gather`` give
    the same values bit for bit (at float32 on the card only while the
    products do not run in TF32: ``torch.backends.cuda.matmul.allow_tf32``
    must stay ``False``, PyTorch's default):

    - ``factored``: the delay as two digits, ``d = q*S + r`` with ``S ~
      sqrt((max_delay+1)/5)`` (or ``fine_s``); the buffer, ``Q*S`` wide,
      reshapes to ``(n_in, Q, S)``; a batched product with the ``(n_in,
      n_out, Q)`` coarse one-hot, then a reduction with the ``(n_in, n_out,
      S)`` fine one-hot.  ``n*m*(Q+S)`` selector elements.
    - ``onehot``: one product with the full ``(n_in, n_out, max_delay+1)``
      selector.
    - ``gather``: ``torch.gather`` of ``(n_in, n_out)`` slots.
    - ``auto``: ``factored`` while ``n_in*n_out*(Q+S)`` is at most
      ``RECTIPY_DELAY_FACTORED_LIMIT`` (default 2^27), else ``gather``: the
      JAX package's rule, kept so that both packages pick the same read.
    - ``interp``: continuous delays; the selector is the hat ``max(0, 1 -
      |d_ij - k|)`` (linear interpolation between the two adjacent slots,
      exactly the one-hot at integer ``d``).  ``train_delays=True`` (with
      ``train='gd'``) trains the float delay matrix ``params['delays']``
      by BPTT, clipped to ``[0, max_delay]``; ``self.delays`` keeps the
      initial values.  Past ``RECTIPY_DELAY_HAT_LIMIT`` elements (default
      2^24), or with ``interp_impl='factored2'``, the read is a two-point
      blend of factored integer reads (floor and ceil), value- and
      gradient-identical to the hat.

    The selectors are built once per run by ``prep_params`` (called by
    ``Network._prep_params``, and inside the differentiated loss of the
    trainers, so trainable delays get their gradient); a step without them
    (the eager ``forward``) builds its own.  ``selector_builds`` counts the
    builds.  ``read_dtype`` (or ``RECTIPY_DELAY_READ_DTYPE``) streams the
    selectors of the ``onehot``, ``factored`` and factored-interp reads in a
    reduced float type and casts the buffer once a step: the read is the
    history rounded once to ``read_dtype``.  ``fine_s`` (or
    ``RECTIPY_DELAY_FINE_S``) sets ``S``.
    """

    _tensors = ["weights", "buffer", "delays"]

    def __init__(self, n_in: int, n_out: int, delays, weights=None, dtype=None,
                 detach: bool = True, mode: str = "auto", train_delays: bool = False,
                 max_delay: Optional[int] = None, read_dtype=None,
                 fine_s: Optional[int] = None, interp_impl: str = "auto", **kwargs):
        if train_delays:
            if mode not in ("auto", "interp"):
                raise ValueError("train_delays=True requires the 'interp' read "
                                 f"(continuous delays); got mode={mode!r}.")
            mode = "interp"
            kwargs.setdefault("train_params", ["weights", "delays"])
        else:
            kwargs.setdefault("train_params", ["weights"])
        super().__init__(n_in, n_out, weights=weights, dtype=dtype, detach=detach, **kwargs)
        if isinstance(delays, torch.Tensor):
            delays = delays.detach().cpu().numpy()
        delays = np.asarray(delays)
        if delays.ndim != 2:
            raise ValueError("LinearMemoryMatrix requires a 2-D (n_out, n_in) delay matrix; "
                             "use LinearMemory for per-source (1-D) delays.")
        # the weights' transpose rule exactly, the square case included
        if delays.shape == (n_in, n_out):
            delays = delays.T
        elif delays.shape != (n_out, n_in):
            raise ValueError(
                f"Shape of the delay matrix {delays.shape} does not match the edge "
                f"dimensions ({n_out}, {n_in}).")
        if self.params["weights"].ndim != 2:
            raise ValueError("LinearMemoryMatrix requires 2-D weights (per-connection "
                             "delays have no diagonal form).")
        if delays.min() < 0:
            raise ValueError("Delays must be non-negative step counts.")
        if mode == "interp":
            delays_f = delays.astype(np.float64)
            self.max_delay = int(max_delay) if max_delay is not None \
                else int(np.ceil(delays_f.max()))
            if delays_f.max() > self.max_delay:
                raise ValueError(f"delays exceed max_delay={self.max_delay}")
            self.delays = torch.as_tensor(delays_f, device=self.device)
            self._register_param("delays", _as_tensor(delays_f, self.dtype, self.device))
            if train_delays and "delays" not in self.train_keys:
                raise ValueError(
                    "train_delays=True requires a trainable edge: pass "
                    "train='gd' to add_edge (or detach=False).")
            delays = np.rint(delays_f).astype(np.int64)
        else:
            if not np.issubdtype(delays.dtype, np.integer):
                if not np.allclose(delays, np.rint(delays)):
                    raise ValueError(
                        "Delays must be integer step counts; got non-integral values "
                        "(e.g. distance/speed/dt results -- round them explicitly, "
                        "np.rint(dist / speed / dt), so the discretization is a "
                        "deliberate choice rather than a silent floor -- or use "
                        "mode='interp' for true fractional delays).")
            delays = np.rint(delays).astype(np.int64)
            self.delays = torch.as_tensor(delays, device=self.device)
            self.max_delay = int(delays.max())
        self._dT = torch.as_tensor(np.ascontiguousarray(delays.T), device=self.device)
        if mode not in ("auto", "onehot", "factored", "gather", "interp"):
            raise ValueError(f"Unknown delay-matrix mode {mode!r}; "
                             "use 'auto', 'onehot', 'factored', 'gather' or 'interp'.")
        if read_dtype is None and os.environ.get("RECTIPY_DELAY_READ_DTYPE"):
            read_dtype = os.environ["RECTIPY_DELAY_READ_DTYPE"]
        self.read_dtype = resolve_dtype(read_dtype) if read_dtype is not None else None
        if self.read_dtype is not None and not self.read_dtype.is_floating_point:
            raise ValueError(f"read_dtype must be a floating dtype; got {read_dtype!r}")
        D1 = self.max_delay + 1
        if fine_s is None and os.environ.get("RECTIPY_DELAY_FINE_S"):
            fine_s = int(os.environ["RECTIPY_DELAY_FINE_S"])
        S = int(fine_s) if fine_s is not None else max(1, int(round(np.sqrt(D1 / 5.0))))
        if S < 1 or S > D1:
            raise ValueError(f"fine_s must be in [1, max_delay+1]; got {S}")
        Q = -(-D1 // S)
        if mode == "auto":
            limit_f = int(os.environ.get("RECTIPY_DELAY_FACTORED_LIMIT", 2 ** 27))
            mode = "factored" if n_in * n_out * (Q + S) <= limit_f else "gather"
        self.mode = mode
        # factored: Q*S wide, so the buffer reshapes to (n_in, Q, S) for free
        # (the extra slots hold older history and are never selected)
        buf_width = Q * S if mode == "factored" else D1
        self._interp_impl = None
        if mode == "interp":
            if interp_impl not in ("auto", "hat", "factored2"):
                raise ValueError(
                    f"interp_impl must be 'auto', 'hat' or 'factored2'; got {interp_impl!r}")
            if interp_impl == "auto":
                hat_limit = int(os.environ.get("RECTIPY_DELAY_HAT_LIMIT", 2 ** 24))
                interp_impl = "hat" if n_in * n_out * D1 <= hat_limit else "factored2"
            self._interp_impl = interp_impl
            if interp_impl == "factored2":
                buf_width = Q * S
        self._fQS = (Q, S)
        self._D1 = D1
        self.selector_builds = 0
        self._state = torch.zeros((n_in, buf_width), dtype=self.dtype, device=self.device)

    @property
    def _sel_dtype(self) -> torch.dtype:
        # 0/1 is exact in any float type: a reduced read_dtype halves the
        # selector stream without changing which slot is selected
        return self.read_dtype if self.read_dtype is not None else self.dtype

    def _build_oh_full(self):
        self.selector_builds += 1
        return _one_hot(self._dT, self._D1, self._sel_dtype)

    def _build_oh_factored(self):
        self.selector_builds += 1
        Q, S = self._fQS
        return (_one_hot(self._dT // S, Q, self._sel_dtype),
                _one_hot(self._dT % S, S, self._sel_dtype))

    def _delays_t(self, d: torch.Tensor) -> torch.Tensor:
        """The float delays ``(..., n_out, n_in)`` clipped to ``[0,
        max_delay]``, as ``(..., n_in, n_out)``."""
        return _clip(d, 0.0, float(self.max_delay)).transpose(-1, -2)

    def _build_hat(self, d):
        """The triangular selector ``hat[j, i, k] = max(0, 1 - |d_ij - k|)``
        from a float delay matrix (one per trial for ``(B, n_out, n_in)``);
        differentiable in ``d``."""
        self.selector_builds += 1
        dT = self._delays_t(d)
        k = torch.arange(self._D1, dtype=dT.dtype, device=dT.device)
        z = dT[..., None] - k
        # |z| with the JAX package's gradient at 0 (+1, where torch.abs gives 0)
        return _clip(1.0 - torch.where(z >= 0, z, -z), 0.0, 1.0).to(self.dtype)

    def _build_interp_factored(self, d):
        """The two-point factored interpolation: ``(f, oh_q(lo), oh_r(lo),
        oh_q(hi), oh_r(hi))`` with ``vals = (1-f) * read(floor(d)) + f *
        read(ceil(d))``; the delay gradient flows through ``f``."""
        self.selector_builds += 1
        Q, S = self._fQS
        dc = self._delays_t(d)
        lo = torch.floor(dc)
        f = (dc - lo).to(self.dtype)
        lo_i = lo.to(torch.int64)
        hi_i = torch.clamp(lo_i + 1, max=self.max_delay)
        sd = self._sel_dtype
        return (f, _one_hot(lo_i // S, Q, sd), _one_hot(lo_i % S, S, sd),
                _one_hot(hi_i // S, Q, sd), _one_hot(hi_i % S, S, sd))

    def prep_params(self, sub: Dict) -> Dict:
        """``sub`` with the read's selectors added (once per run, outside
        the time loop); idempotent."""
        if self.mode == "onehot" and "_oh" not in sub:
            return {**sub, "_oh": self._build_oh_full()}
        if self.mode == "factored" and "_oh_q" not in sub:
            oh_q, oh_r = self._build_oh_factored()
            return {**sub, "_oh_q": oh_q, "_oh_r": oh_r}
        if self.mode == "interp" and not ({"_hat", "_f"} & set(sub)):
            if self._interp_impl == "hat":
                return {**sub, "_hat": self._build_hat(sub["delays"])}
            f, oql, orl, oqh, orh = self._build_interp_factored(sub["delays"])
            return {**sub, "_f": f, "_oq_lo": oql, "_or_lo": orl, "_oq_hi": oqh,
                    "_or_hi": orh}
        return sub

    @property
    def buffer(self):
        return self._state

    def make_step(self) -> Callable:
        dT = self._dT
        mode, impl = self.mode, self._interp_impl
        Q, S = self._fQS
        rd, dtype = self.read_dtype, self.dtype

        def cast(b):
            return b.to(rd) if rd is not None else b

        def factored(buf, oh_q, oh_r):
            buf3 = cast(buf.reshape(*buf.shape[:-1], Q, S))
            return _select_factored(oh_q, oh_r, buf3).to(dtype)

        def step(buf, params, x):
            # shift the history one step older and write x(t) at column 0
            buf = torch.cat([x[..., None], buf[..., :-1]], dim=-1)
            if mode == "onehot":
                oh = params["_oh"] if "_oh" in params else self._build_oh_full()
                vals = _select(oh, cast(buf)).to(dtype)
            elif mode == "interp" and impl == "hat":
                hat = params["_hat"] if "_hat" in params else self._build_hat(params["delays"])
                vals = _select(hat, buf)
            elif mode == "interp":
                if "_f" in params:
                    f, sel = params["_f"], (params["_oq_lo"], params["_or_lo"],
                                            params["_oq_hi"], params["_or_hi"])
                else:
                    f, *sel = self._build_interp_factored(params["delays"])
                # the blend stays in dtype: f carries the delay gradient
                vals = ((1.0 - f) * factored(buf, sel[0], sel[1])
                        + f * factored(buf, sel[2], sel[3]))
            elif mode == "factored":
                if "_oh_q" in params:
                    oh_q, oh_r = params["_oh_q"], params["_oh_r"]
                else:
                    oh_q, oh_r = self._build_oh_factored()
                vals = factored(buf, oh_q, oh_r)
            else:
                vals = torch.gather(buf, -1, dT.expand(*buf.shape[:-1], dT.shape[1]))
            # y_i = sum_j W_ij vals_ji
            return buf, (params["weights"].transpose(-1, -2) * vals).sum(-2)

        return step


class BlockSparseLinear(Linear):
    """Block-sparse edge projection, optionally with per-block conduction
    delays: ``y[r*bs:(r+1)*bs] = sum_c blocks[r, c] @ x_{cols[r, c]}(t -
    d[r, c])``, where ``x_b`` is source block ``b``.

    The weights are a ``BlockSparseCoupling`` (``ops/sparse.py``), the
    fixed-degree tiles of the node-level block coupling; ``delays`` (one
    integer step count per (target block, source block) pair, ``(n_br,
    cb)``) model ``d = distance / velocity`` between local patches, the
    population-scale companion of ``LinearMemoryMatrix``.

    The delay state is a circular history ``(nb_in, D1, bs)`` with a step
    cursor ``t``, never a shifted ring: each step writes the input at slot
    ``t mod D1`` and gathers the ``(n_br, cb)`` blocks at slots ``(t - d)
    mod D1``.  Unwritten slots are zero and ``d <= D1 - 1``, so ``t - d <
    0`` reads zeros, and ``d = 0`` reads this step's input.  The state
    ``(hist, t)`` rides ``run`` and is written back (chunked runs continue
    exactly); ``delays=None`` gives a stateless edge.

    ``block_dtype`` streams the blocks and the gathered sources at a
    reduced floating type (``bfloat16``: exact products, sums at the
    edge's accumulation type, float32 or float64), cast once per run by
    ``prep_params`` (and in the step where no prep ran, as in training,
    where the master stays full precision); ``'int8_master'`` quantizes
    the blocks per output row with a dynamic activation scale per gathered
    stack: a frozen edge quantizes once per run and contracts through the
    ``block_int8_mv`` kernel with the straight-through source gradient (the
    JAX package's frozen edge gives zero source gradients here); a
    trainable one takes the in-step STE apply (``ops/quant.py``).
    """

    _tensors = ["weights"]

    def __init__(self, n_in: int, n_out: int, weights, delays=None, dtype=None,
                 detach: bool = True, block_dtype=None, device=None, **kwargs):
        if not hasattr(weights, "blocks"):
            raise ValueError(
                "BlockSparseLinear requires a BlockSparseCoupling as weights "
                "(rectipy_tpu_torch.block_random_connectivity builds one).")
        from .ops.sparse import blocks_to_device

        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self.block_dtype = None
        self._int8_master = block_dtype == "int8_master"
        if block_dtype is not None and not self._int8_master:
            bd = resolve_dtype(block_dtype)
            if not bd.is_floating_point:
                raise ValueError(f"block_dtype must be a floating dtype or 'int8_master'; "
                                 f"got {block_dtype!r}")
            if bd != self.dtype:  # the same type: stream at master precision
                self.block_dtype = bd
        blocks = weights.blocks
        cols = np.asarray(weights.cols, dtype=np.int64)
        n_br, cb, bs, _ = blocks.shape
        if n_br * bs != n_out:
            raise ValueError(f"block rows x block size = {n_br}x{bs} != n_out={n_out}")
        if n_in % bs:
            raise ValueError(f"n_in={n_in} must be a multiple of the block size {bs}")
        nb_in = n_in // bs
        if cols.size and (cols.min() < 0 or cols.max() >= nb_in):
            raise ValueError(f"cols reference source blocks outside [0, {nb_in})")
        self.n_in, self.n_out = n_in, n_out
        self.bs, self.nb_in = bs, nb_in
        self.cols = torch.as_tensor(cols, device=self.device)
        self.params: Dict[str, torch.Tensor] = {
            "weights": blocks_to_device(blocks, self.dtype, self.device)}
        self.train_keys = []
        self._train_req = []
        if not detach:
            train_params = kwargs.pop("train_params", self._tensors)
            self._train_req = list(train_params)
            self.train_keys = [k for k in self._tensors if k in train_params and k in self.params]
        self.delays = None
        self.max_delay = 0
        if delays is not None:
            if isinstance(delays, torch.Tensor):
                delays = delays.detach().cpu().numpy()
            delays = np.asarray(delays)
            if delays.shape != (n_br, cb):
                raise ValueError(
                    f"Per-block delays must be ({n_br}, {cb}) -- one per (target-block, "
                    f"source-block) pair like cols; got {delays.shape}.")
            if not np.issubdtype(delays.dtype, np.integer) \
                    and not np.allclose(delays, np.rint(delays)):
                raise ValueError("Block delays must be integer step counts; round "
                                 "distance/velocity/dt results explicitly (np.rint).")
            delays = np.rint(delays).astype(np.int64)
            if delays.min() < 0:
                raise ValueError("Delays must be non-negative step counts.")
            self.delays = torch.as_tensor(delays, device=self.device)
            self.max_delay = int(delays.max())
        self._D1 = self.max_delay + 1
        self._state = None
        if self.delays is not None:
            self._state = (torch.zeros((nb_in, self._D1, bs), dtype=self.dtype,
                                       device=self.device),
                           torch.zeros((), dtype=torch.int32, device=self.device))
        self._rows: Dict[int, torch.Tensor] = {}

    @property
    def weights(self):
        return self.params["weights"]

    @weights.setter
    def weights(self, w):
        if hasattr(w, "blocks"):
            w = w.blocks
        w = _as_tensor(w, self.dtype, self.device)
        if w.shape != self.params["weights"].shape:
            raise ValueError(f"block weights must keep shape "
                             f"{tuple(self.params['weights'].shape)}; got {tuple(w.shape)}")
        self.params["weights"] = w

    def init_state(self):
        return self._state

    def set_state(self, state):
        if self.delays is not None:
            self._state = state

    def prep_params(self, sub: Dict) -> Dict:
        """The once-per-run block-stream cast (``block_dtype``), or the
        ``int8_master`` quantization of a frozen edge; a trainable
        ``int8_master`` edge keeps its master (its step takes the STE
        apply).  Idempotent."""
        if self._int8_master:
            if self.train_keys or isinstance(sub.get("weights"), tuple):
                return sub
            from .ops.quant import quantize_blocks

            return {**sub, "weights": quantize_blocks(sub["weights"].detach())}
        bd = self.block_dtype
        if bd is None or sub["weights"].dtype == bd:
            return sub
        return {**sub, "weights": sub["weights"].to(bd)}

    def _arange(self, L: int) -> torch.Tensor:
        if L not in self._rows:
            self._rows[L] = torch.arange(L, device=self.device)
        return self._rows[L]

    def make_step(self) -> Callable:
        from .ops.quant import block_int8_stack_prepped, make_block_int8_stack_apply
        from .ops.sparse import block_contract

        cols, bs, nb_in, D1 = self.cols, self.bs, self.nb_in, self._D1
        n_br, cb = cols.shape
        dtype, bd, int8m = self.dtype, self.block_dtype, self._int8_master
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        ste = make_block_int8_stack_apply()

        def contract(w, s_blk):
            if int8m:
                y = block_int8_stack_prepped(w, s_blk) if isinstance(w, tuple) else ste(w, s_blk)
                return y.to(acc)
            if bd is not None:  # a no-op where prep already cast the blocks
                w, s_blk = w.to(bd), s_blk.to(bd)
            return block_contract(w, s_blk, acc).reshape(*s_blk.shape[:-3], n_br * bs)

        if self.delays is None:
            def step(state, params, x):
                s_blk = x.to(dtype).reshape(*x.shape[:-1], nb_in, bs)[..., cols, :]
                return state, contract(params["weights"], s_blk).to(dtype)

            return step

        dmat = self.delays
        nb = torch.arange(nb_in, device=self.device)[None, :]

        def step(state, params, x):
            hist, t = state
            lead = x.shape[:-1]
            L = int(np.prod(lead, dtype=np.int64)) if lead else 1
            rows = self._arange(L)
            k = torch.remainder(t, D1).reshape(L).long()
            h = hist.reshape(L, nb_in, D1, bs)
            # write x(t) at slot t mod D1 of every source block's history
            h = h.index_put((rows[:, None], nb, k[:, None]),
                            x.to(hist.dtype).reshape(L, nb_in, bs))
            # read each (target, source) block pair at slot (t - d) mod D1
            flat = cols * D1 + torch.remainder(k[:, None, None] - dmat, D1)
            s_blk = h.reshape(L, nb_in * D1, bs)[rows[:, None, None], flat]
            y = contract(params["weights"], s_blk.reshape(*lead, n_br, cb, bs))
            return (h.reshape(hist.shape), t + 1), y.to(dtype)

        return step

    def forward(self, x, **kwargs):
        state, y = self._eager(self.init_state(), x)
        self.set_state(state)
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
