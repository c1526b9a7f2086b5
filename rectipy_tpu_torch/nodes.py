"""Node runtime: ODE populations, spiking wrappers, and stateless activations.

Counterpart of ``rectipy_tpu/nodes.py`` on PyTorch.  Every node exposes a
step function ``step(y, args, x) -> (y_new, out)`` built by ``make_step()``;
the object API (``forward``/``reset``/``set_param``/``__getitem__``) is a
thin wrapper holding the current ``y`` tensor and ``args`` dict.
``Network.compile`` composes these steps into one network step.  Steps are
functional: they return new tensors and never write their inputs in place.
Every step takes a state ``(S,)`` or, for ``Network.run_batch`` and
``fit_bptt_batch``, a leading trial axis ``(B, S)``: state blocks are slices
of the last axis, and parameters swept per trial arrive as ``(B, 1)`` or
``(B, n)`` and broadcast.

Semantics (as in the JAX package and RectiPy):
- ``RateNet.forward``: one explicit-Euler step (or a Heun/RK4 step with
  ``integrator='heun'|'rk4'``, RateNet only), returns the *pre-update*
  output slice.
- ``SpikeResetNet``: surrogate spikes from the reset-variable slice, spikes
  scaled by 1/dt into the spike input, detached hard reset of the slice.
- ``SpikeNet``: spikes/dt into the spike input and, detached, into the
  reset input; no hard reset (the equations implement it); returns the
  *post-update* output.
- ``MultiSpikeResetNet``: one spike input and one hard-reset segment per
  entry of a list ``spike_var``/``reset_var``; returns the *post-update*
  output.
- The three spiking classes give ``_make_spike_reader()``: the detached 0/1
  spike decision of a pre-update state, which ``record_spikes`` counts.

Devices: every node lives on one device.  ``device=None`` means CUDA and
raises when no CUDA device is present; the CPU must be asked for with
``device="cpu"``.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from .dsl import NodeTemplate, lower
from .ops.surrogate import default_spike_slope, make_spike_fn

__all__ = [
    "InstantNode",
    "MultiSpikeResetNet",
    "RateNet",
    "SpikeNet",
    "SpikeResetNet",
    "resolve_dtype",
    "resolve_device",
]


def resolve_dtype(dtype) -> torch.dtype:
    """Accept torch dtypes, strings ('float32'/'float64'/'bfloat16') and
    numpy/JAX dtype objects.  ``None`` means float32: unlike the JAX
    package, whose default follows its global x64 flag, the port's default
    is fixed."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    s = str(dtype)
    if "bfloat16" in s:
        return torch.bfloat16
    if "float64" in s or s == "double":
        return torch.float64
    if "float32" in s or s == "float":
        return torch.float32
    if "float16" in s or s == "half":
        return torch.float16
    if "int8" in s:
        return torch.int8
    raise TypeError(f"Unsupported dtype {dtype!r}")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, or ``RuntimeError`` without one
    (the port never falls back to the CPU on its own)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "No CUDA device is available. rectipy_tpu_torch runs on the GPU "
                "unless told otherwise: pass device='cpu' to run on the CPU.")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dtype)


class InstantNode:
    """Stateless activation node.

    Supported: tanh, sigmoid, softmax, softmin, log_softmax, identity.
    ``softmax``-family defaults to axis 0, matching ``torch.nn.Softmax(dim=0)``.
    """

    def __init__(self, n: int, func: str, **kwargs):
        axis = kwargs.pop("dim", kwargs.pop("axis", 0))
        if func == "tanh":
            f = torch.tanh
        elif func == "sigmoid":
            f = torch.sigmoid
        elif func == "softmax":
            f = lambda x: torch.softmax(x, dim=axis)
        elif func == "softmin":
            f = lambda x: torch.softmax(-x, dim=axis)
        elif func == "log_softmax":
            f = lambda x: torch.log_softmax(x, dim=axis)
        elif func == "identity":
            f = lambda x: x
        else:
            raise ValueError(
                f"Invalid keyword argument `func`: {func} is not a valid option. See the "
                f"docstring of `Network.add_func_node` for valid options."
            )
        self.n_in = n
        self.n_out = n
        self.func = f
        self.func_name = func
        self._axis = axis

    def _row_func(self, x):
        dim = self._axis - 1 if x.dim() > 1 and self._axis >= 0 else self._axis
        if self.func_name == "log_softmax":
            return torch.log_softmax(x, dim=dim)
        return torch.softmax(-x if self.func_name == "softmin" else x, dim=dim)

    def __getitem__(self, item):
        # function nodes have no parameters or state variables; raising lets
        # Network.get_var fall through to its graph-attribute fallback and
        # Network.set_var raise its documented KeyError
        raise KeyError(f"InstantNode has no variable or parameter {item!r}.")

    def set_param(self, param, val):
        raise KeyError(f"InstantNode has no parameter {param!r}.")

    def __call__(self, x):
        return self.forward(x)

    def forward(self, x):
        return self.func(x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x)))

    def parameters(self, **kwargs) -> Iterator:
        return iter(())

    # -- functional protocol -------------------------------------------------
    def init_state(self):
        return None

    @property
    def args(self) -> dict:
        return {}

    @property
    def train_keys(self) -> list:
        return []

    def _shard(self, r0: int, r1: int, gather: Callable, group=None) -> "InstantNode":
        """The node on neurons ``[r0, r1)`` (``parallel/``); an elementwise
        activation only: the softmax family acts on the whole vector."""
        del gather, group
        if self.func_name not in ("tanh", "sigmoid", "identity"):
            return None
        loc = copy.copy(self)
        loc.n_in = loc.n_out = r1 - r0
        return loc

    def make_step(self) -> Callable:
        f = self.func
        if self.func_name in ("softmax", "softmin", "log_softmax"):
            # the axis counts in one trial's (n,) vector; per-trial rows
            # (B, n) reduce over their last axis
            f = self._row_func

        def step(state, args, x):
            del args
            return state, f(x)

        return step


class RateNet:
    """ODE population node: explicit-Euler (or Heun/RK4) integration of a
    lowered vector field.

    - ``RateNet(func, args_tuple, var_map, param_map_with_indices)`` with a
      hand-written ``func(t, y, *args)`` -- used for runtime tests decoupled
      from the YAML frontend.
    - ``RateNet.from_pyrates(...)`` / ``from_template(...)`` -- the DSL path.
    """

    state_vars = ["y"]
    # the state offsets a population shard maps to its own layout
    _state_offsets = ("_start", "_stop")

    def __init__(
        self,
        rnn_func: Callable,
        rnn_args: Union[tuple, list, dict],
        var_map: dict,
        param_map: dict,
        dt: float = 1e-3,
        dtype=None,
        train_params: Optional[list] = None,
        y0: Optional[torch.Tensor] = None,
        vf=None,
        device=None,
        **kwargs,
    ):
        self.dt = float(dt)
        self.dtype = resolve_dtype(dtype)
        self.device = resolve_device(device)
        self._vf = vf
        # 'euler' (the reference's scheme), 'heun' (RK2) or 'rk4'; RateNet
        # only: the spiking wrappers need the Euler update/reset interleaving
        self.integrator = str(kwargs.pop("integrator", "euler"))
        if self.integrator not in ("euler", "heun", "rk4"):
            raise ValueError(
                f"Unknown integrator {self.integrator!r}; use 'euler', 'heun' or 'rk4'")
        if self.integrator != "euler" and type(self).__name__ != "RateNet":
            raise ValueError(
                f"integrator={self.integrator!r} is only supported on RateNet nodes")

        if isinstance(rnn_args, (tuple, list)):
            # raw mode: args[0] is the initial state, the rest are positional
            # vector-field arguments addressed by index.
            y_init = rnn_args[0]
            rest = list(rnn_args[1:])
            self._keys = [f"arg{i}" for i in range(len(rest))]
            self._args: Dict[str, object] = {
                k: (_as_tensor(v, self.dtype, self.device)
                    if isinstance(v, (np.ndarray, torch.Tensor)) else v)
                for k, v in zip(self._keys, rest)
            }
            order = list(self._keys)
            raw = rnn_func

            def canonical(t, y, a, _raw=raw, _order=order):
                return _raw(t, y, *[a[k] for k in _order])

            self.func = canonical
            self._param_map = {
                name: (self._keys[idx] if isinstance(idx, int) else idx)
                for name, idx in param_map.items()
            }
        else:
            y_init = y0
            self._args = dict(rnn_args)
            self._keys = list(self._args.keys())
            self.func = rnn_func
            self._param_map = dict(param_map)

        self._var_map = {
            k: (tuple(v) if isinstance(v, (list, tuple)) else v) for k, v in var_map.items()
        }
        if "out" not in self._var_map and vf is None:
            raise KeyError("var_map must contain an 'out' entry")

        if y_init is None:
            raise ValueError("No initial state provided")
        self.y = _as_tensor(y_init, self.dtype, self.device)

        # output window
        out_spec = self._var_map.get("out")
        if isinstance(out_spec, tuple):
            self._start, self._stop = int(out_spec[0]), int(out_spec[-1])
            self._out_alg: Optional[str] = None
        else:
            # algebraic output variable (e.g. output_var='tanh_op/r'): computed
            # from the state at read time via the lowered read_var
            if vf is None or vf.read_var is None:
                raise KeyError(f"Output variable spec {out_spec!r} requires a lowered vector field")
            self._out_alg = str(out_spec)
            self._start, self._stop = 0, vf.n

        self.n_out = self._stop - self._start

        # external-input arg
        if "in" not in self._param_map:
            raise KeyError("param_map must contain an 'in' entry")
        self._inp_key = self._param_map["in"]
        in_arg = self._args.get(self._inp_key)
        self.n_in = int(in_arg.shape[0]) if getattr(in_arg, "ndim", 0) > 0 else 1

        # trainable parameters
        self.train_keys: List[str] = []
        for p in train_params or ():
            try:
                self.train_keys.append(self._param_map[p])
            except KeyError:
                raise KeyError(f"Train parameter {p!r} was not found on the node.")
        for k in self.train_keys:
            val = self._args.get(k)
            if isinstance(val, torch.Tensor) and val.dtype == torch.int8:
                raise ValueError(
                    f"Parameter {k!r} is stored frozen-quantized (coupling_dtype='int8' or "
                    f"'int4') and cannot be trained directly; train with float32/bfloat16 "
                    f"or an 'int8_master'/'int4_master' coupling instead.")

        self._step_fn = None  # cached step of forward(); attach resets it
        self._step_version = 0

    # -- dict-style access ----------------------------------------------------
    def __getitem__(self, item):
        try:
            return self._args[self._param_map[item]]
        except KeyError:
            pass
        idx = self._var_map[item]  # KeyError propagates, as in RectiPy
        if isinstance(idx, tuple):
            return self.y[idx[0]:idx[1]]
        if isinstance(idx, str):  # algebraic variable
            return self._vf.read_var(idx, self.y, self._args)
        return self.y[idx]

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    @property
    def parameter_names(self) -> list:
        return list(self._param_map.keys())

    @property
    def variable_names(self) -> list:
        return list(self._var_map.keys())

    @property
    def args(self) -> dict:
        return self._args

    @property
    def train_params(self) -> list:
        """Current values of the trainable parameters."""
        return [self._args[k] for k in self.train_keys]

    # -- construction from the DSL --------------------------------------------
    @classmethod
    def from_pyrates(
        cls,
        node: Union[str, NodeTemplate],
        input_var: str,
        output_var: str,
        weights: Optional[np.ndarray] = None,
        source_var: Optional[str] = None,
        target_var: Optional[str] = None,
        train_params: Optional[list] = None,
        **kwargs,
    ):
        """Build a node from a YAML template (name kept for drop-in parity
        with RectiPy; the lowering is this package's own DSL)."""
        dt = kwargs.pop("dt", 1e-3)
        dtype = resolve_dtype(kwargs.pop("dtype", kwargs.pop("float_precision", None)))
        device = resolve_device(kwargs.pop("device", None))
        kwargs.pop("clear", None)
        kwargs.pop("verbose", None)
        kwargs.pop("file_name", None)
        if "N" in kwargs and "n" in kwargs:
            raise ValueError("Pass the population size as either N= or n=, not both.")
        n = kwargs.pop("N", None)
        if n is None:
            n = kwargs.pop("n", None)
        else:
            kwargs.pop("n", None)
        node_vars = kwargs.pop("node_vars", kwargs.pop("node_values", None))
        param_mapping = dict(kwargs.pop("param_mapping", {}))
        param_mapping.setdefault("in", input_var)
        var_mapping = dict(kwargs.pop("var_mapping", {}))
        var_mapping.setdefault("out", output_var)
        extra_edges = kwargs.pop("edges", None)
        coupling_dtype = kwargs.pop("coupling_dtype", None)
        if coupling_dtype is not None and str(coupling_dtype) not in (
                "bfloat16_master", "bf16_master", "int8_master", "int4_master", "int4"):
            coupling_dtype = resolve_dtype(coupling_dtype)

        vf = lower(
            node,
            n=n,
            weights=weights,
            source_var=source_var,
            target_var=target_var,
            node_vars=node_vars,
            dtype=dtype,
            edges=extra_edges,
            coupling_dtype=coupling_dtype,
            device=device,
        )

        # parameter map: lowered names plus user-facing aliases
        param_map = dict(vf.param_map)
        if weights is not None:
            param_map.setdefault("weights", "weights")
        for alias, target in param_mapping.items():
            key = _strip_all(target)
            if key in param_map:
                param_map[alias] = param_map[key]
            elif key in vf.args:
                param_map[alias] = key
            else:
                raise KeyError(f"Parameter {target!r} (alias {alias!r}) not found in lowered node")

        # variable map: state slices plus aliases (state slice or algebraic name)
        var_map: Dict[str, Union[Tuple[int, int], str]] = dict(vf.var_map)
        for alias, target in var_mapping.items():
            key = _strip_all(target)
            if key in vf.var_map:
                var_map[alias] = vf.var_map[key]
            elif key in vf.alg_vars or any(a.endswith("/" + key) for a in vf.alg_vars):
                qname = key if key in vf.alg_vars else next(a for a in vf.alg_vars if a.endswith("/" + key))
                var_map[alias] = qname
            else:
                raise KeyError(f"Variable {target!r} (alias {alias!r}) not found in lowered node")

        return cls(
            vf.func,
            vf.args,
            var_map,
            param_map,
            dt=dt,
            dtype=dtype,
            train_params=train_params,
            y0=vf.y0,
            vf=vf,
            device=device,
            **kwargs,
        )

    from_template = from_pyrates

    # -- step -------------------------------------------------------------------
    def make_step(self) -> Callable:
        """Step: ``(y, args, x) -> (y_new, out_pre_update)``."""
        func, dt, inp_key = self.func, self.dt, self._inp_key
        reader = self._make_out_reader()

        if self.integrator == "heun":
            def step(y, args, x):
                a = dict(args)
                a[inp_key] = x
                out = reader(y, a)
                k1 = func(0.0, y, a)
                k2 = func(0.0, y + dt * k1, a)
                return y + (dt * 0.5) * (k1 + k2), out

            return step

        if self.integrator == "rk4":
            def step(y, args, x):
                a = dict(args)
                a[inp_key] = x
                out = reader(y, a)
                k1 = func(0.0, y, a)
                k2 = func(0.0, y + (dt * 0.5) * k1, a)
                k3 = func(0.0, y + (dt * 0.5) * k2, a)
                k4 = func(0.0, y + dt * k3, a)
                return y + (dt / 6.0) * (k1 + 2.0 * (k2 + k3) + k4), out

            return step

        def step(y, args, x):
            a = dict(args)
            a[inp_key] = x
            out = reader(y, a)
            y_new = y + dt * func(0.0, y, a)
            return y_new, out

        return step

    def prep_params(self, args: dict) -> dict:
        """Once-per-run parameter prep: a master coupling is quantized (or
        rounded to bf16) and a frozen int4 coupling packed here, before the
        time loop, instead of every step.  The prepped forms ride along in
        the args under reserved keys that the lowered matvec picks up
        (``dsl/lower.py``).  Identity for the other couplings, and with a
        fused kernel attached.  Inference only: the training paths bypass
        it."""
        prep = getattr(self._vf, "prep_args", None)
        if prep is None or getattr(self, "_fused_attached", False):
            return args
        return prep(args)

    def _make_out_reader(self) -> Callable:
        if self._out_alg is not None:
            read_var, qname = self._vf.read_var, self._out_alg

            def reader(y, a):
                return read_var(qname, y, a)

        else:
            lo, hi = self._start, self._stop

            def reader(y, a):
                del a
                return y[..., lo:hi]

        return reader

    def _shard(self, r0: int, r1: int, gather: Callable, group=None) -> Optional["RateNet"]:
        """The node on neurons ``[r0, r1)`` of its population
        (``parallel/``): the lowered field's shard (``VectorField.localize``:
        the couplings hold those rows and gather their sources), the state
        offsets in the shard's layout (each variable's rows, a block of
        ``r1 - r0``), ``y`` those rows.  The parameters come with the run's
        placed tree.  ``group`` (``parallel/comm.Group``): the model group,
        whose maxima are the quantized couplings' scales.  ``None`` for a
        node that cannot be cut: a hand-written field, or a fused kernel
        (which runs whole)."""
        vf = self._vf
        if vf is None or vf.localize is None or getattr(self, "_fused_attached", False):
            return None
        n, rows = vf.n, r1 - r0

        def at(i: int) -> int:  # a block boundary of the whole layout
            return i // n * rows

        loc = copy.copy(self)
        loc._vf = vf.localize(rows, r0, gather, group)
        loc.func = loc._vf.func
        loc._var_map = {k: (at(v[0]), at(v[1])) if isinstance(v, tuple) else v
                        for k, v in self._var_map.items()}
        for name in self._state_offsets:
            setattr(loc, name, at(getattr(self, name)))
        loc.n_out = loc._stop - loc._start
        loc.n_in = rows if self.n_in == n else self.n_in
        loc.y = self.y.reshape(-1, n)[:, r0:r1].reshape(-1)
        loc._step_fn = None
        return loc

    # -- object API ------------------------------------------------------------
    def init_state(self):
        return self.y

    def forward(self, x):
        if self._step_fn is None:
            self._step_fn = self.make_step()
        y_new, out = self._step_fn(self.y, self._args, _as_tensor(x, self.dtype, self.device))
        self.y = y_new
        return out

    def parameters(self, recurse: bool = True) -> Iterator:
        for k in self.train_keys:
            yield self._args[k]

    def detach(self, requires_grad: bool = False, detach_params: bool = False):
        """Cut the state out of any autograd graph it belongs to."""
        self.y = self.y.detach().requires_grad_(requires_grad)

    def reset(self, y=None, idx=None):
        """Set the state to ``y`` (default: zeros), or only the entries
        ``idx`` of it."""
        if y is None:
            y = torch.zeros_like(self.y)
        y = _as_tensor(y, self.dtype, self.device)
        if idx is None:
            if y.shape != self.y.shape:
                raise ValueError(
                    f"Reset state shape {tuple(y.shape)} does not match node state shape "
                    f"{tuple(self.y.shape)}"
                )
            self.y = y
        else:
            idx = np.asarray(idx, dtype=np.int64)
            if idx.size and (idx.max() >= self.y.shape[0] or idx.min() < 0):
                raise ValueError(f"Reset indices out of bounds for state of size {self.y.shape[0]}")
            y_new = self.y.clone()
            y_new[torch.as_tensor(idx, device=self.device)] = y
            self.y = y_new

    def set_param(self, param: str, val):
        """Set the value of a node parameter.

        With a fused kernel attached, the kernel reads its own copies of the
        parameters: the per-neuron parameters and the couplings are
        refreshed here; the scalar parameters are baked into the kernel's
        arguments at attach time, and setting one raises (rebuild the node
        to change it -- keeping the stale value would corrupt the
        simulation)."""
        try:
            key = self._param_map[param]
        except KeyError:
            raise KeyError(f"Parameter {param} was not found on the node.")
        if isinstance(val, (np.ndarray, torch.Tensor, list, tuple)):
            val = _as_tensor(val, self.dtype, self.device)
        self._args[key] = val
        if getattr(self, "_fused_attached", False):
            self._refresh_fused_param(key)

    def _refresh_fused_param(self, key: str):
        """Propagate a parameter update into the attached fused kernel's
        copies (registered by ``ops.kernels.attach_fused_qif_step`` and
        ``ops.generic_fused.attach_generic_fused_step``)."""
        refresh = getattr(self, "_fused_refresh", {}).get(key)
        if refresh is None:
            raise ValueError(
                f"Parameter {key!r} is a scalar baked into the attached fused "
                f"kernel at attach time; rebuild the node (fresh add_diffeq_node "
                f"+ attach) to change it.")
        refresh()

    def set_state(self, y):
        """State setter used by the Network's run loop."""
        self.y = y


class SpikeNet(RateNet):
    """Spiking node with an intrinsic (in-equation) reset: surrogate spikes
    are injected into ``spike_var`` and detached spike events into
    ``reset_var`` every step; the equations implement the reset (e.g.
    ``-2*reset*v`` in ``qif_reset_op``).  The spike condition is read from
    the state variable ``spike_def`` (default ``v``)."""

    _state_offsets = RateNet._state_offsets + ("_spike_lo", "_spike_hi")

    def __init__(self, rnn_func, rnn_args, var_map, param_map, spike_threshold: float = 1e2,
                 spike_reset: float = -1e2, **kwargs):
        spike_center = float(kwargs.pop("spike_center", 1.0))
        spike_slope = float(kwargs.pop("spike_slope", default_spike_slope(spike_threshold, spike_reset)))
        spike_def = kwargs.pop("spike_def", None)
        super().__init__(rnn_func, rnn_args, var_map, param_map, **kwargs)
        self.spike = make_spike_fn(spike_slope, spike_center)
        self._center = spike_center
        self._spike_key = self._param_map["spike_var"]
        self._reset_key = self._param_map["reset_var"]
        self._thresh = float(spike_threshold)
        spike_def = spike_def or self._find_spike_def()
        spec = self._var_map.get(spike_def)
        if not isinstance(spec, tuple):
            raise KeyError(f"spike_def variable {spike_def!r} is not a state variable of the node")
        self._spike_lo, self._spike_hi = int(spec[0]), int(spec[-1])

    def _find_spike_def(self) -> str:
        for cand in ("v", *[k for k in self._var_map if k.endswith("/v")]):
            if isinstance(self._var_map.get(cand), tuple):
                return cand
        raise KeyError("Could not infer the spike-condition state variable; pass `spike_def`")

    @classmethod
    def from_pyrates(cls, node, input_var, output_var, weights=None, source_var=None,
                     target_var=None, spike_var: str = "spike", reset_var: str = "reset",
                     train_params=None, **kwargs):
        kwargs["param_mapping"] = {"spike_var": spike_var, "reset_var": reset_var}
        return super().from_pyrates(node, input_var, output_var, weights, source_var,
                                    target_var, train_params=train_params, **kwargs)

    from_template = from_pyrates

    def make_step(self) -> Callable:
        func, dt, inp_key = self.func, self.dt, self._inp_key
        spike_fn, thresh = self.spike, self._thresh
        skey, rkey = self._spike_key, self._reset_key
        lo, hi = self._spike_lo, self._spike_hi
        reader = self._make_out_reader()

        def step(y, args, x):
            spikes = spike_fn(y[..., lo:hi] - thresh) / dt
            a = dict(args)
            a[skey] = spikes
            a[rkey] = spikes.detach()
            a[inp_key] = x
            y_new = y + dt * func(0.0, y, a)
            return y_new, reader(y_new, a)  # post-update output

        return step

    def _make_spike_reader(self) -> Callable:
        """The spike indicator (0/1, detached) of a PRE-update state ``(n,)``
        or ``(B, S)``: the decision ``make_step`` takes on it.  Backs
        ``record_spikes``."""
        return _spike_reader(self._thresh, self._center, [(self._spike_lo, self._spike_hi)])


class SpikeResetNet(RateNet):
    """Spiking node with a framework-managed hard reset of the reset-variable
    slice after each threshold crossing.  Gradients flow through the
    surrogate spike only; the reset mask is detached."""

    _state_offsets = RateNet._state_offsets + ("_reset_lo", "_reset_hi")

    def __init__(self, rnn_func, rnn_args, var_map, param_map, spike_threshold: float = 1e2,
                 spike_reset: float = -1e2, **kwargs):
        spike_center = float(kwargs.pop("spike_center", 1.0))
        spike_slope = float(kwargs.pop("spike_slope", default_spike_slope(spike_threshold, spike_reset)))
        super().__init__(rnn_func, rnn_args, var_map, param_map, **kwargs)
        self.spike = make_spike_fn(spike_slope, spike_center)
        self._center = spike_center
        self._spike_key = self._param_map["spike_var"]
        self._thresh = float(spike_threshold)
        self._reset_val = float(spike_reset)
        rv = self._var_map["reset_var"]
        if not isinstance(rv, tuple):
            raise KeyError("reset_var must name a state variable for SpikeResetNet")
        self._reset_lo, self._reset_hi = int(rv[0]), int(rv[-1])

    @classmethod
    def from_pyrates(cls, node, input_var, output_var, weights=None, source_var=None,
                     target_var=None, spike_var: str = "spike", reset_var: str = "v",
                     train_params=None, **kwargs):
        if isinstance(spike_var, list):
            return MultiSpikeResetNet.from_pyrates(node, input_var, output_var, weights,
                                                   source_var, target_var, spike_var,
                                                   reset_var, train_params, **kwargs)
        kwargs["param_mapping"] = {"spike_var": spike_var}
        var_mapping = dict(kwargs.pop("var_mapping", {}))
        var_mapping["reset_var"] = reset_var
        kwargs["var_mapping"] = var_mapping
        return super(SpikeResetNet, cls).from_pyrates(node, input_var, output_var, weights,
                                                      source_var, target_var,
                                                      train_params=train_params, **kwargs)

    from_template = from_pyrates

    def make_step(self) -> Callable:
        func, dt, inp_key = self.func, self.dt, self._inp_key
        spike_fn, thresh, v_reset = self.spike, self._thresh, self._reset_val
        skey = self._spike_key
        lo, hi = self._reset_lo, self._reset_hi
        reader = self._make_out_reader()

        def step(y, args, x):
            spikes = spike_fn(y[..., lo:hi] - thresh)
            reset = spikes.detach()
            a = dict(args)
            a[skey] = spikes / dt
            a[inp_key] = x
            out = reader(y, a)  # pre-update output, as in RectiPy
            y_new = y + dt * func(0.0, y, a)
            seg = y_new[..., lo:hi] * (1.0 - reset) + reset * v_reset
            return torch.cat((y_new[..., :lo], seg, y_new[..., hi:]), dim=-1), out

        return step

    def _make_spike_reader(self) -> Callable:
        """The spike indicator of the reset-variable slice of a PRE-update
        state (see ``SpikeNet``); a fused kernel resets exactly the neurons
        it marks."""
        return _spike_reader(self._thresh, self._center, [(self._reset_lo, self._reset_hi)])


class MultiSpikeResetNet(RateNet):
    """Hard spike reset applied to a *list* of state-variable segments
    (multi-compartment models): spike input ``spike_var_i`` and reset
    segment ``spike_reset_i`` per list entry.  Built through
    ``SpikeResetNet.from_pyrates`` with a list ``spike_var``."""

    def __init__(self, rnn_func, rnn_args, var_map, param_map, spike_threshold: float = 1e2,
                 spike_reset: float = -1e2, **kwargs):
        spike_center = float(kwargs.pop("spike_center", 1.0))
        spike_slope = float(kwargs.pop("spike_slope", default_spike_slope(spike_threshold, spike_reset)))
        super().__init__(rnn_func, rnn_args, var_map, param_map, **kwargs)
        self.spike = make_spike_fn(spike_slope, spike_center)
        self._center = spike_center
        self._thresh = float(spike_threshold)
        self._reset_val = float(spike_reset)
        self._spike_keys: List[str] = []
        while f"spike_var_{len(self._spike_keys)}" in self._param_map:
            self._spike_keys.append(self._param_map[f"spike_var_{len(self._spike_keys)}"])
        self._segments: List[Tuple[int, int]] = []
        for j in range(len(self._spike_keys)):
            lo, hi = self._var_map[f"spike_reset_{j}"]
            self._segments.append((int(lo), int(hi)))

    @classmethod
    def from_pyrates(cls, node, input_var, output_var, weights=None, source_var=None,
                     target_var=None, spike_var=("spike",), reset_var=("v",),
                     train_params=None, **kwargs):
        kwargs["param_mapping"] = {f"spike_var_{i}": sv for i, sv in enumerate(spike_var)}
        var_mapping = dict(kwargs.pop("var_mapping", {}))
        var_mapping.update({f"spike_reset_{i}": rv for i, rv in enumerate(reset_var)})
        kwargs["var_mapping"] = var_mapping
        return super(MultiSpikeResetNet, cls).from_pyrates(node, input_var, output_var, weights,
                                                           source_var, target_var,
                                                           train_params=train_params, **kwargs)

    from_template = from_pyrates

    def _shard(self, r0: int, r1: int, gather: Callable,
               group=None) -> Optional["MultiSpikeResetNet"]:
        loc = super()._shard(r0, r1, gather, group)
        if loc is not None:
            n, rows = self._vf.n, r1 - r0
            loc._segments = [(lo // n * rows, hi // n * rows) for lo, hi in self._segments]
        return loc

    def make_step(self) -> Callable:
        func, dt, inp_key = self.func, self.dt, self._inp_key
        spike_fn, thresh, v_reset = self.spike, self._thresh, self._reset_val
        skeys, segments = self._spike_keys, self._segments
        reader = self._make_out_reader()

        def step(y, args, x):
            a = dict(args)
            resets = []
            for k, (lo, hi) in zip(skeys, segments):
                spikes = spike_fn(y[..., lo:hi] - thresh)
                resets.append(spikes.detach())
                a[k] = spikes / dt
            a[inp_key] = x
            y_new = y + dt * func(0.0, y, a)
            for (lo, hi), reset in zip(segments, resets):
                seg = torch.where(reset > 0.0, v_reset, y_new[..., lo:hi])
                y_new = torch.cat((y_new[..., :lo], seg, y_new[..., hi:]), dim=-1)
            return y_new, reader(y_new, a)  # post-update output

        return step

    def _make_spike_reader(self) -> Callable:
        """The spike indicators of the reset segments of a PRE-update state,
        concatenated in declaration order (see ``SpikeNet``)."""
        return _spike_reader(self._thresh, self._center, self._segments)


def _spike_reader(thresh: float, center: float, segments) -> Callable:
    """``read(y)``: the steps' spike decision ``heaviside(y[..., lo:hi] -
    thresh, center)`` of each segment, concatenated on the last axis, in
    ``y``'s dtype and detached (no autograd function; ``center`` is made
    once per dtype and device, not per step)."""
    centers = {}

    def read(y):
        y = y.detach()
        c = centers.get((y.dtype, y.device))
        if c is None:
            c = centers[(y.dtype, y.device)] = torch.full((), center, dtype=y.dtype,
                                                          device=y.device)
        parts = [torch.heaviside(y[..., lo:hi] - thresh, c) for lo, hi in segments]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    return read


def _strip_all(name: str) -> str:
    """Strip a leading 'all/' node-scope prefix from a variable reference."""
    if name.startswith("all/"):
        return name[4:]
    return name
