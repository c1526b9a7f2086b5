"""On-device input specs: declarative drives evaluated on the device they drive.

Counterpart of ``rectipy_tpu/inputs.py``.  An :class:`InputSpec` describes a
``(T, m)`` drive (noise, Wiener increments, Poisson spike trains, pulses,
sines, constants and their sums) instead of holding it, so a long or wide
drive is never held whole, on the host or on the device.
``Network.run`` and ``Network.run_batch`` accept a spec wherever they accept
an input array::

    from rectipy_tpu_torch.inputs import Noise, Pulse

    drive = Pulse(steps, channels=1, t_on=1000, t_off=3000, amp=3.0) \\
          + Noise(steps, channels=N, scale=0.1, seed=7)
    obs = net.run(drive, sampling_steps=100)

How a spec is evaluated: ``spec.build(dt, dtype, device)`` returns
``values(t, n)``, the drive of steps ``[t, t + n)`` as one tensor on
``device``, time first: ``(n, m)``, or ``(n, B, m)`` for a spec with
per-trial seeds.  A run reads its steps in blocks of ``CHUNK``
(:class:`Drive`), so a drive holds one block at a time, never the whole
``(T, m)``.

Random streams: a stochastic part draws in chunks of ``CHUNK`` global steps
(step ``t`` of a spec is global step ``t + t0``), each chunk with a
``torch.Generator`` on the network's device seeded from (seed, the class's
salt, the part's position in a :class:`Sum`, the chunk's index).  So the
stream is a fixed function of the seed and the global step:
``spec.shifted(k)`` continues a drive exactly where a run of ``k`` steps
left it, two parts with the same seed draw independent streams, and a
``(B,)`` array of seeds gives every trial its own stream (trial ``b``'s is
the stream of the scalar seed ``seed[b]``).  The
bits are not ``jax.random``'s, and the CPU's and CUDA's generators give
different bits for the same seed: a spec's noise agrees with the JAX
package's, and between devices, in its statistics only.  On one device,
``spec.materialize(dt, device=d)`` is, bit for bit, the drive a run on ``d``
consumes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .nodes import resolve_device, resolve_dtype

__all__ = ["CHUNK", "Drive", "InputSpec", "Noise", "Wiener", "Poisson", "Pulse", "Sine",
           "Constant", "Sum"]

CHUNK = 256  # steps of a drive's block, and global steps of a random chunk

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _stream_seed(seed: int, class_salt: int, salt: int, chunk: int) -> int:
    """The generator seed of one chunk of one stream: (seed, class salt,
    position in a Sum, chunk index) mixed by splitmix64.  The class salt
    keeps ``Noise(seed=0) + Poisson(seed=0)`` apart, the position two parts
    of one class with one seed."""
    h = 0
    for word in (seed, class_salt, salt, chunk):
        h = _splitmix64(h ^ (int(word) & _MASK64))
    return h >> 1  # a non-negative 63-bit seed


def _seeds(seed) -> Tuple[list, bool]:
    """``(seeds, per_trial)`` of a scalar or ``(B,)`` seed."""
    seeds = np.asarray(seed)
    if seeds.ndim > 1:
        raise ValueError(f"seed must be a scalar or (B,) array, got shape {seeds.shape}")
    return [int(s) for s in seeds.reshape(-1)], seeds.ndim == 1


def _param(value, dtype, device) -> torch.Tensor:
    """A spec parameter (scalar or ``(channels,)``) as a tensor."""
    return torch.as_tensor(np.asarray(value)).to(device=device, dtype=dtype)


def _global_steps(t: int, n: int, t0: int, device) -> torch.Tensor:
    """The global steps of steps ``[t, t + n)``, ``(n, 1)`` int64."""
    return torch.arange(t + t0, t + t0 + n, device=device).unsqueeze(1)


def _draw(kind: str, seeds: list, per_trial: bool, class_salt: int, salt: int, m: int, t0: int,
          dtype, device) -> Callable:
    """``draw(t, n)``: standard normal (``kind='normal'``) or ``U[0, 1)``
    (``'uniform'``) draws of steps ``[t, t + n)``, ``(n, m)`` or ``(n, B,
    m)``, cut from the chunks of ``CHUNK`` global steps that hold them (the
    last two chunks drawn are kept: consecutive blocks share one)."""
    gen = torch.Generator(device=device)
    sample = torch.randn if kind == "normal" else torch.rand
    kept: dict = {}

    def chunk(c):
        if c not in kept:
            rows = []
            for s in seeds:
                gen.manual_seed(_stream_seed(s, class_salt, salt, c))
                rows.append(sample((CHUNK, m), generator=gen, dtype=dtype, device=device))
            if len(kept) == 2:
                del kept[min(kept)]
            kept[c] = torch.stack(rows, dim=1) if per_trial else rows[0]
        return kept[c]

    def draw(t, n):
        g0, g1 = t + t0, t + t0 + n
        parts = [chunk(c)[max(g0 - c * CHUNK, 0):min(g1 - c * CHUNK, CHUNK)]
                 for c in range(g0 // CHUNK, (g1 - 1) // CHUNK + 1)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    return draw


class Drive:
    """The per-step drive of a spec on one device: ``drive[t]`` is the
    ``(m,)`` (or ``(B, m)``) input of step ``t``, a row of the block of
    ``CHUNK`` steps that holds it; blocks are made on demand, one at a time,
    as the run reaches them.  ``rows=B`` repeats an unbatched drive over
    ``B`` trials (a view)."""

    def __init__(self, values: Callable, steps: int, rows: Optional[int] = None):
        self._values, self.steps, self.rows = values, int(steps), rows
        self._k, self._block = None, None

    def __len__(self) -> int:
        return self.steps

    def block(self, k: int) -> torch.Tensor:
        """Steps ``[k * CHUNK, (k + 1) * CHUNK)`` (fewer at the end)."""
        return self._values(k * CHUNK, min(CHUNK, self.steps - k * CHUNK))

    def __getitem__(self, t: int) -> torch.Tensor:
        k, o = divmod(int(t), CHUNK)
        if k != self._k:
            self._k, self._block = k, self.block(k)
        x = self._block[o]
        return x if self.rows is None else x.expand((self.rows,) + tuple(x.shape))


@dataclass(frozen=True)
class InputSpec:
    """Base class: a drive of ``channels`` channels over ``steps`` steps.

    ``t0`` offsets global time: the drive of step ``t`` is the one of global
    step ``t + t0`` (:meth:`shifted`; a :class:`Sum` shifts its parts).
    Subclasses implement :meth:`build`.
    """

    steps: int
    channels: int = 1
    t0: int = field(default=0, kw_only=True)

    @property
    def batch(self) -> Optional[int]:
        """Leading trial dimension (None for unbatched specs)."""
        return None

    def shifted(self, offset: int) -> "InputSpec":
        """Copy of this spec evaluating at ``step + t0 + offset`` (global
        time for the next chunk of a chunked run)."""
        if isinstance(self, Sum):
            return replace(self, specs=tuple(s.shifted(offset) for s in self.specs))
        return replace(self, t0=self.t0 + int(offset))

    def build(self, dt: float, dtype, device, salt: int = 0) -> Callable:
        """``values(t, n)``: the drive of steps ``[t, t + n)`` on ``device``
        in ``dtype``, ``(n, channels)`` or ``(n, B, channels)``.  ``salt``:
        the position in a :class:`Sum`, which separates the random streams
        of its parts."""
        raise NotImplementedError

    def drive(self, dt: float, dtype=torch.float32, device=None,
              rows: Optional[int] = None) -> Drive:
        """The per-step :class:`Drive` a run on ``device`` consumes
        (``None``: the card, as for :class:`Network`)."""
        return Drive(self.build(dt, resolve_dtype(dtype), resolve_device(device)), self.steps,
                     rows=rows)

    def __array__(self, dtype=None, copy=None):
        # a spec reaching np.asarray was passed where only dense arrays are
        # understood (the trainers): fail with guidance
        raise TypeError(
            f"{type(self).__name__} is an on-device input spec; run()/run_batch() "
            "evaluate it on the device. For other APIs (trainers), pass "
            "spec.materialize(dt) instead.")

    def __add__(self, other: "InputSpec") -> "Sum":
        parts = (self.specs if isinstance(self, Sum) else (self,)) + \
                (other.specs if isinstance(other, Sum) else (other,))
        return Sum(specs=parts)

    def materialize(self, dt: float, dtype=torch.float32, device=None) -> torch.Tensor:
        """The whole drive as one tensor on ``device`` (``None``: the card,
        as for :class:`Network`; pass ``device="cpu"`` for the CPU):
        ``(steps, channels)``, or ``(B, steps, channels)`` when batched.  Bit
        for bit what a run on ``device`` consumes: the same blocks,
        concatenated."""
        device = resolve_device(device)
        drive = self.drive(dt, dtype, device)
        blocks = [drive.block(k) for k in range(-(-self.steps // CHUNK))]
        if not blocks:
            shape = (0, self.channels) if self.batch is None else (0, self.batch, self.channels)
            return torch.zeros(shape, dtype=resolve_dtype(dtype), device=device)
        dense = torch.cat(blocks)
        return dense if self.batch is None else dense.transpose(0, 1).contiguous()


@dataclass(frozen=True)
class Noise(InputSpec):
    """I.i.d. noise drawn on the device each step: ``mean + scale * z_t``
    with ``z_t ~ N(0, 1)`` (``dist='normal'``) or ``U[-1, 1)``
    (``'uniform'``).  ``scale`` / ``mean``: scalars or ``(channels,)``.
    ``seed``: an int, or a ``(B,)`` int array for per-trial streams in
    ``run_batch``."""

    scale: object = 1.0
    mean: object = 0.0
    seed: object = 0
    dist: str = "normal"

    @property
    def batch(self) -> Optional[int]:
        seeds = np.asarray(self.seed)
        return None if seeds.ndim == 0 else int(seeds.shape[0])

    def build(self, dt, dtype, device, salt: int = 0):
        if self.dist not in ("normal", "uniform"):
            raise ValueError(f"Noise dist must be 'normal' or 'uniform', got {self.dist!r}")
        seeds, per_trial = _seeds(self.seed)
        draw = _draw(self.dist, seeds, per_trial, 1, salt, self.channels, self.t0, dtype, device)
        scale, mean = _param(self.scale, dtype, device), _param(self.mean, dtype, device)
        uniform = self.dist == "uniform"

        def values(t, n):
            z = draw(t, n)
            if uniform:
                z = z * 2.0 - 1.0
            return mean + scale * z

        return values


@dataclass(frozen=True)
class Wiener(InputSpec):
    """White-noise SDE drive with Euler-Maruyama scaling: ``drift +
    sigma/sqrt(dt) * z_t`` with ``z_t ~ N(0, 1)``, so the integrator's
    ``dt`` turns each step into the Wiener increment ``sigma * sqrt(dt) *
    z_t`` (``Var[integral] = sigma^2 T`` at any dt; an OU process ``v' =
    -v/tau + Wiener(sigma)`` reaches the stationary variance ``sigma^2 tau /
    2``).  ``sigma`` / ``drift``: scalars or ``(channels,)``; ``seed`` as
    for :class:`Noise`."""

    sigma: object = 1.0
    drift: object = 0.0
    seed: object = 0

    @property
    def batch(self) -> Optional[int]:
        seeds = np.asarray(self.seed)
        return None if seeds.ndim == 0 else int(seeds.shape[0])

    def build(self, dt, dtype, device, salt: int = 0):
        seeds, per_trial = _seeds(self.seed)
        draw = _draw("normal", seeds, per_trial, 3, salt, self.channels, self.t0, dtype, device)
        scale = _param(np.asarray(self.sigma, dtype=np.float64) / np.sqrt(float(dt)), dtype,
                       device)
        drift = _param(self.drift, dtype, device)

        def values(t, n):
            return drift + scale * draw(t, n)

        return values


@dataclass(frozen=True)
class Poisson(InputSpec):
    """Poisson spike-train drive: each channel emits ``amp/dt`` with
    probability ``rate * dt`` a step.  ``rate`` / ``amp``: scalars or
    ``(channels,)``; ``seed`` as for :class:`Noise`."""

    rate: object = 10.0
    amp: object = 1.0
    seed: object = 0

    @property
    def batch(self) -> Optional[int]:
        seeds = np.asarray(self.seed)
        return None if seeds.ndim == 0 else int(seeds.shape[0])

    def build(self, dt, dtype, device, salt: int = 0):
        seeds, per_trial = _seeds(self.seed)
        draw = _draw("uniform", seeds, per_trial, 2, salt, self.channels, self.t0, dtype, device)
        p = _param(np.asarray(self.rate) * float(dt), dtype, device)
        amp = _param(self.amp, dtype, device)
        inv_dt = _param(1.0 / float(dt), dtype, device)

        def values(t, n):
            return amp * inv_dt * (draw(t, n) < p).to(dtype)

        return values


@dataclass(frozen=True)
class Pulse(InputSpec):
    """Rectangular pulse: ``amp`` on ``t_on <= step < t_off``, else 0
    (``t_off=-1``: to the end of the spec).  ``amp``: scalar or
    ``(channels,)``."""

    t_on: int = 0
    t_off: int = -1
    amp: object = 1.0

    def build(self, dt, dtype, device, salt: int = 0):
        if self.t_off < -1 or self.t_on < 0:
            # only the documented -1 means "until the end"; any other
            # negative is an arithmetic slip
            raise ValueError(f"Pulse bounds must be >= 0 (t_off=-1 = end of run); "
                             f"got t_on={self.t_on}, t_off={self.t_off}")
        t_on, t0 = int(self.t_on), self.t0
        t_off = self.steps + t0 if self.t_off == -1 else int(self.t_off)
        amp, m = _param(self.amp, dtype, device), self.channels
        zero = torch.zeros((), dtype=dtype, device=device)

        def values(t, n):
            g = _global_steps(t, n, t0, device)
            on = (g >= t_on) & (g < t_off)
            return torch.where(on, amp, zero).expand(n, m).contiguous()

        return values


@dataclass(frozen=True)
class Sine(InputSpec):
    """``offset + amp * sin(2 pi freq t dt + phase)``, ``freq`` in the
    reciprocal unit of ``dt``.  Each parameter: scalar or ``(channels,)``."""

    freq: object = 1.0
    amp: object = 1.0
    phase: object = 0.0
    offset: object = 0.0

    def build(self, dt, dtype, device, salt: int = 0):
        freq, amp, phase, offset = (_param(v, dtype, device)
                                    for v in (self.freq, self.amp, self.phase, self.offset))
        dt_t, m, t0 = _param(float(dt), dtype, device), self.channels, self.t0

        def values(t, n):
            time = _global_steps(t, n, t0, device).to(dtype) * dt_t
            val = offset + amp * torch.sin(2.0 * math.pi * freq * time + phase)
            return val.expand(n, m).contiguous()

        return values


@dataclass(frozen=True)
class Constant(InputSpec):
    """Constant drive ``value`` (scalar or ``(channels,)``)."""

    value: object = 0.0

    def build(self, dt, dtype, device, salt: int = 0):
        value, m = _param(self.value, dtype, device), self.channels

        def values(t, n):
            return value.expand(n, m).contiguous()

        return values


@dataclass(frozen=True)
class Sum(InputSpec):
    """Elementwise sum of specs (built by ``spec_a + spec_b``).  All parts
    share ``steps``; single-channel parts broadcast to the widest."""

    specs: Tuple[InputSpec, ...] = field(default=())
    steps: int = 0
    channels: int = 0

    def __post_init__(self):
        if not self.specs:
            raise ValueError("Sum needs at least one spec")
        steps = {s.steps for s in self.specs}
        if len(steps) != 1:
            raise ValueError(f"summed specs disagree on steps: {sorted(steps)}")
        chans = {s.channels for s in self.specs if s.channels != 1}
        if len(chans) > 1:
            raise ValueError(f"summed specs disagree on channels: {sorted(chans)}")
        object.__setattr__(self, "steps", steps.pop())
        object.__setattr__(self, "channels", chans.pop() if chans else 1)
        batches = {s.batch for s in self.specs if s.batch is not None}
        if len(batches) > 1:
            raise ValueError(f"summed specs disagree on batch size: {sorted(batches)}")

    @property
    def batch(self) -> Optional[int]:
        for s in self.specs:
            if s.batch is not None:
                return s.batch
        return None

    def build(self, dt, dtype, device, salt: int = 0):
        # each part its own stream salt: two same-seed stochastic parts draw
        # independent streams
        parts = [(s.build(dt, dtype, device, salt=salt * 64 + i), s.batch is not None)
                 for i, s in enumerate(self.specs)]
        B, m = self.batch, self.channels

        def values(t, n):
            out = torch.zeros((n, m) if B is None else (n, B, m), dtype=dtype, device=device)
            for part, batched in parts:
                val = part(t, n)
                out = out + (val if B is None or batched else val.unsqueeze(1))
            return out

        return values
