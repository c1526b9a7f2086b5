"""The traffic generator: a closed loop of simulation calls, read from a mix file.

A mix (``portbench/traffic/<mix>.json``) gives, for the closed loop of one
client that calls the program back to back as a sweep script does:

- ``trials`` (B) and ``steps`` (T) of every call, ``sampling_steps`` and
  ``record_vars`` of its records;
- ``drive``: a pulse into the input of ``amplitude`` drawn from its range,
  from an onset drawn as a share of T from ``onset``, ``length`` T long;
- ``initial_v``: the range of each neuron's start potential, drawn anew
  for each call (``[lo, hi]``);
- ``sweep`` (B > 1): each trial's offset of ``var``, drawn from ``offsets``;
- ``warmup_calls``, ``check_calls`` (the calls whose records the check
  compares, sampled from the seed), ``trace_seconds`` (the profiled stretch
  at the end of a traced run's window).

Every call's numbers come from the seed and the call's index alone, so the
reference can make any call again; the shapes never change with the seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

WINDOW, WARMUP = 0, 1  # the two streams of call indices
CALL_SPAN = "portbench.call"  # the span around each call of the window


@dataclass
class Call:
    drive: torch.Tensor  # (T, 1)
    v0: torch.Tensor  # (N,)
    offsets: Optional[torch.Tensor]  # (B,), None for a single trial


def make_call(mix: dict, n: int, seed: int, index: int, device, stream: int = WINDOW) -> Call:
    """Call ``index`` of ``stream`` for ``seed``: its drive, start state and
    sweep, made on ``device``."""
    ss = np.random.SeedSequence([int(seed), 7, stream, int(index)])
    rng = np.random.default_rng(ss)
    T, B, d = mix["steps"], mix["trials"], mix["drive"]
    amp = float(rng.uniform(*d["amplitude"]))
    onset = int(rng.uniform(*d["onset"]) * T)
    drive = torch.zeros((T, 1), dtype=torch.float32, device=device)
    drive[onset:onset + int(d["length"] * T)] = amp
    g = torch.Generator(device=device)
    g.manual_seed(int(rng.integers(0, 2 ** 63 - 1)))
    lo, hi = mix["initial_v"]
    v0 = lo + (hi - lo) * torch.rand((n,), generator=g, device=device)
    offsets = None
    if B > 1:
        lo, hi = mix["sweep"]["offsets"]
        offsets = torch.as_tensor(rng.uniform(lo, hi, size=B), dtype=torch.float32).to(device)
    return Call(drive, v0, offsets)


class Reservoir:
    """A uniform sample of ``k`` of the calls offered, drawn from the seed
    (reservoir sampling): which calls it keeps depends only on the seed and
    on how many calls were offered."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(np.random.SeedSequence([int(seed), 11]))
        self.kept = []  # (index, records)
        self.seen = 0

    def offer(self, index: int, records) -> None:
        if len(self.kept) < self.k:
            self.kept.append((index, records))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = (index, records)
        self.seen += 1
