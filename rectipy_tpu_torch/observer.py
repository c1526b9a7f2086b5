"""Observer: recording sink for outputs, losses, and state variables.

API-parity with the reference Observer (RectiPy's rectipy/observer.py)
-- ``record``, ``save``, ``__getitem__``, ``to_numpy``, ``to_dataframe``,
``plot``, ``matshow`` -- but designed for scan-based recording: the Network
trainers integrate whole trajectories under ``jit`` with preallocated,
mean-downsampled record buffers (matching the reference's
buffer-averaging semantics, RectiPy's rectipy/network.py:588-599) and
bulk-ingest them via :meth:`record_batch`.  Eager per-step :meth:`record`
remains available.
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple, Union

import numpy as np

__all__ = ["Observer"]


class Observer:
    def __init__(self, dt: float, record_output: bool = True, record_loss: bool = True,
                 record_vars: list = None):
        """``record_vars`` is a list of ``(node, var, reduce)`` tuples; with
        ``reduce=True`` the population mean is stored instead of the full
        vector."""
        if not record_vars:
            record_vars = []
        self._dt = dt
        self._state_vars = [tuple(v[:2]) for v in record_vars]
        self._reduce_vars = [bool(v[2]) for v in record_vars]
        self._recordings = {v: [] for v in self._state_vars}
        self._record_loss = record_loss
        self._record_out = record_output
        if record_loss:
            self._recordings["loss"] = []
        if record_output:
            self._recordings["out"] = []
        self._recordings["steps"] = []
        self._additional_storage = {}

    def __getitem__(self, item: Union[str, Tuple[str, str]]):
        try:
            return self._recordings[item]
        except KeyError:
            return self._additional_storage[item]

    @property
    def recorded_state_variables(self) -> list:
        return self._state_vars

    @property
    def recorded_variables(self) -> list:
        return list(self._recordings.keys())

    @property
    def reduce_flags(self) -> list:
        return self._reduce_vars

    @property
    def record_output(self) -> bool:
        return self._record_out

    @property
    def record_loss(self) -> bool:
        return self._record_loss

    @property
    def dt(self) -> float:
        return self._dt

    @property
    def recordings(self):
        """All recorded columns as one time-indexed DataFrame (reference:
        RectiPy's rectipy/observer.py:62-70)."""
        from pandas import DataFrame

        columns = list(self._state_vars)
        if self._record_out:
            columns.append("out")
        if self._record_loss:
            columns.append("loss")
        data = {}
        for c in columns:
            vals = [np.asarray(v) for v in self._recordings[c]]
            # 0-d arrays (reduced vars, losses) become Python scalars so the
            # DataFrame columns hold numbers, not numpy 0-d objects
            data[str(c)] = [v.item() if v.ndim == 0 else v for v in vals]
        index = np.asarray(self._recordings["steps"], dtype=float) * self._dt
        return DataFrame(index=index, data=data)

    def record(self, step: int, output, loss, record_vars: Iterable) -> None:
        """Eager single-step recording (reference signature,
        RectiPy's rectipy/observer.py:79-105)."""
        recs = self._recordings
        recs["steps"].append(int(step))
        for key, val, reduce in zip(self._state_vars, record_vars, self._reduce_vars):
            recs[key].append(np.mean(np.asarray(val)) if reduce else np.asarray(val))
        if self._record_out:
            recs["out"].append(np.asarray(output))
        if self._record_loss:
            recs["loss"].append(float(loss) if np.ndim(loss) == 0 else np.asarray(loss))

    def record_batch(self, steps, outputs=None, losses=None, var_values: dict = None) -> None:
        """Bulk ingestion of scan-produced record buffers (device arrays are
        materialized to numpy once, here -- the single host transfer)."""
        steps = np.asarray(steps)
        self._recordings["steps"].extend(int(s) for s in steps)
        if self._record_out and outputs is not None:
            self._recordings["out"].extend(np.asarray(outputs))
        if self._record_loss and losses is not None:
            self._recordings["loss"].extend(np.asarray(losses))
        if var_values:
            for key, vals in var_values.items():
                if key not in self._recordings:
                    # keys beyond the record_vars config (e.g. the
                    # (node, "spikes") raster counts) get their own series
                    self._recordings[key] = []
                self._recordings[key].extend(np.asarray(vals))

    def save(self, key: str, val: Any):
        """Store an arbitrary object retrievable via ``obs[key]``."""
        self._additional_storage[key] = val

    def to_numpy(self, item: Union[str, Tuple[str, str]]) -> np.ndarray:
        try:
            val = self._recordings[item]
        except KeyError:
            val = self._additional_storage[item]
        return np.asarray([np.asarray(v) for v in val])

    # one .npz holds recordings + saved extras; tuple keys (node, var) are
    # joined with an unprintable separator so arbitrary node names survive
    _KEY_SEP = "\x1f"

    def to_npz(self, path: str) -> str:
        """Persist all recordings and ``save()``d extras to ``path``
        (``.npz``; appended if missing).  Round-trips through
        :meth:`from_npz` — long-experiment results survive the process.
        Non-array extras (dicts, strings) are pickled inside the archive.
        """
        import json

        payload = {}
        for key, vals in self._recordings.items():
            name = (self._KEY_SEP.join(key) if isinstance(key, tuple) else key)
            arrs = [np.asarray(v) for v in vals]
            try:
                payload["rec" + self._KEY_SEP + name] = np.stack(arrs) if arrs \
                    else np.zeros((0,))
            except ValueError:  # ragged series (mixed shapes): pickle
                # np.array(list, dtype=object) raises when entries share a
                # leading dim; an empty object array filled in place is the
                # robust pickle container
                box = np.empty(len(arrs), dtype=object)
                box[:] = arrs
                payload["rec" + self._KEY_SEP + name] = box
        for key, val in self._additional_storage.items():
            if isinstance(val, np.ndarray) and val.dtype != object:
                enc = val  # plain arrays stay native
            else:
                # everything else (dicts, strings, scalars, lists, mixed
                # objects) rides in a 1-element pickled box so the ORIGINAL
                # Python type round-trips
                enc = np.empty(1, dtype=object)
                enc[0] = val
            payload["sav" + self._KEY_SEP + str(key)] = enc
        payload["__meta__"] = np.asarray(json.dumps({
            "dt": self._dt,
            "record_output": self._record_out,
            "record_loss": self._record_loss,
            "record_vars": [[n, v, bool(r)] for (n, v), r
                            in zip(self._state_vars, self._reduce_vars)],
        }))
        if not path.endswith(".npz"):
            path = path + ".npz"
        np.savez(path, **payload)
        return path

    @classmethod
    def from_npz(cls, path: str) -> "Observer":
        """Reconstruct an Observer persisted by :meth:`to_npz`."""
        import json

        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path, allow_pickle=True) as data:
            meta = json.loads(str(data["__meta__"]))
            obs = cls(dt=meta["dt"], record_output=meta["record_output"],
                      record_loss=meta["record_loss"],
                      record_vars=[(n, v, r) for n, v, r in meta["record_vars"]])
            for name in data.files:
                if name == "__meta__":
                    continue
                kind, _, key = name.partition(cls._KEY_SEP)
                val = data[name]
                if kind == "rec":
                    rkey = tuple(key.split(cls._KEY_SEP)) if cls._KEY_SEP in key else key
                    if rkey == "steps":
                        obs._recordings["steps"] = [int(s) for s in val]
                    else:
                        obs._recordings[rkey] = list(val)
                else:
                    # extras: pickled 1-element boxes hold the original
                    # Python object; plain arrays pass through
                    obs._additional_storage[key] = (val[0]
                                                    if val.dtype == object and val.shape == (1,)
                                                    else val)
        return obs

    def to_dataframe(self, item: Union[str, Tuple[str, str]]):
        from pandas import DataFrame

        try:
            data = self.to_numpy(item)
            index = np.asarray(self._recordings["steps"], dtype=float) * self._dt
            return DataFrame(index=index, data=data)
        except KeyError:
            return self[item]

    def plot(self, y, x=None, ax=None, **kwargs):
        """Line plot of recorded variable ``y`` (against time, or against
        recorded variable ``x``)."""
        import matplotlib.pyplot as plt

        if ax is None:
            subplot_kwargs = {k: kwargs.pop(k) for k in ["figsize"] if k in kwargs}
            _, ax = plt.subplots(**subplot_kwargs)
        if x is None:
            ax.plot(self.to_dataframe(y), **kwargs)
        else:
            ax.plot(self.to_numpy(x), self.to_numpy(y), **kwargs)
        ax.set_xlabel("time" if x is None else
                      f"Node: {x[0]}, variable: {x[-1]}" if isinstance(x, tuple) else x)
        ax.set_ylabel(f"Node: {y[0]}, variable: {y[-1]}" if isinstance(y, tuple) else y)
        return ax

    def raster(self, node: str, ax=None, **kwargs):
        """Spike-raster scatter of the ``(node, "spikes")`` counts recorded
        via ``run(..., record_spikes=[node])``: one dot per (record window,
        neuron) with at least one spike.  Multi-spike windows render darker
        (alpha ~ count) when ``shade=True``."""
        import matplotlib.pyplot as plt

        counts = self.to_numpy((node, "spikes"))
        steps = np.asarray(self._recordings["steps"], dtype=float) * self._dt
        if ax is None:
            subplot_kwargs = {k: kwargs.pop(k) for k in ["figsize"] if k in kwargs}
            _, ax = plt.subplots(**subplot_kwargs)
        shade = kwargs.pop("shade", False)
        kwargs.setdefault("s", 2)
        kwargs.setdefault("color", "k")
        t_idx, n_idx = np.nonzero(counts)
        if shade and counts.size:
            c = counts[t_idx, n_idx].astype(float)
            kwargs["alpha"] = None
            kwargs.setdefault("c", np.minimum(c / max(c.max(), 1.0), 1.0))
            kwargs.pop("color", None)
        ax.scatter(steps[t_idx], n_idx, **kwargs)
        ax.set_xlabel("time")
        ax.set_ylabel("neuron")
        ax.set_title(f"Node: {node} spike raster")
        return ax

    def _spike_window_widths(self) -> np.ndarray:
        """Steps covered by each recorded spike window.  Window ``k`` covers
        ``(steps[k-1], steps[k]]``; the FIRST window of each run/fit call
        covers only its own step (the scan's accumulator starts fresh, and a
        ``cutoff`` zeroes everything below it), so the first recorded step
        -- and every step-counter restart from chunked calls sharing this
        Observer -- gets width 1."""
        steps = np.asarray(self._recordings["steps"], dtype=float)
        d = np.diff(steps)
        return np.concatenate([[1.0], np.where(d > 0, d, 1.0)])

    def psth(self, node: str, per_neuron: bool = False):
        """Peri-stimulus time histogram from the ``(node, "spikes")`` window
        counts recorded via ``record_spikes=[node]``: the firing rate over
        each record window, ``counts / (window_steps * dt)`` (spikes per
        time unit; Hz when ``dt`` is in seconds).

        Returns ``(times, rates)`` -- ``times`` are the record-step times
        (each window ENDS at its record step, inclusive; the first window
        of each run covers only its own step), ``rates`` is the
        population-mean rate ``(T,)`` or per-neuron ``(T, n)`` with
        ``per_neuron=True``.  Handles ``cutoff`` runs and chunked calls
        sharing one Observer (each chunk's first window restarts).  NOTE: a
        ``cutoff`` that is not a multiple of ``sampling_steps`` leaves the
        first window partially masked -- its rate is then a lower bound.
        """
        counts = self.to_numpy((node, "spikes")).astype(float)
        steps = np.asarray(self._recordings["steps"], dtype=float)
        widths = self._spike_window_widths()
        rates = counts / (widths[:, None] * self._dt)
        times = steps * self._dt
        return times, (rates if per_neuron else rates.mean(axis=1))

    def rates(self, node: str) -> np.ndarray:
        """Per-neuron mean firing rate over the OBSERVED windows (total
        ``(node, "spikes")`` counts / total steps covered by the recorded
        windows) -- correct under ``cutoff`` and chunked calls, where the
        covered steps are fewer than the wall-clock span."""
        counts = self.to_numpy((node, "spikes")).astype(float)
        duration = self._spike_window_widths().sum() * self._dt
        return counts.sum(axis=0) / duration

    def isi_stats(self, node: str) -> dict:
        """Inter-spike-interval statistics per neuron from the
        ``(node, "spikes")`` window counts recorded via
        ``record_spikes=[node]``: dict of ``(n,)`` arrays ``mean_isi``,
        ``cv`` (std/mean of the ISIs; ~1 for Poisson firing, <1 regular,
        >1 bursty) and ``fano`` (var/mean of the per-window counts).
        NOTE ``fano`` is window-size dependent: at windows much shorter
        than the ISI the counts are ~Bernoulli and Fano -> 1 for ANY
        process; record with windows well above the ISI (large
        ``sampling_steps``) to read count regularity off it — ``cv`` is
        the window-free regularity measure.

        ISIs are resolved to the record grid: spike times are window end
        times; a window holding ``c`` spikes contributes ``c-1`` intra-window
        intervals of ``width/c`` (even spread — the least-biased assumption
        below record resolution; record with ``sampling_steps=1`` for exact
        dt-resolution ISIs).  Neurons with <2 spikes get ``nan`` ISI stats.
        """
        counts = self.to_numpy((node, "spikes"))
        steps = np.asarray(self._recordings["steps"], dtype=float)
        widths = self._spike_window_widths()
        # chunked calls sharing this Observer restart the step counter
        # (non-positive step diffs, same convention as
        # _spike_window_widths); ISIs never bridge chunks -- the wall-clock
        # gap between chunks is not represented in the recording
        restarts = np.concatenate([[0], np.nonzero(np.diff(steps) <= 0)[0] + 1,
                                   [len(steps)]])
        n = counts.shape[1]
        mean_isi = np.full(n, np.nan)
        cv = np.full(n, np.nan)
        for i in range(n):
            isis = []
            for lo, hi in zip(restarts[:-1], restarts[1:]):
                w_idx = lo + np.nonzero(counts[lo:hi, i])[0]
                if not len(w_idx):
                    continue
                c = counts[w_idx, i].astype(float)
                d = widths[w_idx]
                # even-spread model: a window ending at e with c spikes
                # holds them at e - (c-1)*d/c, ..., e
                for k, dk in zip(c.astype(int), d):
                    if k > 1:
                        isis.extend([dk * self._dt / k] * (k - 1))
                if len(w_idx) > 1:
                    first = steps[w_idx] - (c - 1.0) * d / c
                    isis.extend((first[1:] - steps[w_idx][:-1]) * self._dt)
            if isis:
                isis = np.asarray(isis)
                mean_isi[i] = isis.mean()
                cv[i] = isis.std() / isis.mean() if isis.mean() > 0 else np.nan
        m = counts.mean(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            fano = np.where(m > 0, counts.var(axis=0) / m, np.nan)
        return {"mean_isi": mean_isi, "cv": cv, "fano": fano}

    def xcorr(self, item_a, item_b, max_lag: int = None):
        """Normalized cross-correlation between two recordings on the record
        grid: ``(lags, corr)`` where ``lags`` are in time units and
        ``corr[k] = corr(a[t], b[t+lag_k])`` (Pearson, so the zero-lag
        autocorrelation is 1).  A positive-lag peak means ``a`` LEADS ``b``
        — the time-domain companion of :meth:`coherence` (e.g. reading the
        coupling delay off two delay-coupled populations).

        Multi-channel recordings are channel-averaged, like
        :meth:`coherence`; ``max_lag`` is in record steps (default T//4).
        """
        steps, _ = self._record_grid("xcorr", min_samples=3)
        gaps = np.diff(steps)
        sigs = []
        for item in (item_a, item_b):
            x = self._grid_signal(item, steps, "xcorr").mean(axis=1)
            sigs.append(x - x.mean())
        a, b = sigs
        T = len(a)
        if max_lag is None:
            max_lag = T // 4
        max_lag = int(min(max_lag, T - 1))
        denom = T * a.std() * b.std()
        if denom == 0:
            raise ValueError("xcorr: at least one signal is constant")
        full = np.correlate(b, a, mode="full") / denom  # index T-1 = zero lag
        lags = np.arange(-max_lag, max_lag + 1)
        corr = full[T - 1 + lags[0]: T + lags[-1]]
        return lags * float(gaps[0]) * self._dt, corr

    def fc(self, item="out"):
        """Functional connectivity: the ``(n, n)`` zero-lag Pearson
        correlation matrix between the channels of a recording — the
        standard whole-brain-modeling summary (compared against the
        structural connectome; see ``examples/whole_brain_delays.py``).
        Constant channels (e.g. amplitude-death regions) yield NaN
        rows/columns rather than an error.  Beyond-reference ergonomics;
        companion of :meth:`xcorr` / :meth:`coherence`."""
        x = self.to_numpy(item)
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[0] < 2 or x.shape[1] < 2:
            raise ValueError(
                f"fc needs a multi-channel recording with >= 2 samples; "
                f"{item!r} has shape {x.shape}.")
        x = x - x.mean(axis=0)
        sd = x.std(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            C = (x.T @ x) / (x.shape[0] * np.outer(sd, sd))
        return C

    def _record_grid(self, what: str, min_samples: int = 2):
        """Validated even record grid shared by the frequency/lag analysis
        helpers: returns ``(steps, fs)`` or raises."""
        steps = np.asarray(self._recordings["steps"], dtype=np.int64)
        if len(steps) < min_samples:
            word = {2: "two", 3: "three"}.get(min_samples, str(min_samples))
            raise ValueError(f"{what} needs at least {word} recorded samples")
        gaps = np.diff(steps)
        if not np.all(gaps == gaps[0]):
            raise ValueError(
                f"{what} requires an evenly spaced record grid; recorded "
                f"step gaps vary ({np.unique(gaps)[:5]} ...) -- record with "
                "one sampling_steps, or resample.")
        return steps, 1.0 / (self._dt * float(gaps[0]))

    def _grid_signal(self, item, steps, what: str) -> np.ndarray:
        """A recording as a (T, n) array aligned to the record grid."""
        x = self.to_numpy(item)
        if x.ndim == 1:
            x = x[:, None]
        if len(x) != len(steps):
            # e.g. a save()d extra with its own sampling: the record grid
            # says nothing about ITS sample rate
            raise ValueError(
                f"{what}: {item!r} has {len(x)} rows but the record grid "
                f"has {len(steps)} steps; only per-record-step recordings "
                "have a known sample rate (use scipy.signal directly with "
                "your own fs for saved extras).")
        return x

    def spectrum(self, item="out", nperseg: int = None, per_channel: bool = False,
                 **welch_kwargs):
        """Welch power spectral density of a recording: ``(freqs, psd)``.

        The sample rate is derived from the RECORD grid (``dt`` times the
        recorded step spacing, so downsampled recordings get the right
        frequency axis); raises if the grid is irregular (e.g. chunked
        runs with different ``sampling_steps`` -- resample first).
        ``psd`` is the channel-mean ``(F,)`` (or ``(F, n)`` with
        ``per_channel=True``); frequencies are in the reciprocal unit of
        ``dt`` (Hz when dt is in seconds).  ``nperseg`` defaults to
        ``min(256, T)``; extra kwargs pass through to
        ``scipy.signal.welch``.  Beyond-reference helper (the reference
        exports to numpy/pandas and leaves spectral analysis to the user).
        """
        from scipy.signal import welch

        steps, fs = self._record_grid("spectrum")
        x = self._grid_signal(item, steps, "spectrum")
        if nperseg is None:
            nperseg = min(256, x.shape[0])
        freqs, psd = welch(x, fs=fs, nperseg=nperseg, axis=0, **welch_kwargs)
        return freqs, (psd if per_channel else psd.mean(axis=1))

    def coherence(self, item_a, item_b, nperseg: int = None, **kwargs):
        """Magnitude-squared coherence between two recordings:
        ``(freqs, Cxy)`` with ``Cxy in [0, 1]`` per frequency — the
        frequency-resolved counterpart of a cross-correlation peak (e.g.
        which rhythm two delay-coupled populations actually share).

        ``item_a`` / ``item_b``: recording keys as in :meth:`to_numpy`;
        multi-channel recordings are averaged to one signal each (pass
        1-channel slices yourself for per-pair coherence).  Sample rate
        from the record grid, like :meth:`spectrum`.
        """
        from scipy.signal import coherence as _coherence

        steps, fs = self._record_grid("coherence")
        sigs = [self._grid_signal(item, steps, "coherence").mean(axis=1)
                for item in (item_a, item_b)]
        if nperseg is None:
            nperseg = min(256, len(sigs[0]))
        return _coherence(sigs[0], sigs[1], fs=fs, nperseg=nperseg, **kwargs)

    def matshow(self, v, ax=None, **kwargs):
        """Heatmap (time x feature) of recorded variable ``v``."""
        import matplotlib.pyplot as plt

        if ax is None:
            subplot_kwargs = {k: kwargs.pop(k) for k in ["figsize"] if k in kwargs}
            _, ax = plt.subplots(**subplot_kwargs)
        sig = np.asarray(self.to_dataframe(v))
        shrink = kwargs.pop("shrink", 0.6)
        im = ax.imshow(sig.T, **kwargs)
        plt.colorbar(im, ax=ax, shrink=shrink)
        ax.set_xlabel("time")
        ax.set_ylabel(f"Node: {v[0]}, variable: {v[1]}" if isinstance(v, tuple) else v)
        return ax
