"""The qif_sfa family: a QIF+SFA spiking population with a recurrent coupling.

Two halves, kept apart because the correctness check hands the first to
both sides:

- ``make_inputs``: the benchmark's raw inputs, made from the seed on the
  device (the coupling's float32 weights, the Lorentzian etas, the input
  weights).  The plain reference (``portbench/reference/qif_sfa.py``)
  takes these and nothing else.
- ``Program``: the system under test, rectipy_tpu_torch's ``Network``
  built from those inputs, and one call of the closed loop through
  ``Network.run`` or ``Network.run_batch``.

A configuration file of this family states every number the network is
built with (``portbench/configs/*.json``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

QIF_SFA = "rectipy_tpu_torch.models.spiking_neurons.qif.qif_sfa"
COMPARED = ("qif", "v")  # the records the check compares (portbench/check.py)

# block rows of a block-sparse coupling made at once (256 MB of float32 at
# bs 512 and 4 source blocks): a million-neuron coupling is 8.2 GB
BLOCK_CHUNK_ROWS = 64


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A torch generator on ``device`` for stream ``tag`` of ``seed``."""
    state = np.random.SeedSequence([int(seed), int(tag)]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def lorentzian_etas(cfg: dict, device) -> torch.Tensor:
    """``eta_center + eta_width * tan(pi/2 * (2i - N - 1) / (N + 1))``,
    i = 1..N: the deterministic Lorentzian quantiles of ``bench.py`` and
    RectiPy's qif_example, float32."""
    n = cfg["n"]
    i = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    q = torch.tan((math.pi / 2) * (2.0 * i - n - 1) / (n + 1))
    return (cfg["eta_center"] + cfg["eta_width"] * q).to(torch.float32)


def dense_weights(cfg: dict, g: torch.Generator, device) -> torch.Tensor:
    """``(N, N)`` float32: each row ``fan_in`` distinct random sources of
    weight ``1 / fan_in``."""
    n, fan = cfg["n"], cfg["fan_in"]
    keys = torch.rand((n, n), generator=g, device=device)
    idx = keys.topk(fan, dim=1).indices
    del keys
    w = torch.zeros((n, n), dtype=torch.float32, device=device)
    return w.scatter_(1, idx, 1.0 / fan)


def block_cols(cfg: dict, g: torch.Generator, device) -> torch.Tensor:
    """``(n_br, cb)`` int32: each block row's ``source_blocks`` distinct
    source blocks."""
    nb = cfg["n"] // cfg["block_size"]
    keys = torch.rand((nb, nb), generator=g, device=device)
    return keys.topk(cfg["source_blocks"], dim=1).indices.to(torch.int32)


def block_chunks(cfg: dict, g: torch.Generator, device):
    """The ``(n_br, cb, bs, bs)`` float32 blocks, ``BLOCK_CHUNK_ROWS`` block
    rows at a time, as ``(lo, hi, chunk)``: each neuron's ``fan_in``
    distinct sources among its block row's ``cb * bs`` candidates, weight
    ``1 / fan_in``.  The same seed gives the same chunks in the same order."""
    bs, cb, fan = cfg["block_size"], cfg["source_blocks"], cfg["fan_in"]
    nb = cfg["n"] // bs
    for lo in range(0, nb, BLOCK_CHUNK_ROWS):
        hi = min(nb, lo + BLOCK_CHUNK_ROWS)
        keys = torch.rand((hi - lo, bs, cb * bs), generator=g, device=device)
        idx = keys.topk(fan, dim=-1).indices
        del keys
        rows = torch.zeros((hi - lo, bs, cb * bs), dtype=torch.float32, device=device)
        rows.scatter_(-1, idx, 1.0 / fan)
        del idx
        yield lo, hi, rows.reshape(hi - lo, bs, cb, bs).permute(0, 2, 1, 3).contiguous()


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """The raw inputs of a run: ``etas (N,)``, ``w_in (N, 1)`` (a network
    with an input node), and the coupling: ``weights (N, N)`` for a dense
    one; ``cols`` and ``blocks``, a callable that yields the block chunks
    anew (:func:`block_chunks`), for a block-sparse one.  All float32 on
    ``device``, from ``seed``."""
    out = {"etas": lorentzian_etas(cfg, device)}
    g = generator(seed, 1, device)
    if cfg["input"] == "tanh_node":
        out["w_in"] = torch.randn((cfg["n"], 1), generator=g, device=device)
    if cfg["coupling"] == "dense":
        out["weights"] = dense_weights(cfg, g, device)
    else:
        out["cols"] = block_cols(cfg, g, device)
        state = g.get_state()

        def blocks():
            gb = torch.Generator(device=device)
            gb.set_state(state)
            return block_chunks(cfg, gb, device)

        out["blocks"] = blocks
    return out


def host_blocks(cfg: dict, inputs: dict):
    """The block-sparse coupling as rectipy_tpu_torch takes it: a
    ``BlockSparseCoupling`` over a host float32 array, filled chunk by chunk
    from the device."""
    from rectipy_tpu_torch.ops.sparse import BlockSparseCoupling

    bs, cb = cfg["block_size"], cfg["source_blocks"]
    blocks = np.empty((cfg["n"] // bs, cb, bs, bs), dtype=np.float32)
    for lo, hi, chunk in inputs["blocks"]():
        blocks[lo:hi] = chunk.cpu().numpy()
    return BlockSparseCoupling(blocks, inputs["cols"].cpu().numpy())


class Program:
    """rectipy_tpu_torch's network for a qif_sfa configuration, and the
    closed loop's call into it.  Every neuron and parameter comes from the
    configuration and the raw inputs."""

    def __init__(self, cfg: dict, mix: dict, inputs: dict, device):
        from rectipy_tpu_torch import Network
        from rectipy_tpu_torch.ops.kernels import attach_fused_qif_step

        self.mix = mix
        weights = inputs["weights"] if cfg["coupling"] == "dense" else host_blocks(cfg, inputs)
        net = Network(cfg["dt"], device=device)
        net.add_diffeq_node(
            "qif", QIF_SFA, weights=weights, source_var="s", target_var="s_in",
            input_var="I_ext", output_var="s", spike_var="spike", spike_def="v",
            op="qif_sfa_op", spike_threshold=cfg["spike_threshold"],
            spike_reset=cfg["spike_reset"],
            node_vars={f"all/qif_sfa_op/{k}": cfg[k] for k in ("tau", "tau_s", "tau_x", "k",
                                                                "alpha")}
            | {"all/qif_sfa_op/eta": inputs["etas"]},
            coupling_dtype=cfg["coupling_dtype"])
        del weights
        if cfg["input"] == "tanh_node":
            net.add_func_node("inp", 1, activation_function="tanh")
            net.add_edge("inp", "qif", weights=inputs["w_in"])
        net.compile()
        if cfg["fused_step"]:
            attach_fused_qif_step(net.get_node("qif"))
        self.net = net
        self.etas = inputs["etas"]
        self.rec_kw = dict(sampling_steps=mix["sampling_steps"], record_output=False,
                           record_vars=[tuple(r) for r in mix["record_vars"]])

    def call(self, call) -> dict:
        """One call of the loop: reset, the call's start state, the run (or
        the sweep of ``call.offsets`` added to the etas), and the records on
        the host, ``{(node, var): (B, R, ...)}``."""
        net = self.net
        with record_function("portbench.reset"):
            net.reset()
            net.set_var("qif", "v", call.v0)
        if call.offsets is None:
            with record_function("portbench.run"):
                obs = net.run(call.drive, verbose=False, **self.rec_kw)
            with record_function("portbench.records_to_host"):
                return {(n, v): obs.to_numpy((n, v))[None] for n, v, _ in self.rec_kw["record_vars"]}
        with record_function("portbench.run_batch"):
            sweep = {tuple(self.mix["sweep"]["var"]): self.etas[None, :] + call.offsets[:, None]}
            res = net.run_batch(call.drive, batch_vars=sweep, **self.rec_kw)
        with record_function("portbench.records_to_host"):
            return {(n, v): np.asarray(res[(n, v)]) for n, v, _ in self.rec_kw["record_vars"]}

    @staticmethod
    def counters() -> dict:
        """The hand-written kernels' launch counters."""
        from rectipy_tpu_torch.ops.kernels import qif_sfa_step
        from rectipy_tpu_torch.ops.quant import block_int8_mv

        return {"qif_sfa_step.launches": qif_sfa_step.launches,
                "qif_sfa_step.mma_launches": qif_sfa_step.mma_launches,
                "block_int8_mv.launches": block_int8_mv.launches,
                "block_int8_mv.mma_launches": block_int8_mv.mma_launches}
