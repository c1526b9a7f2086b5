"""One gloo rank of ``tests/test_torch_parallel*.py``.

    python tests/_torch_parallel_worker.py GROUP RANK WORLD STORE OUT

Joins the process group through the FileStore ``STORE``, runs every case of
``GROUP`` on the port (each the run or fit without a mesh and on its mesh;
every rank builds the same networks from the same seeds) and writes the
records as ``OUT/<case>.r<RANK>.npz``.  Imports the port only, never JAX.
The groups: ``parallel`` and ``runs`` (``run``/``run_batch``), ``train``
(the BPTT trainers), ``fits`` (the online rules, ``fit_es``, an STP edge's
run), ``quant`` (the quantized couplings and the edges into a shard, at
model 4 and at data 2 x model 2) and ``two_process`` (two ranks).
"""

import os
import sys
import warnings
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_parallel_cases as C  # noqa: E402
import _torch_parallel_train_cases as TC  # noqa: E402

from rectipy_tpu_torch.parallel import (make_mesh, shard_network_arrays,  # noqa: E402
                                        sharded_run, sharded_step_collectives,
                                        sharded_train_step)
from rectipy_tpu_torch.train import get_loss_function, get_optimizer  # noqa: E402

P = C.torch_ns()


def mesh(n, data=1):
    return make_mesh(n, data=data, device_type="cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Case:
    def __init__(self, rank, out):
        self.rank, self.out = rank, out

    def save(self, name, **arrays):
        np.savez(os.path.join(self.out, f"{name}.r{self.rank}.npz"),
                 **{k: _np(v) for k, v in arrays.items()})

    def pair(self, name, fn, n, data=1):
        """``fn`` without a mesh and on ``make_mesh(n, data)``."""
        m = mesh(n, data)
        ref = fn(P, None)
        if m.get_coordinate() is None:
            return
        got = fn(P, m)
        self.save(name, **{f"ref_{k}": v for k, v in ref.items()},
                  **{f"mesh_{k}": v for k, v in got.items()}, coord=m.get_coordinate())


def parallel(c: Case):
    # test_make_mesh
    m = mesh(4, data=2)
    raised = []
    for args in ((4, 3), (8, 1)):
        try:
            mesh(*args)
            raised.append(False)
        except ValueError:
            raised.append(True)
    c.save("make_mesh", shape=[m.size(0), m.size(1)], names=list(m.mesh_dim_names),
           raised=raised)

    # test_sharded_run_matches_single_device
    W, tau, inp = C.rnn_case()
    ref = C.build_rnn(P, W, tau).run(inp, verbose=False).to_numpy("out")
    net = C.build_rnn(P, W, tau)
    m = mesh(4)
    state = shard_network_arrays(net.init_state(), 32, m)
    params = shard_network_arrays(net.parameters_pytree(), 32, m)
    _, outs = sharded_run(net, m)(state, params, inp)
    c.save("sharded_run", ref=ref, outs=outs, wshape=params["nodes"]["rnn"]["weights"].shape,
           tau=params["nodes"]["rnn"]["li_op/tau"], y=state["nodes"]["rnn"])

    # test_sharded_train_step_runs_and_reduces (adam, 2 x 2) and
    # test_sharded_train_step_gradient_reduction_spans_data_axis (sgd)
    for name, seed, opt_name, B, T, inseed in (("train_adam", 1, "adam", 4, 6, None),
                                               ("train_sgd", 5, "sgd", 8, 5, 6)):
        rng = np.random.default_rng(seed)
        n = 16
        net = C.build_rnn(P, rng.normal(size=(n, n)) * 0.1, train_params=["weights"])
        m = mesh(4, data=2)
        train, frozen = net._partition(net.parameters_pytree(), net.trainable_paths())
        train = shard_network_arrays(train, n, m)
        frozen = shard_network_arrays(frozen, n, m)
        state0 = shard_network_arrays(net.init_state(), n, m)
        opt = get_optimizer(opt_name, 1e-2)
        opt_state = opt.init(train)
        step = sharded_train_step(net, get_loss_function("mse"), opt, m)
        src = rng if inseed is None else np.random.default_rng(inseed)
        inputs, targets = src.normal(size=(B, T, n)), np.zeros((B, T, n))
        t1, opt_state, l1 = step(train, frozen, opt_state, state0, inputs, targets)
        t2, opt_state, l2 = step(t1, frozen, opt_state, state0, inputs, targets)
        c.save(name, l1=l1, l2=l2, w0=train["nodes"]["rnn"]["weights"],
               w1=t1["nodes"]["rnn"]["weights"], w2=t2["nodes"]["rnn"]["weights"],
               coord=m.get_coordinate())

    # the same step on a network of a whole and a sharded population
    net, inputs, targets = C.build_mixed(P)
    m = mesh(4, data=2)
    train, frozen = net._partition(net.parameters_pytree(), net.trainable_paths())
    train, frozen = net._mesh_place(train, m), net._mesh_place(frozen, m)
    opt = get_optimizer("sgd", 0.5)
    opt_state = opt.init(train)
    step = sharded_train_step(net, get_loss_function("mse"), opt, m)
    state0 = net._mesh_place(net.init_state(), m)
    t1, opt_state, l1 = step(train, frozen, opt_state, state0, inputs, targets)
    t2, _, l2 = step(t1, frozen, opt_state, state0, inputs, targets)
    c.save("train_mixed", l1=l1, l2=l2, a=t2["nodes"]["a"]["weights"],
           b=t2["nodes"]["b"]["weights"], tau=t2["nodes"]["b"]["li_op/tau"],
           coord=m.get_coordinate())

    # test_shard_network_arrays_replicates_indivisible
    placed = shard_network_arrays({"w": torch.zeros((10, 10))}, 10, mesh(4))
    c.save("indivisible", shape=placed["w"].shape)

    # test_sharded_run_with_delay_edge
    net, inp = C.build_delay(P)
    ref = net.run(inp, verbose=False).to_numpy("out")
    net, _ = C.build_delay(P)
    m = mesh(4)
    state = net._mesh_place(net.init_state(), m)
    params = net._mesh_place(net.parameters_pytree(), m)
    rule = shard_network_arrays(net.init_state(), 32, m)["edges"]["inp->rnn"]
    _, outs = sharded_run(net, m)(state, params, inp)
    c.save("delay_edge", ref=ref, outs=outs, rule=rule.shape,
           ring=state["edges"]["inp->rnn"].shape,
           weights=params["edges"]["inp->rnn"]["weights"].shape)

    # test_sharded_compilation_inserts_collectives
    stats = sharded_step_collectives(C.build_rnn(P, C.rnn_case(seed=4)[0]), mesh(4))
    c.save("collectives", counts=[stats[op]["count"] for op in sorted(stats)])

    # test_sharded_run_int8_coupling_matches_single_device
    net, inp = C.int8_case(P)
    ref = net.run(inp, verbose=False).to_numpy("out")
    net, _ = C.int8_case(P)
    m = mesh(4)
    state = shard_network_arrays(net.init_state(), 32, m)
    params = shard_network_arrays(net.parameters_pytree(), 32, m)
    node = params["nodes"]["rnn"]
    _, outs = sharded_run(net, m)(state, params, inp)
    c.save("int8", ref=ref, outs=outs, wdtype=str(node["weights"].dtype),
           wshape=node["weights"].shape, sshape=node["weights__scale"].shape)

    # the public run(mesh=) / run_batch(mesh=) cases
    c.pair("observer", C.observer_run, 4)
    c.pair("block_sparse", C.block_sparse_run, 4)
    c.pair("run_batch", C.run_batch_qif, 4, data=2)
    c.pair("int8_master", C.int8_master_run, 4)
    c.pair("delay_matrix", C.delay_matrix_run, 4)

    # test_sharded_scan_collective_budget
    budget = {}
    for k in (2, 4):
        m = mesh(k)
        for kind in ("dense", "block"):
            if m.get_coordinate() is not None:
                stats = sharded_step_collectives(C.budget_net(P, kind), m)
                budget[f"{kind}_{k}"] = [stats["all-gather"]["count"],
                                         stats["all-gather"]["bytes"],
                                         sum(stats[op]["count"] for op in stats
                                             if op != "all-gather")]
    c.save("budget", **budget)


def runs(c: Case):
    c.pair("spec_run", C.spec_run, 4)
    c.pair("spec_run_batch", C.spec_run_batch, 4, data=2)
    c.pair("spikes", C.spikes_run, 4)
    c.pair("sweep", C.sweep_run, 4, data=2)
    c.pair("fused_qif", C.fused_qif_run, 4, data=2)
    c.pair("reduction", C.reduction_run, 4, data=2)
    c.pair("generic_fused", C.generic_fused_run, 4, data=2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c.pair("readout", C.readout_run, 4, data=2)
    c.save("readout_warnings", count=sum("REPLICATED" in str(w.message) for w in caught))
    # the collectives of the reduction template's step: the coupling's
    # source and the two population means
    stats = sharded_step_collectives(_iku(P.net(1e-2)), mesh(4, data=2))
    c.save("reduction_collectives", counts=[stats["all-gather"]["count"],
                                            stats["all-reduce"]["count"]])


def train(c: Case):
    c.pair("chain_f32", TC.chain_f32, 4)
    c.pair("graph", TC.graph_feedback, 4)
    with TC.fused_adam_env("off"):
        c.pair("int8_master", TC.int8_master, 4)
    with TC.fused_adam_env("on"):  # a mesh fit takes the split optimizer all the same
        on = TC.int8_master(P, mesh(4))
    c.save("int8_master_on", **on)
    c.pair("block_delay", TC.block_delay, 4)
    c.pair("chain_readout", TC.chain_readout, 4)
    c.pair("chain_readout_autograd", TC.chain_readout_autograd, 4)
    c.pair("step_mode", TC.step_mode, 4, data=2)
    c.pair("remat", TC.remat, 4)
    c.pair("batch_d1", TC.batch, 4, data=1)
    c.pair("batch_d2", TC.batch, 4, data=2)
    c.pair("batch_int8_master", TC.batch_int8_master, 4, data=2)
    c.pair("block_coupling", TC.block_coupling, 4)
    c.pair("multistart", TC.multistart, 4, data=2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c.pair("multistart_indivisible", TC.multistart_indivisible, 4, data=2)
    c.save("multistart_warnings", count=sum("REPLICATED" in str(w.message) for w in caught))
    # test_sharded_training_step_collective_budget: one value-and-gradient
    # of the chain trajectory's loss at T and 2T steps, model 2 and 4
    budget = {}
    for k in (2, 4):
        m = mesh(k)
        for T in (8, 16):
            if m.get_coordinate() is not None:
                budget[f"m{k}_T{T}"] = _train_budget(m, T)
    c.save("train_budget", **budget)


def _train_budget(m, T, n=64, kind=None):
    """``[all-gathers, all-reduces, others]`` of one value-and-gradient of
    the chain trajectory's loss (``kind``: an ``int4_master`` coupling, or
    a ``block_int8_master`` one of 4-blocks and fan-in 8)."""
    from rectipy_tpu_torch.ops.bptt import make_coupled_traj
    from rectipy_tpu_torch.parallel import comm
    from rectipy_tpu_torch.parallel.sharding import NetworkShard

    rng = np.random.default_rng(12)
    if kind is None:
        net = C.build_rnn(P, rng.normal(size=(n, n)) * 0.2, train_params=["weights"])
    elif kind == "int4_master":
        net = C.build_rnn(P, rng.normal(size=(n, n)) * 0.2, train_params=["weights"],
                          coupling_dtype=kind)
    else:
        net = C.build_rnn(P, P.block_random_connectivity(n, n, 8, block_size=4, seed=3),
                          train_params=["weights"], coupling_dtype="int8_master")
    shard = NetworkShard(net, m)
    traj, wkeys = make_coupled_traj(shard.node("rnn"), comm=shard.traj_comm())
    nargs = shard.place(net.parameters_pytree())["nodes"]["rnn"]
    W = {k: nargs[k].detach().requires_grad_(True) for k in wkeys}
    rest = {k: v for k, v in nargs.items() if k not in wkeys}
    y0 = shard.place(net.init_state())["nodes"]["rnn"]
    xs = shard.cols(torch.zeros((T, n), dtype=torch.float64))
    comm.reset()
    with torch.enable_grad():
        _, outs = traj(W, rest, y0, xs)
        loss = ((shard.whole("rnn", outs) - 0.0) ** 2).mean()
        torch.autograd.grad(loss, list(W.values()))
    t = comm.tally()
    return [t["all-gather"]["count"], t["all-reduce"]["count"],
            sum(t[op]["count"] for op in t if op not in ("all-gather", "all-reduce"))]


def quant(c: Case):
    for name in TC.QUANT_CASES:
        c.pair(name, getattr(TC, name), 4)
        c.pair(name + "_d2", getattr(TC, name), 4, data=2)
    # one value-and-gradient of the int4_master and block int8_master
    # chain trajectories' loss at T and 2T steps, model 2 and 4
    budget = {}
    for k in (2, 4):
        m = mesh(k)
        for kind in ("int4_master", "block_int8_master"):
            for T in (8, 16):
                if m.get_coordinate() is not None:
                    budget[f"{kind}_m{k}_T{T}"] = _train_budget(m, T, 32, kind)
            for T in (8, 16):
                if m.get_coordinate() is not None:
                    budget[f"qif_sharded_m{k}_T{T}"] = _graph_budget(m, T)
    c.save("quant_budget", **budget)


def _graph_budget(m, T, n=64):
    """``[all-gathers, all-reduces, others, all-gather bytes, all-reduce
    bytes]`` of a one-epoch fit of the 100k example's network (block size
    8) through the graph trajectory."""
    from rectipy_tpu_torch.parallel import comm

    net = TC.qif_sharded_net(P, n, dtype="float64")
    inp, tgt = TC.testing.qif_sharded_data(n, T)
    comm.reset()
    net.fit_bptt([inp], [tgt], optimizer="adam", lr=1e-3, verbose=False, fused_bptt=True,
                 mesh=m)
    t = comm.tally()
    return [t["all-gather"]["count"], t["all-reduce"]["count"],
            sum(t[op]["count"] for op in t if op not in ("all-gather", "all-reduce")),
            t["all-gather"]["bytes"], t["all-reduce"]["bytes"]]


def fits(c: Case):
    for name in ("rls", "eprop", "rls_rows", "eprop_rows"):
        c.pair(name, getattr(TC, name), 4)
    for name in ("stdp_dense", "stdp_reward", "stdp_block"):
        c.pair(name, getattr(TC, name), 4)
    c.pair("es", TC.es, 4, data=2)
    c.pair("stp_run", TC.stp_run, 4)


def two_process(c: Case):
    c.pair("two_process", TC.two_process, 2)


def _iku(net):
    rng = np.random.default_rng(41)
    n = 16
    net.add_diffeq_node("ik", C.IKU, weights=np.abs(rng.normal(size=(n, n))) * 0.02,
                        source_var="s", target_var="s_in", input_var="I_ext",
                        output_var="s", op="iku_op", spike_var="spike", reset_var="v",
                        spike_threshold=40.0, spike_reset=-60.0)
    net.compile()
    return net


def main():
    group, rank, world, store, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store, world),
                            timeout=timedelta(seconds=120))
    try:
        {"parallel": parallel, "runs": runs, "train": train, "fits": fits, "quant": quant,
         "two_process": two_process}[group](Case(rank, out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
