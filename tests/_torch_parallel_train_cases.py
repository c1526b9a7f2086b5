"""The trainers' mesh cases of ``tests/test_torch_parallel_{train,fits}.py``,
shared by the gloo ranks (``tests/_torch_parallel_worker.py``, which import
the port and never JAX) and the test files (which run the JAX package
through the same functions, without a mesh: the fit its own mesh tests hold
their mesh fits against).

A case is ``fn(P, mesh) -> {name: array}`` as in ``_torch_parallel_cases``:
``P`` the package's namespace (``P.torch`` tells the port's), ``mesh`` a
mesh of that package or None.  Every input comes from a numpy seed.
"""

import os
from types import SimpleNamespace

import numpy as np

from _torch_parallel_cases import LIF, QIF, QIF_SFA, TANH, _rnn
from rectipy_tpu_torch import testing


def _np(x):
    x = x.detach().cpu() if hasattr(x, "detach") else x
    return np.asarray(x, dtype=np.float64)


def _fit_info(P, net, out: dict) -> dict:
    """The port's trajectory (``net.last_fit``), beside a case's records."""
    if P.torch:
        out["traj"] = np.asarray(net.last_fit["trajectory"])
    return out


# ------------------------------------------------ tests/test_parallel.py
def chain_f32(P, mesh):
    """``test_public_fit_bptt_mesh_matches_single_device``: the chain
    trajectory, float32, five adam epochs."""
    n = 16
    rng = np.random.default_rng(8)
    W0 = rng.normal(size=(n, n)) * 0.2
    inp, tgt = rng.normal(size=(50, n)), rng.normal(size=(50, n))
    net = _rnn(P, W0, "float32", train_params=["weights"])
    obs = net.fit_bptt([inp] * 5, [tgt] * 5, optimizer="adam", lr=1e-2, verbose=False,
                       mesh=mesh)
    return _fit_info(P, net, {"loss": _np(obs["epoch_loss"]),
                              "w": _np(net.get_node("rnn")["weights"])})


def graph_feedback(P, mesh):
    """``test_public_fit_bptt_mesh_graph_trajectory_matches_single_device``:
    two populations, a feedback edge trained by gradient descent, float64."""
    n = 16
    rng = np.random.default_rng(9)
    W1, W2 = rng.normal(size=(n, n)) * 0.2, rng.normal(size=(n, n)) * 0.2
    k_fb = rng.normal(size=(n, n)) * 0.1
    inp, tgt = rng.normal(size=(50, n)), rng.normal(size=(50, n)) * 0.1
    net = P.net(1e-2, feedback=True)
    for label, W in (("p1", W1), ("p2", W2)):
        net.add_diffeq_node(label, TANH, weights=W, input_var="li_op/I_ext",
                            output_var="li_op/v", source_var="tanh_op/r",
                            target_var="li_op/r_in", train_params=["weights"])
    net.add_edge("p1", "p2", weights=np.eye(n))
    net.add_edge("p2", "p1", weights=k_fb, feedback=True, train="gd")
    obs = net.fit_bptt([inp] * 4, [tgt] * 4, optimizer="adam", lr=1e-2, verbose=False,
                       mesh=mesh, fused_bptt=True)
    return _fit_info(P, net, {"loss": _np(obs["epoch_loss"]),
                              "w1": _np(net.get_node("p1")["weights"]),
                              "wfb": _np(net.get_edge("p2", "p1").weights)})


def int8_master(P, mesh):
    """``test_public_fit_bptt_mesh_int8_master_matches_single_device``, with
    ``RECTIPY_FUSED_ADAM=off`` (the caller sets it)."""
    n = 16
    rng = np.random.default_rng(13)
    W0 = rng.normal(size=(n, n)) * 0.2
    inp, tgt = rng.normal(size=(50, n)), rng.normal(size=(50, n)) * 0.1
    net = _rnn(P, W0, train_params=["weights"], coupling_dtype="int8_master")
    obs = net.fit_bptt([inp] * 4, [tgt] * 4, optimizer="adam", lr=1e-2, verbose=False,
                       mesh=mesh)
    return _fit_info(P, net, {"loss": _np(obs["epoch_loss"]),
                              "w": _np(net.get_node("rnn")["weights"])})


def _block_delay_net(P, train=None, **ekw):
    rng = np.random.default_rng(29)
    n_br = nb = 8
    cb, bs = 2, 4
    n = n_br * bs
    blocks = rng.normal(size=(n_br, cb, bs, bs)) * 0.2
    cols = np.stack([rng.choice(nb, cb, replace=False) for _ in range(n_br)]).astype(np.int32)
    d_blk = rng.integers(0, 7, size=(n_br, cb))
    inp = rng.normal(size=(40, n))
    net = P.net(1e-2, feedback=True)
    net.add_diffeq_node("rnn", TANH, weights=np.zeros((n, n)), input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r", target_var="li_op/r_in")
    net.add_edge("rnn", "rnn", weights=P.BlockSparseCoupling(blocks, cols), delays=d_blk,
                 feedback=True, train=train, **ekw)
    net.compile()
    return net, inp


def block_delay(P, mesh):
    """``test_public_run_and_fit_mesh_block_sparse_delay_edge_matches_single_
    device``: a per-block-delayed feedback edge, its run and its fit (the
    graph trajectory's rolled delay buffer), float64."""
    net, inp = _block_delay_net(P)
    out = net.run(inp, sampling_steps=2, verbose=False, mesh=mesh).to_numpy("out")
    tgt = _block_delay_net(P)[0].run(inp, sampling_steps=2, verbose=False).to_numpy("out")
    net, _ = _block_delay_net(P, "gd")
    e = net.get_edge("rnn", "rnn")
    e.weights = _np(e.weights) * 1.3
    obs = net.fit_bptt([inp] * 4, [tgt] * 4, optimizer="adam", lr=1e-2, sampling_steps=2,
                       verbose=False, mesh=mesh)
    return _fit_info(P, net, {"out": out, "loss": _np(obs["epoch_loss"]),
                              "w": _np(e.weights)})


def chain_readout(P, mesh, fused_bptt="auto"):
    """A chain whose input node the model axis does not divide (``m = 2``,
    whole on every rank) and whose trained readout (``3``) it does not
    divide either, around a sharded population that trains its coupling and
    its scalar ``tau`` (a leaf the shard holds whole); ``fused_bptt=False``
    takes plain autograd over the shard's step.  Float64, three epochs,
    records of the last epoch."""
    n, m, k = 16, 2, 3
    rng = np.random.default_rng(17)
    net = P.net(1e-2)
    net.add_func_node("inp", m, activation_function="identity")
    net.add_diffeq_node("rnn", TANH, weights=rng.normal(size=(n, n)) * 0.3,
                        input_var="li_op/I_ext", output_var="li_op/v",
                        source_var="tanh_op/r", target_var="li_op/r_in",
                        train_params=["weights", "tau"])
    net.add_edge("inp", "rnn", weights=rng.normal(size=(n, m)))
    net.add_func_node("out", k, activation_function="tanh")
    net.add_edge("rnn", "out", weights=rng.normal(size=(k, n)) * 0.3, train="gd")
    inp, tgt = rng.normal(size=(30, m)), rng.normal(size=(30, k)) * 0.3
    obs = net.fit_bptt([inp] * 3, [tgt] * 3, optimizer="adam", lr=1e-2, verbose=False,
                       mesh=mesh, fused_bptt=fused_bptt, record_output=True)
    return _fit_info(P, net, {"loss": _np(obs["epoch_loss"]), "out": obs.to_numpy("out"),
                              "w": _np(net.get_node("rnn")["weights"]),
                              "tau": _np(net.get_node("rnn")["tau"]),
                              "wout": _np(net.get_edge("rnn", "out").weights)})


def chain_readout_autograd(P, mesh):
    return chain_readout(P, mesh, fused_bptt=False)


def step_mode(P, mesh, remat=False):
    """Truncated BPTT (step mode, chunks of 12 steps) with a population mean
    recorded (plain autograd over the shard's step), or epoch mode
    checkpointed in 10-step chunks (``remat_steps``), float64."""
    n = 16
    rng = np.random.default_rng(19)
    W0 = rng.normal(size=(n, n)) * 0.3
    inp, tgt = rng.normal(size=(50, n)), rng.normal(size=(50, n)) * 0.1
    net = _rnn(P, W0, train_params=["weights"])
    if remat:
        obs = net.fit_bptt([inp] * 3, [tgt] * 3, optimizer="adam", lr=1e-2, verbose=False,
                           mesh=mesh, remat_steps=10)
        out = {"loss": _np(obs["epoch_loss"])}
    else:
        obs = net.fit_bptt(inp, tgt, optimizer="adam", lr=1e-2, update_steps=12,
                           sampling_steps=5, verbose=False, mesh=mesh,
                           record_vars=[("rnn", "v", True)])
        out = {"out": obs.to_numpy("out"), "v": obs.to_numpy(("rnn", "v")),
               "loss": obs.to_numpy("loss"), "y": _np(net.get_node("rnn").y)}
    out["w"] = _np(net.get_node("rnn")["weights"])
    return _fit_info(P, net, out)


def remat(P, mesh):
    return step_mode(P, mesh, remat=True)


# ------------------------------------------------- tests/test_bptt_batch.py
def batch(P, mesh):
    """``test_batch_mesh_matches_single_device``: minibatches of two of four
    trials, three epochs, adam."""
    rng = np.random.default_rng(11)
    W0 = rng.normal(scale=0.3, size=(8, 8))
    B, T = 4, 24
    ins, tgts = rng.normal(size=(B, T, 1)), rng.normal(size=(B, T, 8)) * 0.1
    net = P.net(1e-2)
    net.add_diffeq_node("p", TANH, weights=W0.copy(), source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext",
                        output_var="tanh_op/r", train_params=["weights"])
    obs = net.fit_bptt_batch(ins, tgts, n_epochs=3, batch_size=2, optimizer="adam", lr=1e-2,
                             seed=5, verbose=False, mesh=mesh)
    return _fit_info(P, net, {"w": _np(net.get_var("p", "weights")),
                              "loss": _np(obs["train_loss"])})


def batch_int8_master(P, mesh):
    """The ensemble of :func:`batch` on an ``int8_master`` coupling: the
    transposed product of ``(B, n)`` rows (``int8_mm_t`` on the card) takes
    each row's cotangent scale over every rank's rows."""
    rng = np.random.default_rng(11)
    W0 = rng.normal(scale=0.3, size=(8, 8))
    ins, tgts = rng.normal(size=(4, 24, 1)), rng.normal(size=(4, 24, 8)) * 0.1
    net = P.net(1e-2)
    net.add_diffeq_node("p", TANH, weights=W0.copy(), source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext",
                        output_var="tanh_op/r", train_params=["weights"],
                        coupling_dtype="int8_master")
    obs = net.fit_bptt_batch(ins, tgts, n_epochs=3, batch_size=2, optimizer="adam", lr=1e-2,
                             seed=5, verbose=False, mesh=mesh)
    return _fit_info(P, net, {"w": _np(net.get_var("p", "weights")),
                              "loss": _np(obs["train_loss"])})


def block_coupling(P, mesh):
    """A population trained through its block-sparse coupling (the chain
    trajectory's block products; a shard holds some of its block rows and
    contracts every column block), float64, three epochs."""
    rng = np.random.default_rng(23)
    A = P.block_random_connectivity(32, 32, 2, block_size=4, seed=3)
    inp, tgt = rng.normal(size=(30, 32)), rng.normal(size=(30, 32)) * 0.1
    net = _rnn(P, A, train_params=["weights"])
    obs = net.fit_bptt([inp] * 3, [tgt] * 3, optimizer="adam", lr=1e-2, verbose=False,
                       mesh=mesh)
    return _fit_info(P, net, {"loss": _np(obs["epoch_loss"]),
                              "w": _np(net.get_node("rnn")["weights"])})


# ---------------------------------------- tests/test_torch_parallel_quant.py
# The quantized couplings and the edges into a shard that a model axis above
# one trains since the port's last mesh slice; the JAX package's fits of
# each, without a mesh and on make_mesh(8), are the reference.
def int4_master(P, mesh, fused_bptt="auto"):
    """A dense ``int4_master`` chain fit (the chain trajectory, or plain
    autograd with ``fused_bptt=False``), float64, four adam epochs."""
    n = 16
    rng = np.random.default_rng(31)
    W0 = rng.normal(size=(n, n)) * 0.3
    inp, tgt = rng.normal(size=(40, n)), rng.normal(size=(40, n)) * 0.1
    net = _rnn(P, W0, train_params=["weights"], coupling_dtype="int4_master")
    obs = net.fit_bptt([inp] * 4, [tgt] * 4, optimizer="adam", lr=1e-2, verbose=False,
                       mesh=mesh, fused_bptt=fused_bptt)
    return _fit_info(P, net, {"loss": _np(obs["epoch_loss"]),
                              "w": _np(net.get_node("rnn")["weights"])})


def int4_master_autograd(P, mesh):
    return int4_master(P, mesh, fused_bptt=False)


def int4_master_steps(P, mesh):
    """Truncated BPTT (step mode, 10-step chunks) of the ``int4_master``
    chain: plain autograd over the shard's step."""
    n = 16
    rng = np.random.default_rng(37)
    W0 = rng.normal(size=(n, n)) * 0.3
    inp, tgt = rng.normal(size=(40, n)), rng.normal(size=(40, n)) * 0.1
    net = _rnn(P, W0, train_params=["weights"], coupling_dtype="int4_master")
    obs = net.fit_bptt(inp, tgt, optimizer="adam", lr=1e-2, update_steps=10, verbose=False,
                       mesh=mesh)
    return _fit_info(P, net, {"loss": obs.to_numpy("loss"),
                              "w": _np(net.get_node("rnn")["weights"])})


def batch_int4_master(P, mesh):
    """:func:`batch_int8_master` on an ``int4_master`` coupling: the
    transposed products of ``(B, n)`` rows (``int4_mm_t`` on the card)."""
    rng = np.random.default_rng(11)
    W0 = rng.normal(scale=0.3, size=(8, 8))
    ins, tgts = rng.normal(size=(4, 24, 1)), rng.normal(size=(4, 24, 8)) * 0.1
    net = P.net(1e-2)
    net.add_diffeq_node("p", TANH, weights=W0.copy(), source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext",
                        output_var="tanh_op/r", train_params=["weights"],
                        coupling_dtype="int4_master")
    obs = net.fit_bptt_batch(ins, tgts, n_epochs=3, batch_size=2, optimizer="adam", lr=1e-2,
                             seed=5, verbose=False, mesh=mesh)
    return _fit_info(P, net, {"w": _np(net.get_var("p", "weights")),
                              "loss": _np(obs["train_loss"])})


def multistart_int4_master(P, mesh):
    """:func:`multistart`'s four starts on an ``int4_master`` coupling (the
    starts over ``data``, each start's ``(B, n)`` rows on ``model``)."""
    rng0 = np.random.default_rng(0)
    W0 = rng0.normal(scale=0.3, size=(8, 8))
    ins, tgts = rng0.normal(size=(4, 20, 1)), rng0.normal(size=(4, 20, 8)) * 0.1
    net = P.net(1e-2)
    net.add_diffeq_node("p", TANH, weights=W0.copy(), source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext",
                        output_var="tanh_op/r", train_params=["weights"],
                        coupling_dtype="int4_master")
    W_inits = np.random.default_rng(3).normal(scale=0.3, size=(4, 8, 8))
    obs = net.fit_bptt_multistart(ins, tgts, n_starts=4, start_inits={("p", "weights"): W_inits},
                                  n_epochs=2, optimizer="adam", lr=1e-2, verbose=False,
                                  mesh=mesh)
    return _fit_info(P, net, {"final": _np(obs["start_final_loss"]),
                              "w": _np(net.get_var("p", "weights"))})


def block_int8_master(P, mesh, fused_bptt="auto"):
    """:func:`block_coupling` quantized: an ``int8_master`` block coupling
    (a shard's block rows, the cotangent's scale over the ranks), float64,
    three epochs; ``fused_bptt=False`` takes plain autograd."""
    rng = np.random.default_rng(23)
    A = P.block_random_connectivity(32, 32, 8, block_size=4, seed=3)
    inp, tgt = rng.normal(size=(30, 32)), rng.normal(size=(30, 32)) * 0.1
    net = _rnn(P, A, train_params=["weights"], coupling_dtype="int8_master")
    obs = net.fit_bptt([inp] * 3, [tgt] * 3, optimizer="adam", lr=1e-2, verbose=False,
                       mesh=mesh, fused_bptt=fused_bptt)
    return _fit_info(P, net, {"loss": _np(obs["epoch_loss"]),
                              "w": _np(net.get_node("rnn")["weights"])})


def block_int8_master_autograd(P, mesh):
    return block_int8_master(P, mesh, fused_bptt=False)


def qif_sharded_net(P, n=64, bs=8, fan_in=16, dtype="float32"):
    """``examples/qif_100k_sharded.py``'s training network at ``n`` neurons
    (``rectipy_tpu_torch.testing.qif_sharded_net``, built in ``P``'s
    package): block size ``bs``, fan-in ``fan_in``."""
    ns = SimpleNamespace(net=lambda dt: P.net(dt, dtype, feedback=True), template=QIF_SFA,
                         block_random_connectivity=P.block_random_connectivity)
    return testing.qif_sharded_net(n, bs, fan_in, ns=ns)


def qif_sharded(P, mesh):
    """The example's fit at N=64, block size 8, T=200, two epochs: the
    graph trajectory through the int8 blocks and the delayed gains.
    Float64: the JAX package's float32 network fails its trajectory's
    carry check under ``jax_enable_x64``, which the tests switch on (its
    delay buffer's update promotes to float64)."""
    net = qif_sharded_net(P, dtype="float64")
    inp, tgt = testing.qif_sharded_data(64, 200)
    obs = net.fit_bptt([inp] * 2, [tgt] * 2, optimizer="adam", lr=1e-3, verbose=False,
                       fused_bptt=True, mesh=mesh)
    return _fit_info(P, net, {"loss": _np(obs["epoch_loss"]),
                              "w": _np(net.get_node("qif")["weights"]),
                              "gains": _np(net.get_edge("qif", "qif").weights)})


def block_edge_int8(P, mesh):
    """:func:`block_delay`'s per-block-delayed feedback edge at
    ``block_dtype='int8_master'`` (as ``benchmarks/block_delay_scale.py``
    streams it): the frozen edge's run, then the edge trained through the
    graph trajectory, float64."""
    net, inp = _block_delay_net(P)
    tgt = net.run(inp, sampling_steps=2, verbose=False).to_numpy("out")
    # the frozen edge's run (its stack's activation scale over the ranks)
    out = _block_delay_net(P, block_dtype="int8_master")[0].run(
        inp, sampling_steps=2, verbose=False, mesh=mesh).to_numpy("out")
    net, _ = _block_delay_net(P, "gd", block_dtype="int8_master")
    e = net.get_edge("rnn", "rnn")
    e.weights = _np(e.weights) * 1.3
    obs = net.fit_bptt([inp] * 3, [tgt] * 3, optimizer="adam", lr=1e-2, sampling_steps=2,
                       verbose=False, mesh=mesh)
    return _fit_info(P, net, {"out": out, "loss": _np(obs["epoch_loss"]), "w": _np(e.weights)})


def _diag_net(P):
    n = 16
    rng = np.random.default_rng(43)
    W0 = rng.normal(size=(n, n)) * 0.2
    inp, tgt = rng.normal(size=(40, n)), rng.normal(size=(40, n)) * 0.1
    net = P.net(1e-2, feedback=True)
    net.add_func_node("inp", n, activation_function="identity")
    net.add_diffeq_node("rnn", TANH, weights=W0, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", train_params=["weights"])
    net.add_edge("inp", "rnn", weights=rng.uniform(0.5, 1.5, size=n), train="gd")
    net.add_edge("rnn", "rnn", weights=rng.normal(size=n) * 0.3,
                 delays=rng.integers(0, 5, size=n), feedback=True, train="gd")
    net.compile()
    return net, inp, tgt


def _diag_info(P, net, loss):
    return _fit_info(P, net, {"loss": loss, "w": _np(net.get_node("rnn")["weights"]),
                              "g_in": _np(net.get_edge("inp", "rnn").weights),
                              "g_fb": _np(net.get_edge("rnn", "rnn").weights)})


def diag_gains(P, mesh):
    """Delayed diagonal gains (a ``LinearMemory`` with 1-D weights) and
    undelayed ones into a sharded population, both trained by gradient
    descent with its coupling, float64, four epochs (graph trajectory)."""
    net, inp, tgt = _diag_net(P)
    obs = net.fit_bptt([inp] * 4, [tgt] * 4, optimizer="adam", lr=1e-2, verbose=False,
                       mesh=mesh)
    return _diag_info(P, net, _np(obs["epoch_loss"]))


def diag_gains_steps(P, mesh):
    """:func:`diag_gains` in step mode (10-step chunks): the graph
    trajectory carries the delayed gains' buffer (a shard: its rows) from
    chunk to chunk."""
    net, inp, tgt = _diag_net(P)
    obs = net.fit_bptt(inp, tgt, optimizer="adam", lr=1e-2, update_steps=10, verbose=False,
                       mesh=mesh)
    return _diag_info(P, net, obs.to_numpy("loss"))


QUANT_CASES = ("int4_master", "int4_master_autograd", "int4_master_steps", "batch_int4_master",
               "multistart_int4_master", "block_int8_master", "block_int8_master_autograd", "qif_sharded",
               "block_edge_int8", "diag_gains", "diag_gains_steps")


# ------------------------------------------------ tests/test_multistart.py
def _ms_net(P):
    rng0 = np.random.default_rng(0)
    N = 6
    W0 = rng0.normal(scale=0.3, size=(N, N))
    ins, tgts = rng0.normal(size=(4, 30, 1)), rng0.normal(size=(4, 30, N)) * 0.1
    net = P.net(1e-2)
    net.add_diffeq_node("p", TANH, weights=W0.copy(), source_var="tanh_op/r",
                        target_var="li_op/r_in", input_var="li_op/I_ext",
                        output_var="tanh_op/r", train_params=["weights"])
    return net, ins, tgts


def multistart(P, mesh):
    """``test_multistart_mesh_matches_unsharded``: four starts from given
    inits, four epochs."""
    net, ins, tgts = _ms_net(P)
    W_inits = np.random.default_rng(3).normal(scale=0.3, size=(4, 6, 6))
    obs = net.fit_bptt_multistart(ins, tgts, n_starts=4, start_inits={("p", "weights"): W_inits},
                                  n_epochs=4, optimizer="adam", lr=1e-2, verbose=False,
                                  mesh=mesh)
    return _fit_info(P, net, {"final": _np(obs["start_final_loss"]),
                              "best": np.asarray(obs["best_start"]),
                              "w": _np(net.get_var("p", "weights"))})


def multistart_indivisible(P, mesh):
    """``test_multistart_mesh_indivisible_starts_warns_but_matches``: three
    starts (perturbed from seed 7) on a data axis of two."""
    net, ins, tgts = _ms_net(P)
    obs = net.fit_bptt_multistart(ins, tgts, n_starts=3, n_epochs=2, seed=7, optimizer="adam",
                                  lr=1e-2, verbose=False, mesh=mesh)
    return _fit_info(P, net, {"final": _np(obs["start_final_loss"]),
                              "w": _np(net.get_var("p", "weights"))})


# ------------------------------------------- the online rules and fit_es
def _rls_net(P, nout=1):
    n, m, T = 16, 2, 120
    rng = np.random.default_rng(12)
    W0 = rng.normal(size=(n, n)) * 0.2
    W0 /= np.max(np.abs(np.linalg.eigvals(W0)))
    W_in = rng.normal(size=(n, m))
    inp, tgt = rng.normal(size=(T, m)), rng.normal(size=(T, 1)) * 0.1
    net = P.net(1e-2)
    net.add_func_node("inp", m, activation_function="identity")
    net.add_diffeq_node("rnn", TANH, weights=W0, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r", target_var="li_op/r_in")
    net.add_edge("inp", "rnn", weights=W_in)
    net.add_func_node("out", nout, activation_function="identity")
    net.add_edge("rnn", "out", train="rls")
    net.compile()
    return net, inp, np.tile(tgt, (1, nout)) * np.linspace(1.0, 2.0, nout)


def online(P, mesh, method="fit_rls", nout=1):
    """``test_public_fit_rls_and_eprop_mesh_match_single_device``: an RLS or
    e-prop readout of a sharded reservoir, float64; ``nout = 4`` shards the
    readout too (its rows of the weights and of the residual trace)."""
    net, inp, tgt = _rls_net(P, nout)
    kwargs = (dict(update_steps=2, sampling_steps=10) if method == "fit_rls" else
              dict(update_steps=1, sampling_steps=10, lr=1e-3, decay=0.5))
    obs = getattr(net, method)(inp, tgt, verbose=False, mesh=mesh, **kwargs)
    return {"w": _np(net.get_edge("rnn", "out").weights), "out": obs.to_numpy("out"),
            "loss": obs.to_numpy("loss"), "y": _np(net.get_node("rnn").y)}


def rls(P, mesh):
    return online(P, mesh, "fit_rls")


def eprop(P, mesh):
    return online(P, mesh, "fit_eprop")


def rls_rows(P, mesh):
    return online(P, mesh, "fit_rls", nout=4)


def eprop_rows(P, mesh):
    return online(P, mesh, "fit_eprop", nout=4)


def stdp_dense(P, mesh, **kw):
    """``test_public_fit_stdp_mesh_matches_single_device``: two LIF
    populations and a dense STDP edge between them, float64, 200 steps."""
    n, T = 8, 200
    rng = np.random.default_rng(21)
    w0 = rng.uniform(0.2, 0.8, size=(n, n))
    inp = (rng.random((T, n)) < 0.1) * 40.0
    net = P.net(0.1)
    net.add_func_node("inp", n, activation_function="identity")
    for label in ("pre", "post"):
        net.add_diffeq_node(label, LIF, weights=np.zeros((n, n)), source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s", op="lif_op",
                            spike_var="spike", reset_var="v", spike_threshold=1.0,
                            spike_reset=0.0)
    net.add_edge("inp", "pre", weights=np.eye(n))
    net.add_edge("inp", "post", weights=0.5 * np.eye(n))
    net.add_edge("pre", "post", train="stdp", weights=w0, tau_plus=2.0, tau_minus=2.0,
                 a_plus=0.05, a_minus=0.04, w_min=0.0, w_max=1.0)
    net.compile()
    obs = net.fit_stdp(inp, sampling_steps=20, verbose=False, mesh=mesh, **kw)
    e = net.get_edge("pre", "post")
    out = {k: _np(e.params[k]) for k in ("weights", "x_pre", "x_post")}
    out.update(w0=w0, w_mean=_np(obs["w_mean"]), w_max=_np(obs["w_max"]),
               w_min=_np(obs["w_min"]), out=obs.to_numpy("out"))
    return out


def stdp_reward(P, mesh):
    """The dense case, reward-modulated (hard bounds, eligibility on the
    rows)."""
    return stdp_dense(P, mesh, reward=np.sin(np.arange(200) / 7.0))


def stdp_block(P, mesh):
    """``tests/test_stdp.py``'s ``test_fit_stdp_block_mesh_matches_single_
    device``: a block-sparse plastic QIF feedback edge with homeostasis,
    float64, 200 steps."""
    rng = np.random.default_rng(44)
    T, dt = 200, 1e-3
    nb, cb, bs = 4, 2, 2
    cols = np.stack([rng.choice(nb, size=cb, replace=False) for _ in range(nb)]).astype(np.int32)
    A = P.BlockSparseCoupling(rng.uniform(0.2, 0.6, size=(nb, cb, bs, bs)), cols)
    n = nb * bs
    x = (rng.random((T, n)) < 0.15) * 30.0
    eta = np.random.default_rng(4).uniform(300.0, 500.0, n)
    net = P.net(dt, feedback=True)
    net.add_diffeq_node("qif", QIF, weights=np.zeros((n, n)), source_var="s", target_var="s_in",
                        input_var="I_ext", output_var="s", spike_var="spike", reset_var="v",
                        op="qif_op", spike_threshold=100.0, spike_reset=-100.0,
                        node_vars={"all/qif_op/eta": eta})
    net.add_edge("qif", "qif", feedback=True, train="stdp", weights=A, tau_plus=20e-3,
                 tau_minus=20e-3, a_plus=5e-3, a_minus=4e-3, w_min=0.0, w_max=1.0)
    obs = net.fit_stdp(x, sampling_steps=50, verbose=False, homeostasis_steps=50, mesh=mesh)
    e = net.get_edge("qif", "qif")
    out = {k: _np(e.params[k]) for k in ("weights", "x_pre", "x_post")}
    out["w_mean"] = _np(obs["w_mean"])
    return out


def es(P, mesh):
    """``tests/test_es.py``'s ``test_fit_es_under_mesh_matches_unsharded_
    losses``: eta of a float32 tanh population from a teacher's records, six
    generations of eight candidates."""
    n, T = 16, 40
    rng = np.random.default_rng(6)
    w = rng.standard_normal((n, n)) * 0.1
    inp = rng.normal(size=(T, n)).astype(np.float32) * 0.1

    def li(eta):
        net = P.net(1e-2, "float32")
        net.add_diffeq_node("pop", TANH, weights=w, input_var="li_op/I_ext",
                            output_var="li_op/v", source_var="tanh_op/r",
                            target_var="li_op/r_in", node_vars={"all/li_op/eta": eta})
        return net

    targets = li(0.6).run(inp, sampling_steps=1, verbose=False).to_numpy("out")
    net = li(0.0)
    obs = net.fit_es(inp, targets, fit_vars=[("pop", "li_op/eta")], n_generations=6,
                     pop_size=8, sigma=0.3, lr=0.3, seed=4, mesh=mesh, verbose=False)
    return {"hist": _np(obs["es_mean_loss"]), "eta": _np(net.get_var("pop", "li_op/eta"))}


# ------------------------------------------------------ tests/test_stp.py
def stp_run(P, mesh):
    """``test_stp_run_under_mesh_matches_single_device``: a short-term
    plastic (``LinearSTP``) edge into a sharded population.  Float64, as the
    port's STP parity tests run (``tests/test_torch_stp.py``): the JAX test's
    default float32 would hold two packages to each other's float32
    rounding (2.3e-7), where that test holds one package to itself."""
    rng = np.random.default_rng(17)
    n = 16
    inp = np.abs(rng.normal(size=(25, n)))
    w_rec = rng.standard_normal((n, n)) * 0.1
    net = P.net(1e-2)
    net.add_func_node("inp", n, activation_function="identity")
    net.add_diffeq_node("pop", TANH, weights=w_rec, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r", target_var="li_op/r_in")
    net.add_edge("inp", "pop", weights=np.eye(n), tau_facil=40.0, tau_depress=120.0, U=0.3)
    return {"out": net.run(inp, sampling_steps=1, verbose=False, mesh=mesh).to_numpy("out")}


# ---------------------------------------------- tests/test_multiprocess.py
def two_process(P, mesh):
    """``tests/_dcn_worker.py``'s workload: a recorded run and a two-epoch
    fit of an N=32 tanh population, float64."""
    n, T, dt = 32, 40, 1e-2
    rng = np.random.default_rng(0)
    W = rng.normal(size=(n, n)) * 0.2
    inp = rng.normal(size=(T, n))
    tgt = 0.3 * rng.normal(size=(T, n))
    obs = _rnn(P, W, dt=dt, train_params=["weights"]).run(
        inp, sampling_steps=2, verbose=False, record_output=False,
        record_vars=[("rnn", "v", True)], mesh=mesh)
    fit = _rnn(P, W, dt=dt, train_params=["weights"]).fit_bptt(
        [inp] * 2, [tgt] * 2, optimizer="adam", lr=1e-3, verbose=False, mesh=mesh)
    return {"trace": obs.to_numpy(("rnn", "v")), "losses": _np(fit["epoch_loss"])}


def fused_adam_env(mode: str):
    """A context that sets ``RECTIPY_FUSED_ADAM`` and restores it."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        old = os.environ.get("RECTIPY_FUSED_ADAM")
        os.environ["RECTIPY_FUSED_ADAM"] = mode
        try:
            yield
        finally:
            if old is None:
                os.environ.pop("RECTIPY_FUSED_ADAM", None)
            else:
                os.environ["RECTIPY_FUSED_ADAM"] = old

    return ctx()
