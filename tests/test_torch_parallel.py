"""``rectipy_tpu_torch.parallel`` and ``run``/``run_batch(mesh=)`` against
the JAX package: the cases of ``tests/test_parallel.py`` on four gloo ranks.

One spawn of four CPU ranks (``tests/_torch_parallel_worker.py``, which
imports the port only) runs every case: each rank builds the network from
the same numpy seeds, runs it without a mesh and on its mesh, and writes the
records.  Here each case holds the ranks' records against the JAX package's
run at the reference test's own tolerance, against the port's run without a
mesh (bit for bit: every comparison below with the port's own run is exact),
and across the ranks (identical).  The JAX tests use an 8-device mesh; four
ranks take ``make_mesh(4)`` where they take ``make_mesh(8)``.
``test_graft_entry_contract`` is not ported (``__graft_entry__.py`` is the
JAX package's entry point); the trainers' ``mesh=`` cases are in
``tests/test_torch_parallel_train.py`` and ``tests/test_torch_parallel_fits.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as PS

import _torch_parallel_cases as C
import rectipy_tpu as J
from rectipy_tpu.ops.sparse import block_random_connectivity
from rectipy_tpu.parallel import make_mesh as jmesh
from rectipy_tpu.parallel import sharded_train_step as j_train_step
from rectipy_tpu.train import get_loss_function, get_optimizer
from rectipy_tpu import inputs as j_inputs

WORLD = 4


def jax_ns():
    def net(dt, dtype="float64", feedback=False):
        cls = J.FeedbackNetwork if feedback else J.Network
        return cls(dt, dtype=getattr(jnp, dtype))

    from types import SimpleNamespace

    return SimpleNamespace(net=net, inputs=j_inputs,
                           block_random_connectivity=block_random_connectivity)


JP = jax_ns()


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return C.spawn("parallel", WORLD, tmp_path_factory.mktemp("parallel"))


def _ranks(rec, case, ranks=range(WORLD)):
    return [C.load(rec, case, r) for r in ranks]


def _same_on_ranks(recs, keys):
    for r in recs[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], recs[0][k])


def _pair(rec, case, ref, rtol, atol, ranks=range(WORLD)):
    """The mesh records: equal to the port's run without a mesh bit for
    bit, identical on every rank, and within the reference test's tolerance
    of the JAX package's run ``ref``."""
    recs = _ranks(rec, case, ranks)
    keys = [k[5:] for k in recs[0] if k.startswith("mesh_")]
    for k in keys:
        np.testing.assert_array_equal(recs[0][f"mesh_{k}"], recs[0][f"ref_{k}"])
        np.testing.assert_allclose(recs[0][f"mesh_{k}"], np.asarray(ref[k]), rtol=rtol,
                                   atol=atol)
    _same_on_ranks(recs, [f"mesh_{k}" for k in keys])
    return recs


def test_make_mesh(rec):
    for r in _ranks(rec, "make_mesh"):
        assert r["shape"].tolist() == [2, 2]
        assert r["names"].tolist() == ["data", "model"]
        assert r["raised"].tolist() == [True, True]  # data=3, and 8 > 4 ranks


def test_sharded_run_matches_single_device(rec):
    W, tau, inp = C.rnn_case()
    ref = C.build_rnn(JP, W, tau).run(inp, verbose=False).to_numpy("out")
    recs = _ranks(rec, "sharded_run")
    for rank, r in enumerate(recs):
        assert r["wshape"].tolist() == [8, 32]  # row-sharded over model 4
        np.testing.assert_array_equal(r["tau"], tau[8 * rank:8 * rank + 8])
        np.testing.assert_array_equal(r["outs"], r["ref"])
        np.testing.assert_allclose(r["outs"], ref, rtol=1e-10, atol=1e-10)
    _same_on_ranks(recs, ["outs"])


def _jax_train(seed, opt_name, B, T, inseed, data):
    rng = np.random.default_rng(seed)
    n = 16
    net = C.build_rnn(JP, rng.normal(size=(n, n)) * 0.1, train_params=["weights"])
    mesh = jmesh(8, data=data)
    train, frozen = net._partition(net.parameters_pytree(), net.trainable_paths())
    opt = get_optimizer(opt_name, 1e-2)
    opt_state = opt.init(train)
    step = j_train_step(net, get_loss_function("mse"), opt, mesh)
    src = rng if inseed is None else np.random.default_rng(inseed)
    on_data = NamedSharding(mesh, PS("data", None, None))
    inputs = jax.device_put(jnp.asarray(src.normal(size=(B, T, n))), on_data)
    targets = jax.device_put(jnp.zeros((B, T, n)), on_data)
    with mesh:
        t1, opt_state, l1 = step(train, frozen, opt_state, net.init_state(), inputs, targets)
        t2, _, l2 = step(t1, frozen, opt_state, net.init_state(), inputs, targets)
    return (float(l1), float(l2), np.asarray(t1["nodes"]["rnn"]["weights"]),
            np.asarray(t2["nodes"]["rnn"]["weights"]))


def _whole_w(recs, key):
    """The trained W of data group 0, assembled from its model ranks."""
    return np.concatenate([r[key] for r in recs if r["coord"][0] == 0])


@pytest.mark.parametrize("case", ["train_adam", "train_sgd"])
def test_sharded_train_step(rec, case):
    # test_sharded_train_step_runs_and_reduces (adam) and
    # test_sharded_train_step_gradient_reduction_spans_data_axis (sgd), on a
    # 2 x 2 (data, model) mesh; the JAX package's step on (2, 4) and (4, 2)
    seed, opt_name, B, T, inseed, data = {
        "train_adam": (1, "adam", 4, 6, None, 2), "train_sgd": (5, "sgd", 8, 5, 6, 4)}[case]
    recs = _ranks(rec, case)
    l1, l2, w1, w2 = _jax_train(seed, opt_name, B, T, inseed, data)
    for r in recs:
        assert np.isfinite(r["l1"]) and np.isfinite(r["l2"])
        assert r["l2"] < r["l1"], "sharded training step did not reduce the loss"
        assert r["w1"].shape == (8, 16)  # model-sharded: N / model rows
        assert np.abs(r["w1"] - r["w0"]).sum() > 0
        np.testing.assert_allclose(r["l1"], l1, rtol=1e-10)
        np.testing.assert_allclose(r["l2"], l2, rtol=1e-10)
    # the update is identical on every data rank of a model row
    by_model = {}
    for r in recs:
        by_model.setdefault(int(r["coord"][1]), []).append(r)
    for group in by_model.values():
        _same_on_ranks(group, ["w1", "w2", "l1", "l2"])
    np.testing.assert_allclose(_whole_w(recs, "w1"), w1, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(_whole_w(recs, "w2"), w2, rtol=1e-8, atol=1e-12)


def test_sharded_train_step_whole_and_sharded_populations(rec):
    # the gradient of a whole population's weights through the edge into a
    # sharded one (summed over the model ranks' rows) and of the sharded
    # population's scalar tau (held whole: its ranks' parts summed), against
    # the JAX package's step on (2, 4)
    net, inputs, targets = C.build_mixed(JP)
    mesh = jmesh(8, data=2)
    train, frozen = net._partition(net.parameters_pytree(), net.trainable_paths())
    opt = get_optimizer("sgd", 0.5)
    step = j_train_step(net, get_loss_function("mse"), opt, mesh)
    on_data = NamedSharding(mesh, PS("data", None, None))
    ins, tgts = (jax.device_put(jnp.asarray(a), on_data) for a in (inputs, targets))
    with mesh:
        t1, opt_state, l1 = step(train, frozen, opt.init(train), net.init_state(), ins, tgts)
        t2, _, l2 = step(t1, frozen, opt_state, net.init_state(), ins, tgts)
    recs = _ranks(rec, "train_mixed")
    for r in recs:
        np.testing.assert_allclose([r["l1"], r["l2"]], [float(l1), float(l2)], rtol=1e-10)
        assert r["l2"] < r["l1"]
        np.testing.assert_allclose(r["a"], np.asarray(t2["nodes"]["a"]["weights"]),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(r["tau"], np.asarray(t2["nodes"]["b"]["li_op/tau"]),
                                   rtol=1e-8, atol=1e-12)
        assert r["b"].shape == (8, 16)
    np.testing.assert_allclose(_whole_w(recs, "b"), np.asarray(t2["nodes"]["b"]["weights"]),
                               rtol=1e-8, atol=1e-12)
    _same_on_ranks(recs, ["a", "tau", "l1", "l2"])


def test_shard_network_arrays_replicates_indivisible(rec):
    for r in _ranks(rec, "indivisible"):
        assert r["shape"].tolist() == [10, 10]  # replicated, not an error


def test_sharded_run_with_delay_edge(rec):
    net, inp = C.build_delay(JP)
    ref = net.run(inp, verbose=False).to_numpy("out")
    recs = _ranks(rec, "delay_edge")
    for r in recs:
        # the placement rule row-shards the (N, D) ring; the run keeps an
        # edge's (source-side) state whole and its weights by target rows
        assert r["rule"].tolist() == [8, 5]
        assert r["ring"].tolist() == [32, 5]
        assert r["weights"].tolist() == [8, 32]
        np.testing.assert_array_equal(r["outs"], r["ref"])
        np.testing.assert_allclose(r["outs"], ref, rtol=1e-10, atol=1e-10)
    _same_on_ranks(recs, ["outs"])


def test_sharded_compilation_inserts_collectives(rec):
    for r in _ranks(rec, "collectives"):
        assert r["counts"].sum() > 0, "no collectives in the sharded step"


def test_sharded_run_int8_coupling_matches_single_device(rec):
    net, inp = C.int8_case(JP)
    ref = net.run(inp, verbose=False).to_numpy("out")
    recs = _ranks(rec, "int8")
    for r in recs:
        assert str(r["wdtype"]) == "torch.int8"
        assert r["wshape"].tolist() == [8, 32] and r["sshape"].tolist() == [8]
        np.testing.assert_array_equal(r["outs"], r["ref"])
        np.testing.assert_allclose(r["outs"], ref, rtol=1e-6, atol=1e-6)
    _same_on_ranks(recs, ["outs"])


def test_public_run_mesh_matches_single_device_including_observer(rec):
    ref = C.observer_run(JP, None)
    recs = _pair(rec, "observer", ref, rtol=1e-12, atol=1e-14)
    assert recs[0]["mesh_steps0"].tolist() == [6, 9, 12, 15, 18, 21]


def test_public_run_mesh_sparse_coupling(rec):
    _pair(rec, "block_sparse", C.block_sparse_run(JP, None), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["dense", "block"])
@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_scan_collective_budget(rec, kind, n_model):
    n = 64
    for r in _ranks(rec, "budget", range(n_model)):
        count, nbytes, others = r[f"{kind}_{n_model}"].tolist()
        assert count == 1, (kind, n_model, count)  # one (N,) source a step
        assert nbytes == n * 4  # float32
        assert others == 0


def test_public_run_batch_mesh_matches_single_device(rec):
    _pair(rec, "run_batch", C.run_batch_qif(JP, None), rtol=1e-5, atol=1e-6)


def test_public_run_mesh_int8_master_matches_single_device(rec):
    _pair(rec, "int8_master", C.int8_master_run(JP, None), rtol=1e-5, atol=1e-6)


def test_public_run_mesh_delay_matrix_edge_matches_single_device(rec):
    _pair(rec, "delay_matrix", C.delay_matrix_run(JP, None), rtol=1e-12, atol=1e-14)
