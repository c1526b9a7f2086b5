"""The BPTT trainers' ``mesh=`` against the JAX package: ``fit_bptt``,
``fit_bptt_batch`` and ``fit_bptt_multistart`` on four gloo ranks.

One spawn of four CPU ranks (``tests/_torch_parallel_worker.py``, group
``train``, which imports the port only) runs every case of
``tests/_torch_parallel_train_cases.py``: each rank fits the network without
a mesh and on its mesh and writes the records, while this process fits the
JAX package's network without a mesh (what the JAX package's own mesh tests
hold their mesh fits against).  Each case holds the mesh fit

- against the JAX package's fit, at the tolerance of the JAX test it ports
  (``tests/test_parallel.py``, ``tests/test_bptt_batch.py``,
  ``tests/test_multistart.py``); the cases without a JAX mesh test (a chain
  with whole prefix and readout nodes, plain autograd, step mode, remat) at
  the tolerance of the port's own unsharded parity tests;
- against the port's fit without a mesh: bit for bit, but the float32
  chain's weights (within 3e-8: each rank's ``dW`` rows are one
  ``(rows, T) x (T, N)`` product of their own), the plain-autograd and
  step-mode weights (within 1e-15: the ``W^T delta`` partial sums are added
  over the ranks), the block coupling's (within 1e-9: each rank's
  transposed block product rounds its partial sums to float32) and the
  ``int8_master`` ensemble's (weights within 1e-8, losses 1e-11: each data
  group's float32 ``dW`` over its own trials);
- across the ranks: identical.

The JAX tests take an 8-device mesh; four ranks take model 4 where they take
``make_mesh(8)``, and data 2 x model 2 where they take ``make_mesh(8,
data=2)``.  Every mesh fit takes the trajectory of the fit without a mesh
(``net.last_fit``).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parallel_cases as C
import _torch_parallel_train_cases as TC
import rectipy_tpu as J
from rectipy_tpu.ops.sparse import block_random_connectivity

WORLD = 4


def _jax_ns():
    def net(dt, dtype="float64", feedback=False):
        cls = J.FeedbackNetwork if feedback else J.Network
        return cls(dt, dtype=getattr(jnp, dtype))

    return SimpleNamespace(net=net, torch=False, BlockSparseCoupling=J.BlockSparseCoupling,
                           block_random_connectivity=block_random_connectivity)


JP = _jax_ns()
CASES = ("chain_f32", "graph", "int8_master", "block_delay", "chain_readout",
         "chain_readout_autograd", "step_mode", "remat", "batch", "batch_int8_master",
         "block_coupling", "multistart", "multistart_indivisible")
FN = {"graph": TC.graph_feedback}


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """The ranks' records and the JAX package's fits, made meanwhile."""
    finish = C.start("train", WORLD, tmp_path_factory.mktemp("train"))
    refs = {}
    for name in CASES:
        with TC.fused_adam_env("off"):  # tests/test_parallel.py:506 pins it for both arms
            refs[name] = FN.get(name, getattr(TC, name, None))(JP, None)
    return SimpleNamespace(dir=finish(), refs=refs)


def _check(rec, case, ref, tol, self_tol=None, traj=None):
    """The mesh records: identical on every rank, equal to the port's fit
    without a mesh (bit for bit, or within ``self_tol[key]``), on the same
    trajectory, and within ``tol[key] = (rtol, atol)`` of the JAX fit."""
    recs = [C.load(rec.dir, case, r) for r in range(WORLD)]
    got = recs[0]
    for key, (rtol, atol) in tol.items():
        mesh, own = got[f"mesh_{key}"], got[f"ref_{key}"]
        if self_tol and key in self_tol:
            np.testing.assert_allclose(mesh, own, rtol=0, atol=self_tol[key], err_msg=key)
        else:
            np.testing.assert_array_equal(mesh, own, err_msg=key)
        np.testing.assert_allclose(mesh, np.asarray(ref[key]), rtol=rtol, atol=atol,
                                   err_msg=key)
        for r in recs[1:]:
            np.testing.assert_array_equal(r[f"mesh_{key}"], mesh, err_msg=key)
    if "mesh_traj" in got:
        assert str(got["mesh_traj"]) == str(got["ref_traj"])
        if traj is not None:
            assert str(got["mesh_traj"]) == traj
    return got


def test_public_fit_bptt_mesh_matches_single_device(rec):
    # tests/test_parallel.py:268, the chain trajectory, float32 (losses rtol 1e-5)
    got = _check(rec, "chain_f32", rec.refs["chain_f32"], {"loss": (1e-5, 0.0)},
                 traj="chain")
    np.testing.assert_allclose(got["mesh_w"], got["ref_w"], rtol=0, atol=3e-8)
    assert got["mesh_loss"][-1] < got["mesh_loss"][0]


def test_public_fit_bptt_mesh_graph_trajectory_matches_single_device(rec):
    # tests/test_parallel.py:421: losses rtol 1e-10, weights rtol 1e-8
    got = _check(rec, "graph", rec.refs["graph"],
                 {"loss": (1e-10, 0.0), "w1": (1e-8, 1e-12), "wfb": (1e-8, 1e-12)},
                 traj="graph")
    assert got["mesh_loss"][-1] < got["mesh_loss"][0]


def test_public_fit_bptt_mesh_int8_master_matches_single_device(rec):
    # tests/test_parallel.py:506 (RECTIPY_FUSED_ADAM=off in both arms): the
    # per-row scales over each rank's rows, the activation scale of the
    # gathered source, the cotangent's scale a maximum over the ranks
    got = _check(rec, "int8_master", rec.refs["int8_master"],
                 {"loss": (1e-10, 0.0), "w": (1e-8, 1e-12)}, traj="chain")
    assert got["mesh_loss"][-1] < got["mesh_loss"][0]
    # under RECTIPY_FUSED_ADAM=on a mesh fit takes the split optimizer: the
    # off fit, bit for bit
    for r in range(WORLD):
        on = C.load(rec.dir, "int8_master_on", r)
        np.testing.assert_array_equal(on["loss"], got["mesh_loss"])
        np.testing.assert_array_equal(on["w"], got["mesh_w"])


def test_public_run_and_fit_mesh_block_sparse_delay_edge_matches_single_device(rec):
    # tests/test_parallel.py:614: the run (rtol 1e-12) and the fit (rtol 1e-9)
    got = _check(rec, "block_delay", rec.refs["block_delay"],
                 {"out": (1e-12, 1e-14), "loss": (1e-9, 1e-12)}, traj="graph")
    assert got["mesh_loss"][-1] < got["mesh_loss"][0]


@pytest.mark.parametrize("case,traj", [("chain_readout", "chain"),
                                       ("chain_readout_autograd", "autograd")])
def test_fit_bptt_mesh_whole_prefix_and_readout(rec, case, traj):
    # a whole input node and a whole trained readout around the sharded
    # population, whose scalar tau trains too (its gradient summed over
    # model); the records of the last epoch run(mesh=)
    keys = ("loss", "out", "w", "tau", "wout")
    _check(rec, case, rec.refs[case], {k: (1e-9, 1e-12) for k in keys},
           self_tol={"w": 1e-15} if traj == "autograd" else None, traj=traj)


def test_fit_bptt_mesh_step_mode_and_remat(rec):
    # truncated BPTT with a population mean recorded (plain autograd on a
    # data 2 x model 2 mesh), and epoch mode in 10-step remat chunks
    keys = ("out", "v", "loss", "y", "w")
    _check(rec, "step_mode", rec.refs["step_mode"], {k: (1e-9, 1e-12) for k in keys},
           self_tol={"w": 1e-15}, traj="autograd")
    _check(rec, "remat", rec.refs["remat"], {"loss": (1e-9, 0.0), "w": (1e-9, 1e-12)},
           traj="chain")


@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_training_step_collective_budget(rec, n_model):
    # tests/test_parallel.py:459.  The JAX budget of one value-and-gradient of
    # the chain trajectory's loss: one all-gather and one all-reduce a step,
    # and one trajectory gather and the loss's all-reduce an epoch.  The
    # port's, counted by comm.tally at T = 8 and 16: one all-gather and one
    # all-reduce a step, and one all-gather (the outputs, for the loss) an
    # epoch -- the dW contracts the sources the forward gathered
    for r in range(n_model):
        b = C.load(rec.dir, "train_budget", r)
        g8, a8, o8 = b[f"m{n_model}_T8"].tolist()
        g16, a16, o16 = b[f"m{n_model}_T16"].tolist()
        per_step = ((g16 - g8) / 8, (a16 - a8) / 8)
        per_epoch = (g8 - 8 * per_step[0], a8 - 8 * per_step[1])
        assert per_step == (1, 1), (n_model, per_step)
        assert per_epoch == (1, 0), (n_model, per_epoch)  # JAX: (1, 1)
        assert o8 == o16 == 0


@pytest.mark.parametrize("case", ["batch_d1", "batch_d2"])
def test_batch_mesh_matches_single_device(rec, case):
    # tests/test_bptt_batch.py:259, data 1 (model 4) and data 2 (x model 2):
    # weights rtol 1e-12
    _check(rec, case, rec.refs["batch"], {"w": (1e-12, 1e-14), "loss": (1e-12, 1e-14)},
           traj="chain")


def test_fit_mesh_int8_master_rows_and_block_coupling(rec):
    # an int8_master ensemble on data 2 x model 2 (the cotangent rows'
    # scales a maximum over the ranks) and a population trained through its
    # block coupling on model 4 (each rank's block rows, every column block);
    # held to JAX at the port's own parity tolerances for these paths
    # (tests/test_torch_fit_bptt_batch.py, tests/test_torch_sparse_train.py)
    # dW rounded to float32 (int8_master's), over each data group's trials
    _check(rec, "batch_int8_master", rec.refs["batch_int8_master"],
           {"w": (1e-6, 1e-10), "loss": (1e-9, 0.0)}, self_tol={"w": 1e-8, "loss": 1e-11},
           traj="chain")
    _check(rec, "block_coupling", rec.refs["block_coupling"],
           {"loss": (1e-9, 0.0), "w": (1e-6, 1e-10)}, self_tol={"w": 1e-9}, traj="chain")


def test_multistart_mesh_matches_unsharded(rec):
    # tests/test_multistart.py:153: the starts over data 2, the population
    # over model 2; final losses and the written-back winner rtol 1e-9
    got = _check(rec, "multistart", rec.refs["multistart"],
                 {"final": (1e-9, 0.0), "w": (1e-9, 1e-12)}, traj="chain")
    assert int(got["mesh_best"][0]) == int(rec.refs["multistart"]["best"][0])


def test_multistart_mesh_indivisible_starts_warns_but_matches(rec):
    # tests/test_multistart.py:179: three starts on a data axis of two run
    # REPLICATED, with the warning
    _check(rec, "multistart_indivisible", rec.refs["multistart_indivisible"],
           {"final": (1e-9, 0.0), "w": (1e-9, 1e-12)})
    for r in range(WORLD):
        assert int(C.load(rec.dir, "multistart_warnings", r)["count"]) >= 1
