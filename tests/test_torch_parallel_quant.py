"""The quantized couplings and the edges into a population shard on a model
axis above one, against the JAX package: ``int4_master`` and block
``int8_master`` couplings, ``int8_master`` block edges and diagonal gains,
trained with ``mesh=`` on four gloo ranks.

One spawn of four CPU ranks (``tests/_torch_parallel_worker.py``, group
``quant``, which imports the port only) runs every case of
``_torch_parallel_train_cases.QUANT_CASES`` without a mesh, on model 4 and
on data 2 x model 2, while this process fits the JAX package's network
without a mesh and on ``make_mesh(8)`` (its 8-device CPU mesh: the JAX
package takes each case on a mesh).  Each mesh fit is held

- against the JAX package's fit without a mesh, at the tolerances of the
  JAX package's own mesh tests (``tests/test_parallel.py:421-457`` and
  ``:506-538``: losses rtol 1e-10, weights rtol 1e-8, atol 1e-12), but
  where the port's fit without a mesh is further from JAX's, by the
  summation order of its float32 master gradients: the ensembles' (weights
  rtol 1e-6, atol 1e-10, as ``tests/test_torch_parallel_train.py``'s
  ``int8_master`` ensemble case), the block ``int8_master`` coupling's
  (rtol 1e-6, atol 1e-6: the port's fit without a mesh is 1.0e-7 from
  JAX's at one small weight, inside
  ``tests/test_torch_sparse_train.py``'s 1e-4 of the largest), the
  example's blocks (rtol 1e-8, atol 1e-10: 3.4e-11 at most) and the
  ``int8_master`` block edge's (its frozen run rtol 1e-12 and losses rtol
  1e-9, as ``tests/test_parallel.py:614``, weights rtol 1e-6, atol 1e-8:
  3.6e-9 at most);
- against the JAX package's ``make_mesh(8)`` fit, at the same tolerances
  (JAX's mesh fits equal its unsharded ones within them);
- against the port's fit without a mesh: bit for bit (the chain and graph
  trajectories, plain autograd and step mode alike), but the ensemble's
  weights on data 2 (within 1e-8: each data group's float32 ``dW`` over its
  own trials) and the diagonal gains at model 4 (within 1e-15: after four
  adam epochs one gain parts by 1.1e-16 where a rank holds 4 of the 16
  rows, while the loss and the coupling stay bit for bit; the same fit
  under SGD, and the gains at data 2 x model 2, are bit for bit; which
  operation parts the last bit is not known);
- across the ranks: identical.

The collective budget of one value-and-gradient of the quantized chain
trajectory is counted as ``tests/test_torch_parallel_train.py`` counts the
float one, and that of the 100k example's graph trajectory from two
one-epoch fits.  The ``int4`` block coupling stays refused, in both packages.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parallel_cases as C
import _torch_parallel_train_cases as TC
import rectipy_tpu as J
from rectipy_tpu.ops.sparse import block_random_connectivity
from rectipy_tpu.parallel import make_mesh

WORLD = 4
JP = SimpleNamespace(
    net=lambda dt, dtype="float64", feedback=False: (
        J.FeedbackNetwork if feedback else J.Network)(dt, dtype=getattr(jnp, dtype)),
    torch=False, BlockSparseCoupling=J.BlockSparseCoupling,
    block_random_connectivity=block_random_connectivity)

EXACT = {"loss": (1e-10, 0.0), "w": (1e-8, 1e-12)}
F32_DW = {"loss": (1e-10, 0.0), "w": (1e-6, 1e-10)}
BLOCK_DW = {"loss": (1e-10, 0.0), "w": (1e-6, 1e-6)}
# case: (JAX tolerances per record, the port's own mesh-vs-unsharded
# tolerances per layout, the trajectory)
CASES = {
    "int4_master": (EXACT, {}, "chain"),
    "int4_master_autograd": (EXACT, {}, "autograd"),
    "int4_master_steps": (EXACT, {}, "chain"),
    "batch_int4_master": (F32_DW, {"_d2": {"w": 1e-8}}, "chain"),
    "multistart_int4_master": ({"final": (1e-10, 0.0), "w": (1e-6, 1e-10)}, {}, "chain"),
    "block_int8_master": (BLOCK_DW, {}, "chain"),
    "block_int8_master_autograd": (BLOCK_DW, {}, "autograd"),
    "qif_sharded": ({"loss": (1e-10, 0.0), "w": (1e-8, 1e-10), "gains": (1e-8, 1e-12)}, {},
                    "graph"),
    "block_edge_int8": ({"out": (1e-12, 1e-14), "loss": (1e-9, 0.0), "w": (1e-6, 1e-8)}, {},
                        "graph"),
    "diag_gains": ({**EXACT, "g_in": (1e-8, 1e-12), "g_fb": (1e-8, 1e-12)},
                   {"": {"g_in": 1e-15, "g_fb": 1e-15}}, "graph"),
    "diag_gains_steps": ({**EXACT, "g_in": (1e-8, 1e-12), "g_fb": (1e-8, 1e-12)}, {}, "graph"),
}
assert tuple(CASES) == TC.QUANT_CASES


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """The ranks' records, and the JAX package's fits made meanwhile."""
    finish = C.start("quant", WORLD, tmp_path_factory.mktemp("quant"))
    refs, meshed = {}, {}
    for name in CASES:
        with TC.fused_adam_env("off"):
            refs[name] = getattr(TC, name)(JP, None)
            meshed[name] = getattr(TC, name)(JP, make_mesh(8))
    return SimpleNamespace(dir=finish(), refs=refs, meshed=meshed)


@pytest.mark.parametrize("layout", ["", "_d2"], ids=["model4", "data2_model2"])
@pytest.mark.parametrize("case", list(CASES))
def test_quantized_mesh_fit_matches_jax_and_unsharded(rec, case, layout):
    tol, self_tol, traj = CASES[case]
    self_tol = self_tol.get(layout, {})
    recs = [C.load(rec.dir, case + layout, r) for r in range(WORLD)]
    got = recs[0]
    assert str(got["mesh_traj"]) == str(got["ref_traj"]) == traj
    for key, (rtol, atol) in tol.items():
        mesh, own = got[f"mesh_{key}"], got[f"ref_{key}"]
        if key in self_tol:
            np.testing.assert_allclose(mesh, own, rtol=0, atol=self_tol[key], err_msg=key)
        else:
            np.testing.assert_array_equal(mesh, own, err_msg=key)
        for ref in (rec.refs[case], rec.meshed[case]):
            np.testing.assert_allclose(mesh, np.asarray(ref[key]), rtol=rtol, atol=atol,
                                       err_msg=key)
        for r in recs[1:]:
            np.testing.assert_array_equal(r[f"mesh_{key}"], mesh, err_msg=key)


@pytest.mark.parametrize("kind", ["int4_master", "block_int8_master"])
def test_quantized_training_step_collective_budget(rec, kind):
    # one value-and-gradient of the quantized chain trajectory, counted at
    # T = 8 and 16: one all-gather a step (the source, forward) and two
    # all-reduces a step (the cotangent's scale, a maximum, and the ranks'
    # integer sums, whole afterwards: the source's gather sums nothing
    # more); one all-gather an epoch (the outputs, for the loss)
    for k in (2, 4):
        for r in range(k):
            b = C.load(rec.dir, "quant_budget", r)
            g8, a8, o8 = b[f"{kind}_m{k}_T8"].tolist()
            g16, a16, o16 = b[f"{kind}_m{k}_T16"].tolist()
            per_step = ((g16 - g8) / 8, (a16 - a8) / 8)
            assert per_step == (1, 2), (kind, k, per_step)
            assert (g8 - 8 * per_step[0], a8 - 8 * per_step[1]) == (1, 0), (kind, k)
            assert o8 == o16 == 0


def test_graph_trajectory_collective_budget_of_the_example(rec):
    # one-epoch fits of the 100k example's network (N = 64, float64) at
    # T = 8 and 16: a step gathers the population once (the block
    # coupling's source, N float64 values) and all-reduces twice (the
    # coupling's cotangent scale, one float64, and its integer sums, N
    # int32 values); the delayed diagonal gains read the rank's own rows,
    # with no collective; the loss's outputs add N float64 values a step
    n = 64
    for k in (2, 4):
        for r in range(k):
            b = C.load(rec.dir, "quant_budget", r)
            g8, a8, o8, gb8, ab8 = b[f"qif_sharded_m{k}_T8"].tolist()
            g16, a16, o16, gb16, ab16 = b[f"qif_sharded_m{k}_T16"].tolist()
            per_step = ((g16 - g8) / 8, (a16 - a8) / 8, (gb16 - gb8) / 8, (ab16 - ab8) / 8)
            assert per_step == (1, 2, 2 * n * 8, 8 + n * 4), (k, r, per_step)
            # an epoch: the outputs for the loss, the trained blocks and
            # gains gathered at the end, and no gradient all-reduced
            assert (g8 - 8, a8 - 16) == (3, 0), (k, r)
            assert o8 == o16 == 0


def test_int4_block_coupling_refused_by_both_packages():
    # an int4 coupling is dense-only in both packages (dsl/lower.py), with
    # or without a mesh
    A = block_random_connectivity(32, 32, 8, block_size=4, seed=3)
    P = C.torch_ns()
    for ns in (JP, P):
        for dtype in ("int4", "int4_master"):
            with pytest.raises(NotImplementedError, match="dense-only"):
                C._rnn(ns, A if ns is JP else P.block_random_connectivity(
                    32, 32, 8, block_size=4, seed=3), coupling_dtype=dtype)
