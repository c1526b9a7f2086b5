"""The online trainers' and ``fit_es``'s ``mesh=`` against the JAX package,
on four gloo ranks, and ``tests/test_multiprocess.py``'s workload on two.

One spawn of four CPU ranks (``tests/_torch_parallel_worker.py``, group
``fits``, which imports the port only) runs ``fit_rls``, ``fit_eprop``,
``fit_stdp`` (dense, reward-modulated, block-sparse with homeostasis),
``fit_es`` and the run of a short-term plastic edge, each without a mesh and
on its mesh (``tests/_torch_parallel_train_cases.py``); a spawn of two ranks
(group ``two_process``) runs ``tests/_dcn_worker.py``'s ``run(mesh=)`` and
``fit_bptt(mesh=)`` over a mesh of both processes.  This process fits the
JAX package's networks without a mesh meanwhile.  Each case holds the mesh
records against the JAX fit at the tolerance of the JAX test it ports
(``tests/test_parallel.py``, ``tests/test_stdp.py``, ``tests/test_es.py``,
``tests/test_stp.py``, ``tests/test_multiprocess.py``; the sharded-readout
and reward cases, which no JAX test has, at the dense cases' tolerance),
against the port's own fit without a mesh (bit for bit, but the recorded
``w_mean`` and a sharded readout's summed losses, within 3e-16: sums of
the ranks' partial sums), and across the ranks (identical).  Model 4 where
the JAX tests take ``make_mesh(8)`` or ``make_mesh(4)``; data 2 x model 2
for ``fit_es``'s ``make_mesh(8, data=4)``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parallel_cases as C
import _torch_parallel_train_cases as TC
import rectipy_tpu as J

WORLD = 4


def _jax_ns():
    def net(dt, dtype="float64", feedback=False):
        cls = J.FeedbackNetwork if feedback else J.Network
        return cls(dt, dtype=getattr(jnp, dtype))

    return SimpleNamespace(net=net, torch=False, BlockSparseCoupling=J.BlockSparseCoupling)


JP = _jax_ns()
CASES = ("rls", "eprop", "rls_rows", "eprop_rows", "stdp_dense", "stdp_reward", "stdp_block",
         "es", "stp_run", "two_process")


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """The ranks' records and the JAX package's fits, made meanwhile."""
    tmp = tmp_path_factory.mktemp("fits")
    finish4 = C.start("fits", WORLD, tmp)
    finish2 = C.start("two_process", 2, tmp)
    refs = {name: getattr(TC, name)(JP, None) for name in CASES}
    return SimpleNamespace(dir=finish4(), two=finish2(), refs=refs)


def _check(folder, case, ref, tol, world=WORLD, self_tol=None):
    """The mesh records: identical on every rank, equal to the port's fit
    without a mesh (bit for bit, or within ``self_tol[key]``), and within
    ``tol[key] = (rtol, atol)`` of the JAX fit."""
    recs = [C.load(folder, case, r) for r in range(world)]
    got = recs[0]
    for key, (rtol, atol) in tol.items():
        mesh, own = got[f"mesh_{key}"], got[f"ref_{key}"]
        if self_tol and key in self_tol:
            np.testing.assert_allclose(mesh, own, rtol=0, atol=self_tol[key], err_msg=key)
        else:
            np.testing.assert_array_equal(mesh, own, err_msg=key)
        np.testing.assert_allclose(mesh, np.asarray(ref[key], dtype=np.float64), rtol=rtol,
                                   atol=atol, err_msg=key)
        for r in recs[1:]:
            np.testing.assert_array_equal(r[f"mesh_{key}"], mesh, err_msg=key)
    return got


@pytest.mark.parametrize("case", ["rls", "eprop", "rls_rows", "eprop_rows"])
def test_public_fit_rls_and_eprop_mesh_match_single_device(rec, case):
    # tests/test_parallel.py:351: the readout weights rtol 1e-9, atol 1e-12;
    # the *_rows cases shard a readout of four too
    rows = case.endswith("_rows")
    got = _check(rec.dir, case, rec.refs[case],
                 {"w": (1e-9, 1e-12), "out": (1e-9, 1e-12), "loss": (1e-9, 1e-12),
                  "y": (1e-9, 1e-12)}, self_tol={"loss": 3e-16} if rows else None)
    assert np.abs(got["mesh_w"]).max() > 0, f"{case} did not train"


@pytest.mark.parametrize("case", ["stdp_dense", "stdp_reward"])
def test_public_fit_stdp_mesh_matches_single_device(rec, case):
    # tests/test_parallel.py:387: the plastic weights rtol 1e-9, atol 1e-12
    # (the reward-modulated rule: the eligibility on the rows, the reward whole)
    keys = ("weights", "x_pre", "x_post", "w_mean", "w_min", "w_max", "out")
    got = _check(rec.dir, case, rec.refs[case], {k: (1e-9, 1e-12) for k in keys},
                 self_tol={"w_mean": 3e-16})
    assert np.abs(got["mesh_weights"] - got["mesh_w0"]).max() > 1e-5, "STDP did not move"


def test_fit_stdp_block_mesh_matches_single_device(rec):
    # tests/test_stdp.py:946: block rows over model 4, homeostasis every 50
    # steps; weights, traces and w_mean rtol 1e-12
    _check(rec.dir, "stdp_block", rec.refs["stdp_block"],
           {k: (1e-12, 0.0) for k in ("weights", "x_pre", "x_post", "w_mean")},
           self_tol={"w_mean": 3e-16})


def test_fit_es_under_mesh_matches_unsharded_losses(rec):
    # tests/test_es.py:183: candidates over data 2, the population over model
    # 2; generation losses rtol 1e-4, eta rtol 1e-3
    _check(rec.dir, "es", rec.refs["es"], {"hist": (1e-4, 0.0), "eta": (1e-3, 1e-5)})


def test_stp_run_under_mesh_matches_single_device(rec):
    # tests/test_stp.py:233: the (u, x) carry of a LinearSTP edge into a
    # sharded population; rtol 1e-7, atol 1e-10
    _check(rec.dir, "stp_run", rec.refs["stp_run"], {"out": (1e-7, 1e-10)})


def test_two_process_global_mesh_matches_single_process(rec):
    # tests/test_multiprocess.py:60: two processes over one mesh agree with
    # each other bit for bit and with the single-process fit (rtol 1e-9)
    _check(rec.two, "two_process", rec.refs["two_process"],
           {"trace": (1e-9, 1e-12), "losses": (1e-9, 0.0)}, world=2)
