"""``run``/``run_batch(mesh=)`` of the port on four gloo ranks, for the mesh
cases outside ``tests/test_parallel.py``: input specs (``tests/
test_inputs.py``), spike rasters (``tests/test_record_spikes.py``), sweeps
with a shared drive (``tests/test_run_batch_sweep.py``), nodes with the
fused QIF and generic fused steps on a model axis of two (they run whole on
every rank), and a template with population reductions.

One spawn of four CPU ranks runs every case (``tests/_torch_parallel_
worker.py``).  Each case's records equal the port's run without a mesh bit
for bit, except the data-sharded spec batch (the trials' products run as
``(2, n)`` rows instead of ``(4, n)``: 1e-12, the reference test's
tolerance), are identical on every rank, and agree with the JAX package's
run at the reference test's tolerance; the spec cases are held against the
port's own run only, since the port's drive streams are torch generators.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parallel_cases as C
import rectipy_tpu as J
from rectipy_tpu import inputs as j_inputs
from rectipy_tpu.ops.generic_fused import attach_generic_fused_step as j_attach_generic
from rectipy_tpu.ops.kernels import attach_fused_qif_step as j_attach_qif
from rectipy_tpu.parallel import make_mesh as jmesh

WORLD = 4


def _jax_ns():
    from types import SimpleNamespace

    def net(dt, dtype="float64", feedback=False):
        cls = J.FeedbackNetwork if feedback else J.Network
        return cls(dt, dtype=getattr(jnp, dtype))

    return SimpleNamespace(net=net, inputs=j_inputs, attach_qif=j_attach_qif,
                           attach_generic=j_attach_generic)


JP = _jax_ns()


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    return C.spawn("runs", WORLD, tmp_path_factory.mktemp("runs"))


def _check(rec, case, ref=None, rtol=0.0, atol=0.0, exact=True):
    """The ranks' mesh records: identical on every rank, equal to the port's
    run without a mesh (bit for bit, or within ``rtol``/``atol`` where not
    ``exact``), and within ``rtol``/``atol`` of the JAX package's ``ref``."""
    recs = [C.load(rec, case, r) for r in range(WORLD)]
    keys = [k[5:] for k in recs[0] if k.startswith("mesh_")]
    for k in keys:
        got = recs[0][f"mesh_{k}"]
        if exact:
            np.testing.assert_array_equal(got, recs[0][f"ref_{k}"])
        else:
            np.testing.assert_allclose(got, recs[0][f"ref_{k}"], rtol=rtol, atol=atol)
        if ref is not None:
            np.testing.assert_allclose(got, np.asarray(ref[k]), rtol=rtol, atol=atol)
        for r in recs[1:]:
            np.testing.assert_array_equal(r[f"mesh_{k}"], got)
    return recs[0]


def test_run_mesh_matches_single_device(rec):
    # tests/test_inputs.py: a Pulse + Sine + Noise spec on a model axis of 4
    got = _check(rec, "spec_run")
    assert np.abs(got["mesh_out"]).max() > 0


def test_run_batch_mesh_data_sharded(rec):
    # tests/test_inputs.py: per-trial Noise seeds on a 2 x 2 mesh
    got = _check(rec, "spec_run_batch", rtol=1e-12, atol=1e-14, exact=False)
    assert got["mesh_out"].shape[0] == 4


def test_record_spikes_mesh_matches_single_device(rec):
    got = _check(rec, "spikes", C.spikes_run(JP, None), rtol=1e-12, atol=1e-12)
    assert got["mesh_spikes"].sum() > 0


def test_run_batch_sweep_under_mesh_matches_unsharded(rec):
    _check(rec, "sweep", C.sweep_run(JP, None), rtol=1e-6, atol=1e-7)


def test_fused_qif_node_on_model_axis_matches_jax_mesh(rec):
    # the JAX package's interpret-mode kernel under its make_mesh(2); the
    # port's node runs whole on the two model ranks of each data group
    ref = C.fused_qif_run(JP, jmesh(2), jax_interpret=True)
    got = _check(rec, "fused_qif", ref, rtol=1e-4, atol=1e-4)
    assert got["mesh_out"].max() > 0, "no spikes -- weak test"


def test_generic_fused_node_on_model_axis_matches_jax_mesh(rec):
    ref = C.generic_fused_run(JP, jmesh(2), jax_interpret=True)
    _check(rec, "generic_fused", ref, rtol=1e-4, atol=2e-4)


def test_population_reductions_on_model_axis_match_jax_mesh(rec):
    # iku: mean(v) and mean(spike) gather the population on each rank
    ref = C.reduction_run(JP, jmesh(2))
    got = _check(rec, "reduction", ref, rtol=1e-10, atol=1e-10)
    assert got["mesh_spikes"].sum() > 0


def test_population_reductions_collectives(rec):
    # a step gathers the coupling's source and the two reduced variables
    for r in range(WORLD):
        assert C.load(rec, "reduction_collectives", r)["counts"].tolist() == [3, 0]


def test_readout_and_replicated_trials(rec):
    # a sharded population into a node the model axis does not divide, over
    # 3 trials on a data axis of 2: the trials run replicated, with one
    # warning a rank
    _check(rec, "readout", C.readout_run(JP, None), rtol=1e-12, atol=1e-14)
    for r in range(WORLD):
        assert int(C.load(rec, "readout_warnings", r)["count"]) == 1
