"""The two-rank turns of ``chip_smoke.py`` phase 51 and the integer sums of a
shard's quantized products, on the CPU (the port only, no JAX).

``rectipy_tpu_torch.testing.mesh_quant_turns`` runs two gloo ranks in two
processes beside this one, which fits the same networks without a mesh, in
turns; here on CPU tensors at tiny widths (the launch counters count CUDA
launches only, so they go unchecked).  The float32 fits equal the fits
without a mesh bit for bit, but the 100k example's network's losses
(within rtol 1e-6: its ranks' rows of the loss's float32 sums).
"""

import numpy as np
import torch

from rectipy_tpu_torch.ops.quant import _psum_exact
from rectipy_tpu_torch.testing import MESH_QUANT_FITS, mesh_quant_turns

SIZES = dict(qif_n=256, qif_bs=16, qif_fan=32, qif_T=12, epochs=2, int4_n=64, int4_T=12, B=2,
             B_T=6)


class _ThreeRanks:
    """A model group of three whose other ranks hold ``others``: the sum
    in the tensor's own type, rank by rank."""

    size = 3

    def __init__(self, others):
        self.others = others

    def all_reduce(self, x):
        for o in self.others:
            x = x + o.to(x.dtype)
        return x


def test_psum_exact_adds_integer_sums_as_int32_past_2_24():
    # float32 partial sums 2^24, 1 and 1: summed in float32 rank by rank the
    # total loses both ones, as int32 it is 2^24 + 2, the unsharded sum
    part = torch.tensor([2.0 ** 24, 5.0])
    group = _ThreeRanks([torch.tensor([1.0, 1.0]), torch.tensor([1.0, -3.0])])
    total = _psum_exact(part, group)
    assert total.dtype == torch.float32
    np.testing.assert_array_equal(total.numpy(), [2.0 ** 24 + 2, 3.0])
    assert float(group.all_reduce(part)[0]) == 2.0 ** 24  # what float32 sums would give
    # below 2^24 the int32 sum is the float32 one
    np.testing.assert_array_equal(_psum_exact(torch.tensor([7.0, 5.0]), group).numpy(),
                                  [9.0, 3.0])


def test_mesh_quant_turns_on_two_gloo_cpu_ranks(tmp_path):
    tol = {"qif_sharded": {"loss": 1e-6}}
    reps = mesh_quant_turns(SIZES, str(tmp_path), tol=tol, timeout=120, device_type="cpu")
    assert tuple(reps) == MESH_QUANT_FITS
    steps = {"qif_sharded": 2 * 12, "int4_fit_bptt": 2 * 12, "int4_fit_bptt_batch": 6}
    for fit, rep in reps.items():
        assert len(rep["plain_s"]) == len(rep["mesh_s"]) == 2
        assert np.all(np.isfinite(rep["loss"]))
        assert all(v == 0.0 for k, v in rep["diffs"].items() if k != "loss"), (fit, rep["diffs"])
        for tally in rep["tally"]:  # both ranks: a gather a step, a scale and a sum a step
            assert tally == rep["tally"][0]
            assert tally["all-gather"]["count"] > steps[fit]
            assert tally["all-reduce"]["count"] >= 2 * steps[fit]
