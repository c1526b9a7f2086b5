"""The port's profiler and debugging helpers (``rectipy_tpu_torch.profiler``,
``rectipy_tpu_torch.debugging``) on the CPU: the cases of
``tests/test_coverage_extras.py`` (``test_profiler_helpers``,
``test_phase_timer_syncs_on_result_handle``) and
``tests/test_integration_extras.py`` (``test_debugging_helpers``), the
latter against the JAX package's report of the same poisoned network; a
trace written by ``trace()``; and ``enable_nan_checks`` raising at the
step where a NaN first enters the state.  The card's cases are in
``tests/test_torch_gpu.py``.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rectipy_tpu import Network as JNetwork
from rectipy_tpu.debugging import check_finite_state as j_check_finite_state
from rectipy_tpu_torch import Network
from rectipy_tpu_torch.debugging import check_finite_state, enable_nan_checks, find_nonfinite
from rectipy_tpu_torch.profiler import PhaseTimer, annotate, trace

TANH = "neuron_model_templates.rate_neurons.leaky_integrator.tanh"


def _rnn(jax, n=4):
    net = JNetwork(1e-2, dtype=jnp.float64) if jax else \
        Network(1e-2, dtype=torch.float64, device="cpu")
    net.add_diffeq_node("rnn", TANH, weights=np.zeros((n, n)), input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in")
    net.compile()
    return net


def test_profiler_helpers():
    timer = PhaseTimer()
    with timer.phase("build"):
        _ = torch.ones(10) * 2
    out = timer.time("sum", lambda: torch.ones(100).sum())
    assert float(out) == 100.0
    lines = []
    totals = timer.report(printer=lines.append)
    assert set(totals) == {"build", "sum"} and len(lines) == 2
    with annotate("region"):
        _ = torch.ones(3) + 1


def test_phase_timer_syncs_on_result_handle():
    timer = PhaseTimer()
    with timer.phase("work") as ph:
        ph.result = {"a": torch.ones(64).sum(), "b": [torch.zeros(2)]}
    assert timer.counts["work"] == 1
    with timer.phase("nohandle"):
        _ = torch.ones(3)
    assert timer.counts["nohandle"] == 1 and timer.totals["nohandle"] >= 0.0


def test_trace_writes_a_tensorboard_trace(tmp_path):
    """trace() writes a Chrome/TensorBoard trace file to log_dir, with the
    annotated region and a network run's operators in it."""
    net = _rnn(False)
    with trace(str(tmp_path)) as prof:
        with annotate("rectipy_region"):
            net.run(np.ones((5, 4)), verbose=False)
    files = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json*"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "rectipy_region" in names
    assert any(name and name.startswith("aten::") for name in names)
    assert any(e.key == "rectipy_region" for e in prof.key_averages())


def test_debugging_helpers():
    """check_finite_state reports the poisoned state leaf as JAX reports the
    same poisoned network; find_nonfinite counts per leaf."""
    net, jnet = _rnn(False), _rnn(True)
    assert check_finite_state(net) == {} == j_check_finite_state(jnet)
    y = net.get_node("rnn").y.clone()
    y[0] = float("nan")
    y[2] = float("inf")
    net.get_node("rnn").y = y
    jnet.get_node("rnn").y = jnet.get_node("rnn").y.at[0].set(jnp.nan).at[2].set(jnp.inf)
    with pytest.raises(FloatingPointError):
        check_finite_state(net)
    bad = check_finite_state(net, raise_on_failure=False)
    assert bad == j_check_finite_state(jnet, raise_on_failure=False) == {"state/nodes/rnn": 2}
    assert find_nonfinite({"x": torch.ones(3), "i": torch.arange(3), "f": 1.0}) == {}
    assert find_nonfinite({"a": np.array([np.nan, 1.0]), "t": (torch.tensor([np.inf]),)}) == \
        {"a": 1, "t/0": 1}


def test_enable_nan_checks_raises_at_the_first_nonfinite_step():
    """Inside enable_nan_checks a run raises FloatingPointError at the step
    where the state first turns non-finite (a NaN drive at step 7), and
    autograd's anomaly mode is on; outside, the same run returns NaN
    records and nothing is checked."""
    net = _rnn(False)
    inp = np.ones((12, 4))
    inp[7, 1] = np.nan
    assert not torch.is_anomaly_enabled()
    with enable_nan_checks():
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="at step 7"):
            net.run(inp, verbose=False)
    assert not torch.is_anomaly_enabled()
    out = _rnn(False).run(inp, verbose=False).to_numpy("out")
    assert np.isnan(out[8:]).any() and np.isfinite(out[:8]).all()
    with enable_nan_checks():  # a finite batched run passes the checks
        res = _rnn(False).run_batch(np.ones((2, 12, 4)), verbose=False)
    assert np.isfinite(res["out"]).all()
