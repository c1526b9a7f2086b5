"""The port's trajectory analyses against the JAX package's: the Lyapunov
spectrum, limit cycles and the direct two-trajectory exponent of
``tests/test_analysis.py``, float64 on the CPU, the same network built by
both packages.

The port loops the node's integrator map (or the network's step) in
Python, so some long runs of the reference tests are cut here: the SCS
spectra take 2,000-4,000 steps (the reference 20,000-40,000).  Each call is the same call
on both sides, and the reference's physics checks run on the port's
results where the cut length still resolves them.  The Wilson-Cowan
limit cycle is in ``tests/test_torch_analysis_cycles.py``,
``lyapunov_direct`` in ``tests/test_torch_analysis_direct.py``.  Tolerances: linear systems rtol 1e-9 (and their exact
discrete rates); the smooth trajectories rtol 1e-6 (float64 sums in
another order, grown by the positive exponent over the run); the spiking
ensemble's exponent within 1e-6 absolute (identical spike times).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rectipy_tpu.analysis as JA
import rectipy_tpu_torch.analysis as PA
from rectipy_tpu import Network as JNetwork
from rectipy_tpu_torch import Network

TANH = "neuron_model_templates.rate_neurons.leaky_integrator.tanh"
QIF_SFA = "rectipy_tpu.models.spiking_neurons.qif.qif_sfa"
LINEAR = dict(rtol=1e-9, atol=0.0)
SMOOTH = dict(rtol=1e-6, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests step small states thousands of times: PyTorch's CPU
    products and reverse passes of a 128-wide state take milliseconds each
    when its thread pool is wider than one thread, microseconds on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _new(jax: bool, dt: float):
    if jax:
        return JNetwork(dt, dtype=jnp.float64)
    return Network(dt, dtype=torch.float64, device="cpu")


def _both(build):
    return build(True), build(False)


def _tanh_net(jax, n, W, tau=10.0, dt=1e-2, **kw):
    net = _new(jax, dt)
    net.add_diffeq_node("pop", TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", clear=True, verbose=False,
                        file_name="ana_tanh", node_vars={"all/li_op/tau": tau}, **kw)
    return net


def test_lyapunov_linear_system_exact():
    """Uncoupled LI is linear: every exponent equals log(1 - dt/tau)/dt,
    whatever the tangent seed."""
    n, tau = 4, 10.0
    jnet, pnet = _both(lambda jax: _tanh_net(jax, n, np.zeros((n, n)), tau=tau))
    expect = np.log(1.0 - pnet.dt / tau) / pnet.dt
    for seed in (1, 7):
        kw = dict(k=3, steps=500, reorth=5, y0=np.ones(n), seed=seed)
        lam = PA.lyapunov_spectrum(pnet, **kw)
        np.testing.assert_allclose(lam, expect, rtol=1e-9)
        np.testing.assert_allclose(lam, JA.lyapunov_spectrum(jnet, **kw), **LINEAR)


@pytest.mark.parametrize("g, steps, transient", [(0.5, 2000, 500), (3.0, 4000, 1000)])
def test_lyapunov_scs_chaos_transition(g, steps, transient):
    """Sompolinsky-Crisanti-Sommers: x' = -x + g W tanh(x), W ~ N(0, 1/N),
    contracts for g < 1 (lambda_max ~ -(1 - g)); at g = 3 the leading
    exponent is positive.  N = 128."""
    n = 128
    rng = np.random.default_rng(1)
    W0 = rng.standard_normal((n, n)) / np.sqrt(n)
    y0 = rng.standard_normal(n) * 0.5
    jnet, pnet = _both(lambda jax: _tanh_net(jax, n, g * W0, tau=1.0))
    kw = dict(steps=steps, transient=transient, y0=y0, seed=2)
    lam = PA.lyapunov_spectrum(pnet, **kw)
    np.testing.assert_allclose(lam, JA.lyapunov_spectrum(jnet, **kw), **SMOOTH)
    if g < 1:
        assert lam[0] < -0.2
    else:
        assert lam[0] > 0.0


def test_lyapunov_validates_and_caches():
    """Validation errors; repeated calls with new inputs equal JAX's (its
    program-cache count has no counterpart)."""
    n = 3
    jnet, pnet = _both(lambda jax: _tanh_net(jax, n, np.zeros((n, n))))
    with pytest.raises(ValueError, match="state dimension"):
        PA.lyapunov_spectrum(pnet, k=n + 1)
    with pytest.raises(ValueError, match="reorth"):
        PA.lyapunov_spectrum(pnet, steps=5, reorth=10)
    with pytest.warns(UserWarning, match="steps % reorth"):
        PA.lyapunov_spectrum(pnet, k=1, steps=105, reorth=10)
    for inputs in (None, 0.3):
        kw = dict(k=1, steps=100, reorth=10, inputs=inputs)
        np.testing.assert_allclose(PA.lyapunov_spectrum(pnet, **kw),
                                   JA.lyapunov_spectrum(jnet, **kw), **LINEAR)


def test_analysis_program_cache_shared_dict():
    """A fixed point after a Lyapunov estimate on the same node (the JAX
    package's cache-sharing regression): equal to JAX's and exact."""
    n = 2
    jnet, pnet = _both(lambda jax: _tanh_net(jax, n, np.zeros((n, n)), tau=5.0))
    PA.lyapunov_spectrum(pnet, k=1, steps=100, reorth=10)
    y_star = PA.fixed_point(pnet, inputs=0.2)
    np.testing.assert_allclose(y_star.numpy(), np.full(n, 1.0), rtol=1e-8)
    np.testing.assert_allclose(y_star.numpy(), np.asarray(JA.fixed_point(jnet, inputs=0.2)),
                               rtol=1e-9)


def test_trajectory_analysis_respects_node_integrator():
    """lyapunov_spectrum propagates the node's OWN integrator map (rk4): the
    linear LI system makes the discrete multiplier exact."""
    n, tau, dt = 3, 2.0, 1e-1
    jnet, pnet = _both(lambda jax: _tanh_net(jax, n, np.zeros((n, n)), tau=tau, dt=dt,
                                             integrator="rk4"))
    kw = dict(k=2, steps=200, reorth=5, y0=np.ones(n))
    lam = PA.lyapunov_spectrum(pnet, **kw)
    h = dt / tau
    mult_rk4 = 1 - h + h ** 2 / 2 - h ** 3 / 6 + h ** 4 / 24
    np.testing.assert_allclose(lam, np.log(mult_rk4) / dt, rtol=1e-9)
    np.testing.assert_allclose(lam, JA.lyapunov_spectrum(jnet, **kw), **LINEAR)
    assert abs(lam[0] - np.log(1 - h) / dt) > 1e-4
