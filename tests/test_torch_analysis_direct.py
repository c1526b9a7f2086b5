"""The port's ``lyapunov_direct`` against the JAX package's: the
two-trajectory exponent cases of ``tests/test_analysis.py``, float64 on the
CPU, the same network built by both packages.

The port loops the network's step in Python, so the runs are cut: 4,000
steps after a 1,000-step transient on the SCS network (the reference
40,000 and 10,000), 6,000 after 2,000 on the spiking ensemble (60,000 and
20,000).  Over the reference's lengths a chaotic run's float64 rounding,
summed in another order, parts the two packages' trajectories (measured:
0.116 against 0.134 at g = 3 over 40,000 steps); over the cut ones each
estimate equals JAX's within rtol 1e-6 (smooth) or 1e-6 absolute (the
spiking ensemble: identical spike times).  The reference's physics checks
need its lengths (they hold there for the JAX package, whose estimate the
port's equals); here the port's direct and tangent estimates must agree in
sign on both sides of the SCS transition.
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
SMOOTH = dict(rtol=1e-6, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The small CPU products of these runs take milliseconds each when
    PyTorch's thread pool is wider than one thread, microseconds on one."""
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


def _tanh_net(jax, n, W, tau=10.0, dt=1e-2):
    net = _new(jax, dt)
    net.add_diffeq_node("pop", TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", clear=True, verbose=False,
                        file_name="ana_tanh", node_vars={"all/li_op/tau": tau})
    return net


@pytest.mark.parametrize("g", [0.5, 3.0])
def test_lyapunov_direct_matches_tangent_on_smooth(g):
    """The two-trajectory method equals JAX's on the SCS network (N = 128),
    and the port's direct and tangent estimates agree in sign: contracting
    at g = 0.5, chaotic at g = 3."""
    n = 128
    rng = np.random.default_rng(1)
    W0 = rng.standard_normal((n, n)) / np.sqrt(n)
    y0 = rng.standard_normal(n) * 0.5
    jnet, pnet = _both(lambda jax: _tanh_net(jax, n, g * W0, tau=1.0))
    for net in (jnet, pnet):
        net.get_node("pop").reset(y=y0)
    kw = dict(steps=4_000, transient=1_000, seed=0)
    lam_d = PA.lyapunov_direct(pnet, **kw)
    np.testing.assert_allclose(lam_d, JA.lyapunov_direct(jnet, **kw), **SMOOTH)
    lam_t = PA.lyapunov_spectrum(pnet, steps=4_000, transient=1_000, y0=y0, seed=2)[0]
    assert np.sign(lam_d) == np.sign(lam_t) == (1 if g > 1 else -1), (g, lam_d, lam_t)


def test_lyapunov_direct_spiking_qif():
    """Full-network estimate through hard resets of a tonically firing QIF
    ensemble (n = 50): each estimate (two seeds, two renormalization
    intervals) equals JAX's and is finite."""
    n = 50
    etas = 3.0 + np.random.default_rng(0).normal(size=n)

    def build(jax):
        net = _new(jax, 1e-3)
        net.add_diffeq_node("qif", QIF_SFA, weights=np.zeros((n, n)),
                            source_var="s", target_var="s_in",
                            input_var="I_ext", output_var="s",
                            spike_var="spike", spike_def="v", op="qif_sfa_op",
                            spike_threshold=10.0, spike_reset=-10.0,
                            verbose=False, clear=True, file_name="ld_test",
                            node_vars={"all/qif_sfa_op/eta": etas})
        return net

    for kw in (dict(seed=0), dict(seed=1), dict(seed=0, renorm=200)):
        kw.update(steps=6_000, transient=2_000)
        lam = PA.lyapunov_direct(build(False), **kw)
        assert np.isfinite(lam)
        np.testing.assert_allclose(lam, JA.lyapunov_direct(build(True), **kw),
                                   rtol=0, atol=1e-6)
