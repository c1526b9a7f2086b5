"""The port's limit-cycle analyses against the JAX package's: the
Wilson-Cowan cases of ``tests/test_analysis.py`` (the neutral and
contracting Lyapunov exponents of the cycle, its period and Floquet
multipliers, and the refusal of an equilibrium), float64 on the CPU, the
same network built by both packages.

The port loops the node's integrator map in Python, so the cycle runs at
dt 0.1 for 6,000-10,000 steps where the reference runs dt 0.01 for
100,000-250,000 (the same span of time).  Each call is the same call on
both sides.  Tolerances: rtol 1e-6 against JAX (float64 sums in another
order); the reference's physics checks on the port's results (at dt 0.1
the second exponent reads -0.049, so it is held below -0.04), and the
Floquet exponent against the second Lyapunov exponent within rtol 0.1.
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
WC = "rectipy_tpu.models.rate_neurons.wilson_cowan.wc"
SMOOTH = dict(rtol=1e-6, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The small CPU products and reverse passes of these runs take
    milliseconds each when PyTorch's thread pool is wider than one thread,
    microseconds on one."""
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


def _tanh_net(n, tau):
    net = _new(False, 1e-2)
    net.add_diffeq_node("pop", TANH, weights=np.zeros((n, n)), input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", node_vars={"all/li_op/tau": tau})
    return net


def _wc_net(jax):
    net = _new(jax, 1e-1)
    net.add_diffeq_node("wc", WC, weights=np.zeros((1, 1)), source_var="e",
                        target_var="r_in", input_var="I_ext", output_var="e",
                        verbose=False, clear=True, file_name="lyap_wc",
                        node_vars={"all/wc_op/I_ext": 1.25})
    return net


def test_lyapunov_limit_cycle_neutral_direction():
    """On the Wilson-Cowan limit cycle the leading exponent is ~0 (neutral
    along the flow) and the second negative (dt 0.1: 6,000 steps span the
    reference's 200,000 of dt 0.01 in time, less its transient)."""
    jnet, pnet = _both(_wc_net)
    kw = dict(k=2, steps=6_000, transient=2_000, inputs=1.25, seed=3)
    lam = PA.lyapunov_spectrum(pnet, **kw)
    np.testing.assert_allclose(lam, JA.lyapunov_spectrum(jnet, **kw), **SMOOTH)
    assert abs(lam[0]) < 0.02 and lam[1] < -0.04, lam


def test_limit_cycle_wilson_cowan_floquet():
    """WC oscillator (dt 0.1): period and Floquet multipliers equal JAX's
    (the neutral one ~1, the second inside the unit circle); both
    coordinates see the same period; the contracting Floquet exponent
    matches the second Lyapunov exponent (rtol 0.1)."""
    jnet, pnet = _both(_wc_net)
    kw = dict(steps=6_000, transient=4_000, inputs=1.25)
    lc = PA.limit_cycle(pnet, **kw)
    jlc = JA.limit_cycle(jnet, **kw)
    np.testing.assert_allclose(lc["period"], jlc["period"], **SMOOTH)
    np.testing.assert_allclose(lc["y_star"], np.asarray(jlc["y_star"]), **SMOOTH)
    np.testing.assert_allclose(lc["multipliers"], jlc["multipliers"], **SMOOTH)
    np.testing.assert_allclose(lc["exponents"], jlc["exponents"], rtol=1e-6, atol=1e-8)
    m = lc["multipliers"]
    assert lc["y_star"].shape == (2,) and lc["period"] > 0
    assert abs(m[0] - 1.0) < 0.02 and abs(m[1]) < 0.95, m
    other = 1 - int(np.argmax(np.abs(lc["y_star"] - lc["y_star"].mean())) == 0)
    np.testing.assert_allclose(PA.limit_cycle(pnet, coord=other, **kw)["period"], lc["period"],
                               rtol=1e-3)
    lam = PA.lyapunov_spectrum(pnet, k=2, steps=10_000, transient=2_000, inputs=1.25, seed=3)
    np.testing.assert_allclose(lc["exponents"][1], lam[1], rtol=0.1)


def test_limit_cycle_rejects_equilibrium():
    n = 2
    net = _tanh_net(n, tau=5.0)
    with pytest.raises(RuntimeError, match="equilibrium|mean-crossings"):
        PA.limit_cycle(net, steps=2_000, transient=2_000, inputs=0.5)
