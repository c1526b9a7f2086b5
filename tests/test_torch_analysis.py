"""The port's ``analysis`` against the JAX package's: the point analyses of
``tests/test_analysis.py`` (Jacobians, Newton fixed points, stability, phase
planes, basins and the validations), float64 on the CPU, the same network
built by both packages.  Tolerances: Jacobians and vector fields rtol
1e-12 (the same arithmetic); Newton fixed points and eigenvalues rtol 1e-9
(LAPACK solves of the same systems, iterated); basin endpoints rtol 1e-9
after 4,000 map steps.  The JAX package's program-cache assertions have no
counterpart: the port compiles nothing, so it caches nothing; those cases
hold the values of repeated calls instead.  The trajectory analyses are in
``tests/test_torch_analysis_traj.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rectipy_tpu.analysis as JA
import rectipy_tpu_torch.analysis as PA
from rectipy_tpu import FeedbackNetwork as JFeedbackNetwork
from rectipy_tpu import Network as JNetwork
from rectipy_tpu_torch import FeedbackNetwork, Network

TANH = "neuron_model_templates.rate_neurons.leaky_integrator.tanh"
MPR = "rectipy_tpu.models.mean_field.montbrio.mpr"
WC = "rectipy_tpu.models.rate_neurons.wilson_cowan.wc"
FHN = "rectipy_tpu.models.rate_neurons.fhn.fhn"
QIF_SFA = "rectipy_tpu.models.spiking_neurons.qif.qif_sfa"
EXACT = dict(rtol=1e-12, atol=1e-12)
NEWTON = dict(rtol=1e-9, atol=1e-12)


def _new(jax: bool, dt: float, cls=None):
    if jax:
        return (cls or JNetwork)(dt, dtype=jnp.float64)
    return (cls or Network)(dt, dtype=torch.float64, device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(build):
    """``build(jax)`` for both packages: ``(jax_net, port_net)``."""
    return build(True), build(False)


def _tanh_net(jax, n, W, tau=10.0, k=1.0, **kw):
    net = _new(jax, 1e-2)
    net.add_diffeq_node("pop", TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", clear=True, verbose=False,
                        file_name="ana_tanh",
                        node_vars={"all/li_op/tau": tau, "all/li_op/k": k}, **kw)
    return net


def _mpr_net(jax, eta, J):
    net = _new(jax, 1e-4)
    net.add_diffeq_node("mpr", MPR, weights=np.zeros((1, 1)), input_var="I_ext",
                        output_var="r", source_var="r", target_var="r_in",
                        op="mpr_op", verbose=False, clear=True, file_name="ana_mpr",
                        node_vars={"all/mpr_op/eta": eta, "all/mpr_op/J": J})
    return net


def _wc_net(jax, dt=1e-1):
    net = _new(jax, dt)
    net.add_diffeq_node("wc", WC, weights=np.zeros((1, 1)), source_var="e",
                        target_var="r_in", input_var="I_ext", output_var="e",
                        verbose=False, clear=True, file_name="ana_wc",
                        node_vars={"all/wc_op/I_ext": 1.25})
    return net


def _fhn_net(jax):
    net = _new(jax, 1e-2)
    net.add_diffeq_node("fhn", FHN, weights=np.zeros((1, 1)), source_var="v",
                        target_var="r_in", input_var="I_ext", output_var="v",
                        verbose=False, clear=True, file_name="pp_fhn")
    return net


def test_jacobian_matches_analytic_tanh():
    """v' = -v/tau + k W tanh(v) + I  =>  J = -I/tau + k W diag(sech^2 v)."""
    n = 5
    rng = np.random.default_rng(3)
    W = rng.standard_normal((n, n)) * 0.3
    jnet, pnet = _both(lambda jax: _tanh_net(jax, n, W, tau=7.0, k=1.3))
    y = rng.standard_normal(n)
    got = _np(PA.jacobian(pnet, y=y))
    J_ref = -np.eye(n) / 7.0 + 1.3 * W * (1.0 / np.cosh(y) ** 2)[None, :]
    np.testing.assert_allclose(got, J_ref, **EXACT)
    np.testing.assert_allclose(got, _np(JA.jacobian(jnet, y=y)), **EXACT)


def test_autonomous_field_holds_input_constant():
    n = 3
    jnet, pnet = _both(lambda jax: _tanh_net(jax, n, np.zeros((n, n)), tau=5.0))
    for inputs in (2.0, np.asarray([1.0, 2.0, 3.0])):
        f, y = PA.autonomous_field(pnet, inputs=inputs)
        jf, _ = JA.autonomous_field(jnet, inputs=inputs)
        got = _np(f(torch.zeros(n, dtype=torch.float64)))
        np.testing.assert_allclose(got, np.broadcast_to(inputs, (n,)), **EXACT)
        np.testing.assert_allclose(got, _np(jf(jnp.zeros(n))), **EXACT)
        assert tuple(y.shape) == (n,)


def test_fixed_point_linear_system_exact():
    """Uncoupled LI: y* = tau * I exactly."""
    n = 4
    jnet, pnet = _both(lambda jax: _tanh_net(jax, n, np.zeros((n, n)), tau=9.0))
    y_star = _np(PA.fixed_point(pnet, inputs=0.5))
    np.testing.assert_allclose(y_star, np.full(n, 4.5), rtol=1e-9)
    np.testing.assert_allclose(y_star, _np(JA.fixed_point(jnet, inputs=0.5)), **NEWTON)
    eigs = PA.stability(pnet, y=y_star, inputs=0.5)
    np.testing.assert_allclose(eigs.real, -1.0 / 9.0, rtol=1e-9)
    np.testing.assert_allclose(eigs, JA.stability(jnet, y=y_star, inputs=0.5), **NEWTON)


@pytest.mark.parametrize("eta, J, kind", [(-5.0, 15.0, "node"), (5.0, 0.0, "focus")])
def test_montbrio_node_vs_focus_classification(eta, J, kind):
    """MPR rest state at (eta=-5, J=15) a stable NODE, at (eta=5, J=0) a
    stable FOCUS: fixed point and eigenvalues against JAX, the node's
    against the closed form; then 3,000 steps of the ringing around the
    focus (run from 1.2 r*) against JAX's run (rtol 1e-9)."""
    jnet, pnet = _both(lambda jax: _mpr_net(jax, eta, J))
    y_star = PA.fixed_point(pnet, damping=0.7)
    np.testing.assert_allclose(_np(y_star), _np(JA.fixed_point(jnet, damping=0.7)), **NEWTON)
    f, _ = PA.autonomous_field(pnet)
    assert float(f(y_star).abs().max()) < 1e-9
    eigs = PA.stability(pnet, y=y_star)
    np.testing.assert_allclose(eigs, JA.stability(jnet, y=_np(y_star)), **NEWTON)
    r_star, v_star = float(y_star[0]), float(y_star[1])
    assert r_star > 0 and np.all(eigs.real < 0)
    if kind == "node":
        assert J > 2 * np.pi ** 2 * r_star and np.all(np.abs(eigs.imag) < 1e-9)
        disc = np.sqrt(2 * r_star * (J - 2 * np.pi ** 2 * r_star))
        np.testing.assert_allclose(sorted(eigs.real),
                                   sorted([2 * v_star - disc, 2 * v_star + disc]), rtol=1e-8)
        return
    assert float(np.abs(eigs[0].imag)) > 1.0
    y_ring = _np(y_star) * np.asarray([1.2, 1.0])
    pnet.get_node("mpr").reset(y=y_ring)
    jnet.get_node("mpr").reset(y=y_ring)
    inp = np.zeros((3000, 1))
    got = pnet.run(inp, sampling_steps=10, verbose=False).to_numpy("out")
    want = jnet.run(inp, sampling_steps=10, verbose=False).to_numpy("out")
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_wilson_cowan_unstable_focus_inside_limit_cycle():
    """WC at the oscillatory drive: damped Newton from a mid-cycle state (a
    2,000-step run) finds the interior fixed point, whose leading
    eigenvalues have POSITIVE real part."""
    jnet, pnet = _both(_wc_net)
    for net in (jnet, pnet):
        net.run(np.full((2000, 1), 1.25), verbose=False, record_output=False)
    np.testing.assert_allclose(_np(pnet.get_node("wc").y), _np(jnet.get_node("wc").y),
                               rtol=1e-10)
    y_star = PA.fixed_point(pnet, inputs=1.25, damping=0.5, max_iter=300)
    j_star = JA.fixed_point(jnet, inputs=1.25, damping=0.5, max_iter=300)
    np.testing.assert_allclose(_np(y_star), _np(j_star), **NEWTON)
    eigs = PA.stability(pnet, y=y_star, inputs=1.25)
    assert eigs[0].real > 0, f"expected an unstable fixed point, got {eigs}"
    np.testing.assert_allclose(eigs, JA.stability(jnet, y=j_star, inputs=1.25), **NEWTON)


def test_resolve_node_errors():
    n = 2
    net = _tanh_net(False, n, np.zeros((n, n)))
    net.add_func_node("out", n, activation_function="identity")
    net.add_edge("pop", "out")
    # the unique diffeq node still resolves despite the func node
    assert tuple(PA.jacobian(net).shape) == (n, n)
    net2 = Network(1e-2, device="cpu")
    net2.add_func_node("a", n, activation_function="identity")
    with pytest.raises(ValueError, match="0 differential-equation"):
        PA.jacobian(net2)


def test_open_loop_guard_for_edge_coupled_nodes():
    """A node whose recurrence arrives through a graph/feedback edge refuses
    analysis unless open_loop=True is passed deliberately; then the edge
    coupling is absent, as in JAX."""
    n = 3

    def build(jax):
        net = _new(jax, 1e-2, JFeedbackNetwork if jax else FeedbackNetwork)
        net.add_diffeq_node("pop", TANH, weights=np.zeros((n, n)),
                            input_var="li_op/I_ext", output_var="li_op/v",
                            source_var="tanh_op/r", target_var="li_op/r_in",
                            clear=True, verbose=False, file_name="ana_guard")
        net.add_edge("pop", "pop", feedback=True, weights=np.eye(n) * 0.9)
        return net

    jnet, pnet = _both(build)
    with pytest.raises(ValueError, match="OPEN-LOOP"):
        PA.jacobian(pnet)
    got = _np(PA.jacobian(pnet, open_loop=True))
    np.testing.assert_allclose(got, -np.eye(n) / 10.0, atol=1e-12)
    np.testing.assert_allclose(got, _np(JA.jacobian(jnet, open_loop=True)), **EXACT)

    net2 = Network(1e-2, device="cpu")
    net2.add_func_node("inp", n, activation_function="identity")
    net2.add_diffeq_node("pop", TANH, weights=np.zeros((n, n)),
                         input_var="li_op/I_ext", output_var="li_op/v",
                         source_var="tanh_op/r", target_var="li_op/r_in",
                         clear=True, verbose=False, file_name="ana_guard2")
    net2.add_edge("inp", "pop")
    with pytest.raises(ValueError, match="OPEN-LOOP"):
        PA.fixed_point(net2, node="pop")


def test_fixed_point_programs_cached_per_node():
    """A continuation (repeated fixed_point calls with new inputs): each
    point equals JAX's.  (JAX's program-cache count has no counterpart.)"""
    n = 2
    jnet, pnet = _both(lambda jax: _tanh_net(jax, n, np.zeros((n, n)), tau=5.0))
    for inp in (0.1, 0.7):
        np.testing.assert_allclose(_np(PA.fixed_point(pnet, inputs=inp)),
                                   _np(JA.fixed_point(jnet, inputs=inp)), **NEWTON)
    assert not hasattr(pnet.get_node("pop"), "_analysis_programs")


def test_phase_plane_fhn_closed_form():
    """FHN grid field matches the closed form and JAX's; the v-nullcline's
    zero contour changes sign across the cubic."""
    jnet, pnet = _both(_fhn_net)
    kw = dict(bounds=((-2.5, 2.5), (-1.0, 2.0)), n_grid=21, inputs=0.5)
    r = PA.phase_plane(pnet, **kw)
    V, W = np.meshgrid(r["x"], r["y"])
    np.testing.assert_allclose(r["dx"], V - V ** 3 / 3 - W + 0.5, **EXACT)
    np.testing.assert_allclose(r["dy"], (V + 0.7 - 0.8 * W) / 12.5, **EXACT)
    jr = JA.phase_plane(jnet, **kw)
    for key in ("x", "y", "dx", "dy"):
        np.testing.assert_allclose(r[key], jr[key], **EXACT)
    assert (r["dx"][10] > 0).any() and (r["dx"][10] < 0).any()
    with pytest.raises(ValueError, match="distinct"):
        PA.phase_plane(pnet, dims=(0, 0))


def test_phase_plane_program_cached():
    """Repeated grids (a nullcline sweep) with new bounds and inputs: each
    equals JAX's.  (JAX's program-cache count has no counterpart.)"""
    jnet, pnet = _both(_fhn_net)
    rs = []
    for bounds, inp in ((((-2, 2), (-1, 1)), 0.3), (((-3, 3), (-2, 2)), 0.7)):
        r = PA.phase_plane(pnet, bounds=bounds, n_grid=11, inputs=inp)
        jr = JA.phase_plane(jnet, bounds=bounds, n_grid=11, inputs=inp)
        np.testing.assert_allclose(r["dx"], jr["dx"], **EXACT)
        np.testing.assert_allclose(r["dy"], jr["dy"], **EXACT)
        rs.append(r)
    assert not np.allclose(rs[0]["dx"], rs[1]["dx"])


def test_basins_bistable_tanh():
    """Basin classification on the bistable unit v' = -v/tau + w*tanh(v)
    (w*tau > 1): negative ICs flow to -v*, positive to +v*, the unstable
    point 0 matches no attractor (-1); labels equal JAX's and endpoints
    within rtol 1e-9; a second grid too; validation errors."""
    jnet, pnet = _both(lambda jax: _tanh_net(jax, 1, np.array([[2.0]]), tau=1.0, k=1.0))
    a_pos = PA.fixed_point(pnet, y0=np.array([2.0]))
    a_neg = PA.fixed_point(pnet, y0=np.array([-2.0]))
    v_star = 1.9150080
    np.testing.assert_allclose(_np(a_pos), [v_star], atol=1e-5)
    assert PA.stability(pnet, y=a_pos)[0].real < 0
    ja_pos = JA.fixed_point(jnet, y0=np.array([2.0]))
    ja_neg = JA.fixed_point(jnet, y0=np.array([-2.0]))
    np.testing.assert_allclose(_np(a_pos), _np(ja_pos), **NEWTON)

    ics = np.linspace(-3.0, 3.0, 13).reshape(-1, 1)
    want = np.where(ics[:, 0] < 0, 0, 1)
    want[ics[:, 0] == 0.0] = -1
    for grid in (ics, ics * 0.5):
        labels, ends = PA.basins(pnet, ics=grid, attractors=[a_neg, a_pos], steps=4000,
                                 tol=1e-4)
        j_labels, j_ends = JA.basins(jnet, ics=grid, attractors=[ja_neg, ja_pos],
                                     steps=4000, tol=1e-4)
        np.testing.assert_array_equal(labels, want)
        np.testing.assert_array_equal(labels, j_labels)
        np.testing.assert_allclose(ends, j_ends, **NEWTON)
        np.testing.assert_allclose(np.abs(ends[labels >= 0, 0]), v_star, atol=1e-4)
    with pytest.raises(ValueError, match="ics"):
        PA.basins(pnet, ics=np.zeros((4, 2)), attractors=[a_pos], steps=10)
    with pytest.raises(ValueError, match="needs ics"):
        PA.basins(pnet, steps=10)


def test_trajectory_analysis_rejects_spiking_nodes():
    """The reset-free flow of a spiking node is not what run() simulates:
    the trajectory analyses refuse and point to lyapunov_direct; the point
    analyses on the smooth flow remain legitimate (Jacobian equal to
    JAX's)."""
    n = 4

    def build(jax):
        net = _new(jax, 1e-3)
        net.add_diffeq_node("qif", QIF_SFA, weights=np.zeros((n, n)), source_var="s",
                            target_var="s_in", input_var="I_ext", output_var="s",
                            spike_var="spike", spike_def="v", op="qif_sfa_op",
                            spike_threshold=10.0, spike_reset=-10.0,
                            verbose=False, clear=True, file_name="ana_spk")
        return net

    jnet, pnet = _both(build)
    with pytest.raises(ValueError, match="lyapunov_direct"):
        PA.lyapunov_spectrum(pnet, steps=100)
    with pytest.raises(ValueError, match="lyapunov_direct"):
        PA.limit_cycle(pnet, steps=100, transient=10)
    with pytest.raises(ValueError, match="lyapunov_direct"):
        PA.basins(pnet, ics=np.zeros((1, 3 * n)), attractors=np.zeros((1, 3 * n)), steps=1)
    got = _np(PA.jacobian(pnet))
    assert got.shape == (3 * n, 3 * n)
    np.testing.assert_allclose(got, _np(JA.jacobian(jnet)), **EXACT)


@pytest.mark.parametrize("coupling", ["bfloat16", "int8_master"])
def test_lyapunov_direct_rejects_quantized_couplings(coupling):
    """Quantized couplings are staircases: below the quantum the copies
    compute identical products and the exponent biases strongly negative;
    both packages refuse (a bf16 fused kernel's copy of W too)."""
    n = 8
    W = np.random.default_rng(0).standard_normal((n, n)) * 0.3
    net = Network(1e-2, dtype=torch.float32, device="cpu")
    net.add_diffeq_node("pop", TANH, weights=W, input_var="li_op/I_ext",
                        output_var="li_op/v", source_var="tanh_op/r",
                        target_var="li_op/r_in", clear=True, verbose=False,
                        file_name="ld_quant", coupling_dtype=coupling,
                        node_vars={"all/li_op/tau": 1.0})
    with pytest.raises(ValueError, match="quantized coupling"):
        PA.lyapunov_direct(net, steps=1000)


def test_lyapunov_direct_rejects_a_bf16_fused_copy():
    from rectipy_tpu_torch import attach_fused_qif_step

    n = 8
    net = Network(1e-3, device="cpu")
    net.add_diffeq_node("qif", QIF_SFA, weights=np.zeros((n, n)), source_var="s",
                        target_var="s_in", input_var="I_ext", output_var="s",
                        spike_var="spike", spike_def="v", op="qif_sfa_op",
                        spike_threshold=10.0, spike_reset=-10.0)
    attach_fused_qif_step(net.get_node("qif"), weights_dtype="bfloat16")
    with pytest.raises(ValueError, match="quantized coupling"):
        PA.lyapunov_direct(net, steps=1000)


def test_lyapunov_direct_validation():
    net = _tanh_net(False, 2, np.zeros((2, 2)))
    with pytest.raises(ValueError, match="renorm"):
        PA.lyapunov_direct(net, steps=5, renorm=10)
    with pytest.warns(UserWarning, match="steps % renorm"):
        PA.lyapunov_direct(net, steps=25, renorm=10, transient=0)
