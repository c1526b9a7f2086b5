"""Dynamical-systems analysis: Jacobians, fixed points, linear stability.

Counterpart of ``rectipy_tpu/analysis.py``.  Every lowered vector field is a
PyTorch function of the state, so the Jacobian is one ``torch.func.jacrev``
call -- no finite differences, no re-derivation -- and a damped Newton
iteration on ``f(y) = 0`` gives machine-precision fixed points whose
eigenvalues classify the local dynamics.

All functions but :func:`lyapunov_direct` operate on the SMOOTH flow of one
diffeq node (resets and spike events are discontinuous and excluded) with
the external input held constant -- the autonomous system whose
linearization the standard analyses (focus/node classification, Hopf
detection, slow-manifold reduction) require.  Works for any template: rate,
mean-field, conductance-based.

    from rectipy_tpu_torch.analysis import fixed_point, stability
    y_star = fixed_point(net, inputs=2.0)
    eigs = stability(net, y=y_star, inputs=2.0)   # Re<0 -> locally stable

How the port computes, where the JAX package compiles one program per
analysis:

- The Newton iteration is a Python loop that reads one scalar per
  iteration (the residual test), where JAX runs an on-device
  ``while_loop``.
- The trajectory analyses loop the node's own integrator map in Python.
  The ``k`` tangent vectors of :func:`lyapunov_spectrum` and the monodromy
  matrix's ``n`` columns of :func:`limit_cycle` are rows of a ``(k, n)``
  state that the node steps as it steps ``run_batch``'s trials (each row
  one trial), where JAX ``vmap``s a ``jvp``.  The map's Jacobian-vector
  products come from reverse passes, which the C++ autograd engine runs
  (two a step, ``J q = d/du <J^T u, q>``; one for a state of at most 16
  variables, which takes the whole Jacobian):
  forward-mode AD takes a Python decomposition for every operation that
  meets an operand without a tangent (each constant of an equation), which
  costs about a hundred times the operation.  :func:`phase_plane` and
  :func:`basins` evaluate all their points as rows at once.
- Nothing is compiled, so nothing is cached: the JAX package's
  ``_analysis_programs`` compile cache has no counterpart.
- A quantized master coupling's straight-through matvec is an old-style
  ``autograd.Function``, which ``torch.func`` and forward-mode AD do not
  take: the Jacobian-based analyses of such a node raise where the JAX
  package differentiates through its STE.

:func:`lyapunov_direct` runs two copies of the whole network's state
through the network's own step (fused kernels included) and measures their
separation.
"""

from __future__ import annotations

import functools
import warnings
from typing import Optional

import numpy as np
import torch

from . import trees

__all__ = ["autonomous_field", "jacobian", "basins", "fixed_point",
           "stability", "lyapunov_spectrum", "lyapunov_direct", "limit_cycle",
           "phase_plane"]


def _resolve_node(net, node: Optional[str]):
    """The diffeq node to analyze (explicit label, or the unique one)."""
    if node is not None:
        return node, net.get_node(node)
    # diffeq nodes carry a state vector y; InstantNodes only have func
    diffeq = [n for n in net.nodes if hasattr(net.get_node(n), "y")]
    if len(diffeq) != 1:
        raise ValueError(
            f"Network has {len(diffeq)} differential-equation nodes "
            f"({diffeq}); pass node=<label> to pick one.")
    return diffeq[0], net.get_node(diffeq[0])


def _check_closed_loop(net, label: str, open_loop: bool):
    """Edge-driven inputs are FROZEN at their stored values by the
    autonomous field -- analyzing a node whose recurrence arrives through
    graph/feedback edges would silently drop that coupling from the
    Jacobian, so refuse unless the caller opts in."""
    if open_loop:
        return
    preds = list(net.graph.predecessors(label))
    fb = [(u, v) for u, v, _ in net._fb_edge_list() if v == label]
    if preds or fb:
        raise ValueError(
            f"Node {label!r} receives inputs through graph edges "
            f"({preds + fb}); the analysis functions freeze those at their "
            "stored values and would return the OPEN-LOOP linearization. "
            "Analyze a node whose recurrence lives in its own coupling "
            "(weights=/edges= on add_diffeq_node), or pass open_loop=True "
            "to accept the open-loop analysis deliberately.")


def _field_args(net, node, inputs, open_loop):
    """The node and its args with the external input held at ``inputs``
    (scalar or ``(n_in,)``; default: the input slot's stored value)."""
    label, nd = _resolve_node(net, node)
    _check_closed_loop(net, label, open_loop)
    args = dict(nd.args)
    if inputs is not None:
        cur = args[nd._inp_key]
        inp = torch.as_tensor(np.asarray(inputs), dtype=nd.dtype, device=nd.device)
        ndim = cur.dim() if isinstance(cur, torch.Tensor) else np.ndim(cur)
        args[nd._inp_key] = inp.broadcast_to(tuple(np.shape(cur))) if ndim else inp.reshape(())
    return nd, args


def _as_state(nd, y) -> torch.Tensor:
    """``y`` (default: the node's state) as a tensor of the state's dtype
    and device."""
    if y is None:
        return nd.y
    t = y if isinstance(y, torch.Tensor) else torch.as_tensor(np.asarray(y))
    return t.to(device=nd.y.device, dtype=nd.y.dtype)


def autonomous_field(net, node: str = None, inputs=None, open_loop: bool = False):
    """``(f, y)``: the node's autonomous vector field ``f(y) -> dy/dt`` with
    the external input held constant at ``inputs`` (scalar or ``(n_in,)``;
    default: the input slot's stored value, normally zeros), plus the
    node's current state vector.  Couplings declared ON the node
    (``weights=`` / ``edges=`` of ``add_diffeq_node``) are part of the
    flow; inputs arriving through graph/feedback edges are NOT (they are
    frozen constants) -- such nodes raise unless ``open_loop=True``."""
    nd, args = _field_args(net, node, inputs, open_loop)
    func = nd.func

    def f(y):
        return func(0.0, y, args)

    return f, nd.y


def _jac(func, y, args) -> torch.Tensor:
    return torch.func.jacrev(lambda yy: func(0.0, yy, args))(y)


def jacobian(net, node: str = None, y=None, inputs=None,
             open_loop: bool = False) -> torch.Tensor:
    """Jacobian ``df/dy`` of the node's smooth flow at state ``y`` (default:
    the node's current state) -- exact, via ``torch.func.jacrev``."""
    nd, args = _field_args(net, node, inputs, open_loop)
    return _jac(nd.func, _as_state(nd, y), args)


def fixed_point(net, node: str = None, y0=None, inputs=None, tol: float = None,
                max_iter: int = 100, damping: float = 1.0,
                open_loop: bool = False) -> torch.Tensor:
    """Damped Newton solve of ``f(y) = 0`` from ``y0`` (default: the node's
    current state), one scalar read per iteration (the residual test).
    Raises if the residual does not reach ``tol * (1 + |y*|)`` within
    ``max_iter`` iterations (try a smaller ``damping`` or a better ``y0``
    -- e.g. the tail of a short ``run``).  ``tol`` defaults to ``1000 *
    eps`` of the node's dtype (~1e-4 in float32, ~2e-11 in float64 -- use a
    float64 network for tight equilibria)."""
    nd, args = _field_args(net, node, inputs, open_loop)
    func = nd.func
    y = _as_state(nd, y0)
    if tol is None:
        tol = 1000.0 * float(torch.finfo(y.dtype).eps)

    def resid(yv):
        return func(0.0, yv, args).abs().max()

    for _ in range(int(max_iter)):
        if not bool(resid(y) > tol * (1.0 + y.abs().max())):
            break
        step = torch.linalg.solve(_jac(func, y, args), func(0.0, y, args))
        y = y - damping * step
    r = float(resid(y))
    if not (r <= tol * (1.0 + float(y.abs().max()))) or not np.isfinite(r):
        raise RuntimeError(
            f"fixed_point: Newton did not converge in {max_iter} iterations "
            f"(max |f| = {r:.3e}); try damping < 1 or a closer y0.")
    return y


def _flow_map(nd):
    """``m(y, args, dt) -> y_next``: ONE step of the node's OWN integrator
    (euler/heun/rk4, matching ``nodes.py``'s ``make_step``) on the smooth
    flow, so that trajectory-based analyses characterize the same discrete
    map ``run()`` integrates.  ``y`` may be rows ``(B, n)``."""
    func = nd.func
    integ = getattr(nd, "integrator", "euler")
    if integ == "heun":
        def m(y, args, dt):
            k1 = func(0.0, y, args)
            k2 = func(0.0, y + dt * k1, args)
            return y + (dt * 0.5) * (k1 + k2)
    elif integ == "rk4":
        def m(y, args, dt):
            k1 = func(0.0, y, args)
            k2 = func(0.0, y + (dt * 0.5) * k1, args)
            k3 = func(0.0, y + (dt * 0.5) * k2, args)
            k4 = func(0.0, y + dt * k3, args)
            return y + (dt / 6.0) * (k1 + 2.0 * (k2 + k3) + k4)
    else:
        def m(y, args, dt):
            return y + dt * func(0.0, y, args)
    return m


def _check_smooth_trajectory(nd, fn_name: str):
    """Trajectory-based analyses integrate the RESET-FREE flow; on spiking
    nodes that flow is not what ``run()`` simulates (QIF's v^2 escapes in
    finite time without the reset) -- refuse with the right pointer."""
    from .nodes import RateNet

    if type(nd) is not RateNet and isinstance(nd, RateNet):
        raise ValueError(
            f"{fn_name} integrates the node's smooth (reset-free) flow, but "
            f"{type(nd).__name__} dynamics are reset-dominated -- the "
            "reset-free trajectory diverges or is meaningless. Use "
            "lyapunov_direct(net), which evolves the FULL network step "
            "(spikes and resets included), instead.")


def _rows(y: torch.Tensor, k: int) -> torch.Tensor:
    return y.unsqueeze(0).expand(k, y.shape[0]).contiguous()


def _qr(A: torch.Tensor):
    """Reduced QR of ``A``.  On the CPU through numpy's LAPACK: PyTorch's
    CPU QR of a small matrix takes milliseconds when its thread pool is
    wider than one thread (it is called every ``reorth`` steps)."""
    if A.device.type == "cpu":
        Q, R = np.linalg.qr(A.numpy())
        return torch.from_numpy(Q), torch.from_numpy(R)
    return torch.linalg.qr(A)


# state sizes up to this take the map's whole Jacobian from one reverse pass
_FULL_JACOBIAN_MAX = 16


def _tangent_step(fmap, y, T, args, dt):
    """``(fmap(y), T J^T)``: one map step of the state ``y`` ``(n,)`` and the
    Jacobian-vector products of the tangent rows ``T`` ``(k, n)`` (row ``i``
    of the result is ``J T[i]``).  A small state takes the whole Jacobian
    from one reverse pass over ``n`` rows of ``y`` (row ``i`` of the output
    depends on row ``i`` alone, so the gradient of its diagonal is ``J``);
    a large one takes two reverse passes over ``k`` rows: ``g(U) = J^T U``
    is linear in ``U``, and ``J T`` is the gradient of ``<g, T>`` with
    respect to ``U``."""
    n, k = y.shape[0], T.shape[0]
    with torch.enable_grad():
        if n <= _FULL_JACOBIAN_MAX:
            Yg = _rows(y, n).requires_grad_(True)
            out = fmap(Yg, args, dt)
            eye = torch.eye(n, dtype=out.dtype, device=out.device)
            (J,) = torch.autograd.grad(out, Yg, eye, allow_unused=True)
            JT = torch.zeros_like(T) if J is None else T @ J.T
            return out[0].detach(), JT
        Yg = _rows(y, k).requires_grad_(True)
        out = fmap(Yg, args, dt)
        U = torch.zeros_like(out, requires_grad=True)
        (g,) = torch.autograd.grad(out, Yg, U, create_graph=True)
        (JT,) = torch.autograd.grad(g, U, T, allow_unused=True)
    return out[0].detach(), (torch.zeros_like(T) if JT is None else JT)


def lyapunov_spectrum(net, node: str = None, k: int = 1, steps: int = 50_000,
                      transient: int = 0, reorth: int = 10, y0=None,
                      inputs=None, seed: int = 0,
                      open_loop: bool = False) -> np.ndarray:
    """Leading ``k`` Lyapunov exponents of the node's simulated dynamics
    (Benettin/QR method), in descending order, units of 1/time.

    The exponents are those of the DISCRETE map the framework integrates
    (the node's own euler/heun/rk4 step), propagated through its exact
    differential (Jacobian-vector products), so they converge to the flow's
    exponents as ``dt`` is refined and are exact for what ``run()``
    simulates.  Smooth flows only: spiking (reset) nodes raise -- use
    :func:`lyapunov_direct` for those.  ``lambda_max > 0`` = chaos (e.g. the
    Sompolinsky-Crisanti-Sommers transition of random tanh-rate networks at
    gain g > 1); a limit cycle shows a leading exponent ~0 with the rest
    negative.

    ``steps`` map applications after ``transient`` warmup steps (from
    ``y0``/the node's current state); external input frozen at ``inputs``.
    ``reorth``: steps between QR reorthonormalizations.  ``seed`` draws the
    initial orthonormal tangent frame (numpy, as the JAX package draws it).
    The state and its ``k`` tangents advance as ``(k, n)`` rows; nothing
    synchronizes with the host before the end.
    """
    nd, args = _field_args(net, node, inputs, open_loop)
    _check_smooth_trajectory(nd, "lyapunov_spectrum")
    y = _as_state(nd, y0)
    n = int(y.shape[0])
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}] (state dimension), got {k}")
    if steps < reorth:
        raise ValueError(f"steps ({steps}) must be >= reorth ({reorth})")
    if steps % reorth:
        warnings.warn(f"lyapunov_spectrum: using {steps - steps % reorth} of "
                      f"the requested {steps} steps (steps % reorth dropped)",
                      stacklevel=2)
    n_blocks = steps // reorth
    rng = np.random.default_rng(seed)
    Q0, _ = np.linalg.qr(rng.standard_normal((n, k)))
    fmap = _flow_map(nd)
    dt = float(net.dt)
    tiny = torch.finfo(y.dtype).tiny
    with torch.no_grad():
        for _ in range(int(transient)):
            y = fmap(y, args, dt)
        Q = torch.as_tensor(Q0, dtype=y.dtype, device=y.device)
        acc = torch.zeros(k, dtype=y.dtype, device=y.device)
        for _ in range(n_blocks):
            T = Q.T.contiguous()
            for _ in range(int(reorth)):
                y, T = _tangent_step(fmap, y, T, args, dt)
            Q, R = _qr(T.T)
            acc = acc + torch.log(torch.clamp_min(torch.diagonal(R).abs(), tiny))
    lam = (acc / (n_blocks * reorth * dt)).cpu().numpy().astype(np.float64)
    if not np.all(np.isfinite(lam)):
        raise RuntimeError(
            f"lyapunov_spectrum diverged (exponents {lam}); the trajectory "
            "likely blew up -- reduce dt, add a transient, or start from an "
            "attractor state.")
    return np.sort(lam)[::-1]


def phase_plane(net, node: str = None, dims=(0, 1), bounds=None,
                n_grid: int = 41, y_fixed=None, inputs=None,
                open_loop: bool = False) -> dict:
    """Vector field of the node's smooth flow sampled on a 2-D grid -- the
    phase-plane/nullcline workhorse for the planar models (FitzHugh-Nagumo,
    Morris-Lecar, Wilson-Cowan, MPR, Hindmarsh-Rose fast subsystem).

    ``dims``: the two state-vector indices spanning the plane; every other
    coordinate is held at ``y_fixed`` (default: the node's current state).
    ``bounds``: ``((x_min, x_max), (y_min, y_max))``; defaults to +-2 around
    the current state's values on ``dims``.  The whole ``n_grid**2`` grid is
    evaluated as one call on ``(n_grid**2, n)`` rows.

    Returns ``{"x", "y"}`` (the 1-D grid axes) and ``{"dx", "dy"}`` --
    ``(n_grid, n_grid)`` arrays of the two flow components, indexed
    ``[i_y, i_x]`` (matplotlib ``quiver``/``streamplot`` convention);
    nullclines are the zero contours.
    """
    nd, args = _field_args(net, node, inputs, open_loop)
    y0 = _as_state(nd, y_fixed)
    n = int(y0.shape[0])
    i, j = int(dims[0]), int(dims[1])
    if not (0 <= i < n and 0 <= j < n and i != j):
        raise ValueError(f"dims must be two distinct indices in [0, {n}), got {dims}")
    if bounds is None:
        ci, cj = float(y0[i]), float(y0[j])
        bounds = ((ci - 2.0, ci + 2.0), (cj - 2.0, cj + 2.0))
    xs = np.linspace(*bounds[0], n_grid)
    ys = np.linspace(*bounds[1], n_grid)
    X, Y = np.meshgrid(xs, ys)  # [i_y, i_x]
    pts = _rows(y0, n_grid * n_grid).clone()
    pts[:, i] = torch.as_tensor(X.ravel(), dtype=y0.dtype, device=y0.device)
    pts[:, j] = torch.as_tensor(Y.ravel(), dtype=y0.dtype, device=y0.device)
    with torch.no_grad():
        d = nd.func(0.0, pts, args)
    d = d[:, [i, j]].cpu().numpy()
    return {"x": xs, "y": ys,
            "dx": d[:, 0].reshape(n_grid, n_grid),
            "dy": d[:, 1].reshape(n_grid, n_grid)}


def basins(net, node: str = None, ics=None, attractors=None, inputs=None,
           steps: int = 50_000, tol: float = 1e-3, open_loop: bool = False):
    """Basin-of-attraction classification: integrate the node's smooth flow
    from every initial condition and assign each endpoint to the nearest
    attractor.

    ``ics``: ``(B, n_state)`` initial conditions.  ``attractors``:
    list/array of attractor state vectors -- typically :func:`fixed_point`
    results from several warm starts.  All ``B`` trajectories advance
    together as the rows of one ``(B, n)`` state through the node's own
    integrator map.

    Returns ``(labels, endpoints)``: ``labels[b]`` is the index into
    ``attractors`` whose max-norm relative distance to the endpoint is
    smallest AND below ``tol`` -- else ``-1`` (diverged, on a limit cycle,
    or still in transit; raise ``steps`` or ``tol``).  Like the other
    trajectory analyses this integrates the RESET-FREE flow and refuses
    spiking nodes.
    """
    nd, args = _field_args(net, node, inputs, open_loop)
    _check_smooth_trajectory(nd, "basins")
    if ics is None or attractors is None:
        raise ValueError("basins needs ics (B, n_state) and a list of "
                         "attractor state vectors (see fixed_point).")
    n = int(nd.y.shape[0])

    def as_rows(a):
        if isinstance(a, (list, tuple)):
            a = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x for x in a]
        elif isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return torch.as_tensor(np.asarray(a), dtype=nd.y.dtype, device=nd.y.device)

    ics, attrs = as_rows(ics), as_rows(attractors)
    if ics.dim() != 2 or ics.shape[1] != n:
        raise ValueError(f"ics must be (B, {n}); got {tuple(ics.shape)}")
    if attrs.dim() != 2 or attrs.shape[1] != n:
        raise ValueError(f"attractors must be (K, {n}); got {tuple(attrs.shape)}")
    fmap = _flow_map(nd)
    dt = float(net.dt)
    ends = ics
    with torch.no_grad():
        for _ in range(int(steps)):
            ends = fmap(ends, args, dt)
        # relative max-norm distance endpoint -> each attractor
        scale = 1.0 + attrs.abs().amax(dim=1)                        # (K,)
        dist = (ends[:, None, :] - attrs[None]).abs().amax(dim=2) / scale
        best = torch.argmin(dist, dim=1)
        ok = (dist.amin(dim=1) <= tol) & torch.isfinite(ends).all(dim=1)
        labels = torch.where(ok, best, torch.full_like(best, -1))
    return labels.cpu().numpy(), ends.cpu().numpy()


def _is_inexact(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and (leaf.is_floating_point() or leaf.is_complex())


def _quantized(nd) -> Optional[str]:
    """The node's quantized coupling, if it has one: a master coupling's
    cast, or a low-precision matrix among its args (a bf16 or int8
    coupling, a fused kernel's bf16 copy of W)."""
    vf = getattr(nd, "_vf", None)
    cast = getattr(vf, "coupling_cast", None) if vf is not None else None
    if cast:
        return cast
    for v in getattr(nd, "args", {}).values():
        if isinstance(v, torch.Tensor) and v.dim() >= 2 and v.dtype in (
                torch.bfloat16, torch.float16, torch.int8, torch.uint8):
            return "low-precision weights"
    return None


def lyapunov_direct(net, inputs=None, steps: int = 100_000, renorm: int = 100,
                    transient: int = 10_000, eps: float = None,
                    seed: int = 0) -> float:
    """Largest Lyapunov exponent of the FULL network by the direct
    (two-trajectory / Benettin-distance) method -- works where the tangent
    method (:func:`lyapunov_spectrum`) cannot: spiking populations with
    resets, delay/filter edges, feedback networks.  Two copies of the
    complete network state (every node, edge buffer, and feedback value)
    evolve through the network's own step (an attached fused kernel
    launches once per copy per step) under the same constant input; every
    ``renorm`` steps the copies' separation is measured, its log
    accumulated, and the perturbed copy pulled back to distance ``eps``
    along the current difference direction.

    ``inputs``: constant drive (scalar or ``(n_in,)``; default zeros).
    ``eps`` is the ABSOLUTE renormalization distance; the default is
    ``1e-6`` (float64) / ``1e-4`` (float32) of the post-transient state
    RMS.  Returns the exponent in 1/time units for the simulated discrete
    system (the Euler/reset map ``run()`` computes).  The perturbation is
    drawn with ``np.random.default_rng(seed)`` in the JAX package's order,
    so that float64 runs of the two packages are comparable.

    The estimate starts from the network's CURRENT state (after the
    ``transient``); an exactly invariant start (e.g. the all-zeros fresh
    tanh network -- a fixed point) never leaves it.  Reach the attractor
    first: ``reset(y=...)`` to a generic state or ``run()`` a warmup.

    HARD-RESET CAVEAT: a threshold crossing misaligned between the copies
    makes their separation jump to O(reset amplitude) and collapse again
    once both have reset.  If ``eps`` is too small, or ``renorm`` too
    short, the estimate biases POSITIVE.  For spiking networks keep
    ``renorm`` at least a typical inter-spike interval and confirm the
    estimate is stable when you halve ``eps`` and double ``renorm``.
    Quantized couplings are refused: below their quantum the two copies
    compute identical products and the exponent biases strongly negative.
    """
    net.compile()
    for label in net.nodes:
        cast = _quantized(net.get_node(label))
        if cast:
            raise ValueError(
                f"lyapunov_direct: node {label!r} uses a quantized coupling "
                f"({cast}); the quantization staircase flattens separations below its "
                "quantum and biases the exponent strongly negative. Rebuild the node "
                "without coupling_dtype= (full precision) to measure chaos.")
    state0 = net.init_state()
    flat = trees.leaves(state0)
    inexact = [leaf for leaf in flat if _is_inexact(leaf)]
    if not inexact:
        raise ValueError("network has no continuous state to perturb")
    dtype = functools.reduce(torch.promote_types, [leaf.dtype for leaf in inexact])
    device = inexact[0].device
    x = torch.zeros(net.n_in, dtype=dtype, device=device) if inputs is None else \
        torch.as_tensor(np.asarray(inputs), dtype=dtype, device=device).broadcast_to(
            (net.n_in,))
    if eps is None:
        eps_in, eps_rel = (1e-6 if torch.finfo(dtype).bits >= 64 else 1e-4), 1.0
    else:
        eps_in, eps_rel = float(eps), 0.0
    if steps < renorm:
        raise ValueError(f"steps ({steps}) must be >= renorm ({renorm})")
    if steps % renorm:
        warnings.warn(f"lyapunov_direct: using {steps - steps % renorm} of "
                      f"the requested {steps} steps (steps % renorm dropped)",
                      stacklevel=2)
    n_blocks = steps // renorm

    # deterministic unit perturbation over the inexact leaves, scaled to eps
    rng = np.random.default_rng(seed)
    d_flat = [rng.standard_normal(tuple(leaf.shape)) if _is_inexact(leaf) else None
              for leaf in flat]
    nrm0 = np.sqrt(sum(float(np.sum(d * d)) for d in d_flat if d is not None))
    d0 = trees.fill(state0, [
        torch.as_tensor(d / nrm0).to(device=leaf.device, dtype=leaf.dtype) if d is not None
        else torch.zeros_like(leaf) for d, leaf in zip(d_flat, flat)])

    f32 = torch.float32
    step = net.make_step()
    with torch.no_grad():
        # once-per-call parameter prep, as in run()
        params = net._prep_params(net.parameters_pytree())
        state = state0
        for _ in range(int(transient)):
            state = step(state, params, x)[0]
        # default eps: relative to the post-transient state RMS (floored so
        # that a silent network cannot produce eps = 0)
        live = [leaf for leaf in trees.leaves(state) if _is_inexact(leaf)]
        sq = torch.stack([(leaf.to(f32) ** 2).sum() for leaf in live])
        count = sum(leaf.numel() for leaf in live)
        rms = torch.sqrt(sq.sum() / count)
        scale = torch.clamp_min(rms, 1e-6)
        eps_v = torch.tensor(eps_in, dtype=f32, device=device) * (
            scale if eps_rel > 0 else 1.0)
        pert = trees.fill(state, [a + eps_v.to(a.dtype) * d if _is_inexact(a) else a
                                  for a, d in zip(trees.leaves(state), trees.leaves(d0))])
        tiny = torch.finfo(f32).tiny

        def rel_sq_dist(s1, s2):
            # distances in units of eps (differences divided by eps in the
            # leaf dtype BEFORE squaring: eps^2 underflows f32 for float64)
            parts = [(((b - a) / eps_v.to(a.dtype)) ** 2).sum().to(f32)
                     for a, b in zip(trees.leaves(s1), trees.leaves(s2)) if _is_inexact(a)]
            return torch.stack(parts).sum()

        s1, s2 = state, pert
        acc = torch.zeros((), dtype=f32, device=device)
        for _ in range(n_blocks):
            for _ in range(int(renorm)):
                s1, s2 = step(s1, params, x)[0], step(s2, params, x)[0]
            nrm = torch.sqrt(rel_sq_dist(s1, s2))  # separation / eps
            acc = acc + torch.log(torch.clamp_min(nrm, tiny))
            pull = 1.0 / torch.clamp_min(nrm, tiny)
            # pull the copy back to distance eps; exact (int/bool) leaves
            # take the fiducial trajectory's values
            s2 = trees.fill(s1, [a + pull.to(a.dtype) * (b - a) if _is_inexact(a) else a
                                 for a, b in zip(trees.leaves(s1), trees.leaves(s2))])
    lam = float(acc) / (n_blocks * renorm * float(net.dt))
    if not np.isfinite(lam):
        raise RuntimeError(
            f"lyapunov_direct diverged (exponent {lam}); the trajectory "
            "likely blew up -- reduce dt or check the drive.")
    return lam


def limit_cycle(net, node: str = None, y0=None, inputs=None,
                steps: int = 100_000, transient: int = None, coord: int = None,
                open_loop: bool = False) -> dict:
    """Locate a stable limit cycle of the node's simulated dynamics and
    characterize it: period, a point on the cycle, and the Floquet
    multipliers of the one-period monodromy matrix.

    Method: simulate ``transient`` steps (default ``steps``) to reach the
    attractor, record ``steps`` more, detect the period from upward
    mean-crossings of coordinate ``coord`` (default: the state dimension
    with the largest variance) with linear interpolation between steps,
    then evaluate the monodromy ``M = d(flow_K)/dy`` at a cycle point by
    Jacobian-vector products through the K-step map (K = rounded period
    steps; the ``n`` columns ride as the rows of one state).

    Returns a dict: ``period`` (time units) and ``period_steps`` (float),
    ``y_star`` (a state on the cycle), ``multipliers`` (complex, sorted by
    descending magnitude -- one is ~1, the neutral direction along the
    flow), and ``exponents`` (``log|multiplier| / period``, comparable to
    :func:`lyapunov_spectrum`).  Raises if no sustained oscillation is
    detected (fewer than 4 crossings, or vanishing amplitude -- use
    :func:`fixed_point`/:func:`stability` for equilibria).
    """
    nd, args = _field_args(net, node, inputs, open_loop)
    _check_smooth_trajectory(nd, "limit_cycle")
    y = _as_state(nd, y0)
    if transient is None:
        transient = steps
    fmap = _flow_map(nd)
    dt = float(net.dt)
    with torch.no_grad():
        for _ in range(int(transient)):
            y = fmap(y, args, dt)
        rec = []
        for _ in range(int(steps)):
            y = fmap(y, args, dt)
            rec.append(y)
        ys = torch.stack(rec).cpu().numpy().astype(np.float64)
    if not np.all(np.isfinite(ys)):
        raise RuntimeError("limit_cycle: trajectory diverged; reduce dt or "
                           "start closer to the attractor.")
    if coord is None:
        coord = int(np.argmax(ys.var(axis=0)))
    x = ys[:, coord]
    mean, amp = x.mean(), x.max() - x.min()
    scale = max(abs(x.max()), abs(x.min()), 1.0)
    if amp < 1e-6 * scale:
        raise RuntimeError(
            f"limit_cycle: coordinate {coord} has vanishing amplitude "
            f"({amp:.2e}) -- the trajectory settled to an equilibrium; use "
            "fixed_point()/stability() instead.")
    below = x[:-1] < mean
    up = np.nonzero(below & (x[1:] >= mean))[0]
    if len(up) < 4:
        raise RuntimeError(
            f"limit_cycle: only {len(up)} upward mean-crossings in {steps} "
            "steps -- no sustained oscillation detected (or the window is "
            "shorter than a few periods; raise steps).")
    # sub-step crossing times by linear interpolation
    frac = (mean - x[up]) / (x[up + 1] - x[up])
    t_cross = up + frac
    period_steps = float(np.diff(t_cross).mean())
    k = int(round(period_steps))
    # monodromy at the state nearest a crossing (well on the attractor)
    i_star = int(up[len(up) // 2])
    y_star = torch.as_tensor(ys[i_star], dtype=nd.y.dtype, device=nd.y.device)
    n = int(y_star.shape[0])
    y, T = y_star, torch.eye(n, dtype=y_star.dtype, device=y_star.device)
    for _ in range(k):
        y, T = _tangent_step(fmap, y, T, args, dt)
    M = T.T.detach().cpu().numpy().astype(np.float64)
    mult = np.linalg.eigvals(M)
    mult = mult[np.argsort(-np.abs(mult))]
    period = period_steps * dt
    return {
        "period": period,
        "period_steps": period_steps,
        "y_star": ys[i_star],
        "multipliers": mult,
        "exponents": np.log(np.maximum(np.abs(mult), 1e-300)) / period,
    }


def stability(net, node: str = None, y=None, inputs=None,
              open_loop: bool = False) -> np.ndarray:
    """Eigenvalues of the Jacobian at ``y`` (default: current state), sorted
    by descending real part.  All ``Re < 0`` -> locally asymptotically
    stable; a complex leading pair -> focus/spiral (its imaginary part is
    the local angular frequency); a positive real part at a fixed point ->
    locally unstable (e.g. inside a limit cycle)."""
    J = jacobian(net, node, y, inputs, open_loop=open_loop).detach().cpu().numpy()
    eigs = np.linalg.eigvals(J.astype(np.float64))
    return eigs[np.argsort(-eigs.real)]
