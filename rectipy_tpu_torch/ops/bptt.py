"""Deferred-gradient BPTT: one ``torch.autograd.Function`` over the trajectory.

Counterpart of ``rectipy_tpu/ops/bptt.py``.  Differentiating a loop over
steps that each compute ``W @ src(y)`` makes plain autograd build the
``(N, N)`` weight gradient as one outer product per step.  The classical
factorization avoids that:

    dW = sum_t delta_t (x) src_t = Delta^T @ Src

so the backward loop only emits the per-step matvec-output cotangent
``delta_t`` (an ``(N,)`` vector) and the saved coupling source ``src_t``, and
the ``(N, N)`` contraction is ONE ``(N, T) x (T, N)`` matmul after the loop.
Per step the backward then touches ``W`` once (``W^T @ delta``), as the
forward does (``W @ src``).

``traj(weights, args, y0, xs) -> (yT, outs)``:

- forward: one loop, saving the pre-step state ``y_t``, the coupling sources
  ``src_t`` and the matvec results ``s_in_t`` (O(T*N) memory);
- backward: one reverse loop carrying the state cotangent.  Per step it takes
  the VJP of the coupling-free Euler step (``torch.autograd.grad`` on detached
  leaves) and of the source readers, plus one ``W^T`` matvec per coupling;
  afterwards each ``dW`` is one matmul.  Only the cotangents that
  ``ctx.needs_input_grad`` asks for are computed.

Surrogate spikes, the detached hard reset and the pre-update output follow
each node class (``nodes.py`` ``make_step``).  ``fit_bptt_batch`` runs the
same trajectory on ``B`` trials at once: ``y0`` is ``(B, S)``, ``xs`` is
time-major ``(T, B, n_in)``, the per-step products take ``(B, n)`` rows
(``ops/quant.py``'s ``int8_mm``/``int8_mm_t`` for an ``int8_master``
coupling), and each ``dW`` is still ONE matmul, over trials and time.

Scope: DSL-built ``RateNet`` and ``SpikeResetNet`` with Euler integration
and at least one dense coupling in float32/float64/bfloat16 or a master
coupling (``bfloat16_master``, ``int8_master``, ``int4_master``); anything
else, frozen ``int8``/``int4`` included, raises ``ValueError`` as in the
JAX package, and the caller then takes plain autograd.  Not ported yet:
checkpointed trajectories (``remat_steps``, ROADMAP Queue 1 item 7), the Heun
trajectory and the other node classes (Queue 1 item 3).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, List, Tuple

import torch

__all__ = ["make_coupled_traj", "make_coupled_traj_prepped"]


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``(T, n)`` factors as they are; ``(T, B, n)`` flattened to ``(T*B,
    n)``, so that dW contracts trials and time in one product."""
    return t.reshape(-1, t.shape[-1])


def _make_matvec(cast):
    """Coupling contraction 4-tuple ``(prep, mv, mv_t, grad_w)`` matching
    ``dsl.lower``'s matvec numerics.  ``prep(w)`` runs once per trajectory;
    ``mv``/``mv_t`` take the prepped representation."""
    if cast == "int8":  # int8_master quantized training (ops/quant.py)
        from .quant import int8_master_ops

        return int8_master_ops()
    if cast == "int4":  # int4_master quantized training (ops/quant.py)
        from .quant import int4_master_ops

        return int4_master_ops()
    from ..dsl.lower import _bf16_matvec, _bf16_values, _float_matvec, matvec

    if cast == "bf16":  # bfloat16_master: bf16 x bf16 products, float32 sums
        def mv_t_bf16(w, delta):
            return matvec(w.T, delta.to(torch.bfloat16).to(torch.float32)).to(delta.dtype)

        def grad_w_bf16(deltas, srcs):
            """dW = Delta^T @ Src on bf16-rounded factors, float32 sums."""
            return (_rows(deltas).to(torch.bfloat16).to(torch.float32).T
                    @ _rows(srcs).to(torch.bfloat16).to(torch.float32))

        # prep rounds the master to bf16 once per trajectory (held in float32)
        return _bf16_values, _bf16_matvec, mv_t_bf16, grad_w_bf16

    def prep(w):
        return w

    def mv_t(w, delta):
        """W^T @ delta with the forward matvec's precision policy."""
        if w.dtype in (torch.bfloat16, torch.float16):
            out = matvec(w.to(torch.float32).T, delta.to(w.dtype).to(torch.float32))
            return out.to(delta.dtype)
        if w.dtype != delta.dtype:
            dt = torch.promote_types(w.dtype, delta.dtype)
            return matvec(w.to(dt).T, delta.to(dt)).to(delta.dtype)
        return matvec(w.T, delta)

    def grad_w(deltas, srcs):
        """dW = Delta^T @ Src over the time (and trial) axes: one matmul,
        its result rounded to float32 as the JAX package's ``dot_general(...,
        preferred_element_type=float32)`` rounds it.  Wider factors of ``(T,
        B, n)`` trials round each trial's product, as that package's vmapped
        trajectory does, and sum them (float32 factors: one product)."""
        if deltas.dim() == 3 and deltas.dtype != torch.float32:
            per_trial = torch.einsum("tbi,tbj->bij", deltas, srcs)
            return per_trial.to(torch.float32).to(deltas.dtype).sum(0)
        return (_rows(deltas).T @ _rows(srcs)).to(torch.float32).to(deltas.dtype)

    return prep, _float_matvec, mv_t, grad_w


def _node_pieces(node):
    """Validate a node for deferred-gradient BPTT and build its per-population
    machinery: coupling source readers, the coupling-free step function and
    the per-coupling contractions."""
    vf = getattr(node, "_vf", None)
    if vf is None or vf.tile_func is None:
        raise ValueError("Deferred-gradient BPTT requires a DSL-built node (raw-constructor "
                         "nodes use plain autograd).")
    if getattr(node, "_fused_attached", False):
        raise ValueError("Deferred-gradient BPTT requires the standard state layout; build a "
                         "fresh node without a fused kernel.")
    cls_name = type(node).__name__
    if cls_name not in ("RateNet", "SpikeResetNet"):
        raise ValueError(f"Deferred-gradient BPTT does not support {cls_name} nodes")
    if getattr(node, "integrator", "euler") != "euler":
        raise ValueError(f"Deferred-gradient BPTT does not support integrator="
                         f"{node.integrator!r}")
    wkeys = [wk for _, _, wk in vf.couplings]
    if not wkeys:
        raise ValueError("Deferred-gradient BPTT requires at least one coupling matrix")
    for wk in wkeys:
        if node._args[wk].dtype == torch.int8:
            raise ValueError("the deferred trajectory takes no frozen int8/int4 coupling; "
                             "plain autograd trains through it")
    src_readers = []
    for src, _tgt, _wk in vf.couplings:
        rd = vf.make_tile_reader(src, allow_global=True)
        if rd is None:
            raise ValueError("Deferred-gradient BPTT requires every coupling source to be a "
                             "state variable or an algebraic of states/params only.")
        src_readers.append(rd)
    out_reader_alg = None
    if node._out_alg is not None:
        out_reader_alg = vf.make_tile_reader(node._out_alg, allow_global=True)
        if out_reader_alg is None:
            raise ValueError("Deferred-gradient BPTT requires an algebraic output to depend "
                             "on states/params only.")

    n, dt = vf.n, node.dt
    state_order = list(vf.state_order)
    slices = [(q,) + tuple(vf.var_map[q]) for q in state_order]
    tgt_names = [tgt for _, tgt, _ in vf.couplings]
    tile_func, inp_key = vf.tile_func, node._inp_key
    ops4 = [_make_matvec(vf.coupling_cast) for _ in wkeys]

    spiking = cls_name == "SpikeResetNet"
    spike_fn = getattr(node, "spike", None)
    thresh = float(getattr(node, "_thresh", 0.0))
    reset_val = float(getattr(node, "_reset_val", 0.0))
    spike_key = getattr(node, "_spike_key", None)
    lo, hi = (node._reset_lo, node._reset_hi) if spiking else (0, 0)
    out_lo, out_hi = node._start, node._stop

    def split_states(y):
        return {q: y[..., a:b] for q, a, b in slices}

    def src_fn(y, args):
        """Coupling source rows: elementwise in the state."""
        states = split_states(y)
        shape = y.shape[:-1] + (n,)
        return tuple(rd(states, args).to(y.dtype).expand(shape) for rd in src_readers)

    def step_x(y, s_ins, x, args):
        """One Euler step with the coupling matvec results supplied from
        outside; mirrors the node class's make_step."""
        states = split_states(y)
        a2 = dict(args)
        a2[inp_key] = x
        ext: Dict[str, torch.Tensor] = {}
        for tgt, s_in in zip(tgt_names, s_ins):
            ext[tgt] = ext[tgt] + s_in if tgt in ext else 0.0 + s_in
        reset = None
        if spiking:
            spikes = spike_fn(y[..., lo:hi] - thresh)
            reset = spikes.detach()
            a2[spike_key] = spikes / dt
        d = tile_func(states, a2, ext)
        y_new = torch.cat([states[q] + dt * d[q] for q in state_order], dim=-1)
        if spiking:
            seg = y_new[..., lo:hi] * (1.0 - reset) + reset * reset_val
            y_new = torch.cat((y_new[..., :lo], seg, y_new[..., hi:]), dim=-1)
        if out_reader_alg is not None:
            out = out_reader_alg(states, a2).expand(y.shape[:-1] + (n,))
        else:
            out = y[..., out_lo:out_hi]
        return y_new, out

    return SimpleNamespace(
        wkeys=wkeys, src_fn=src_fn, step_x=step_x, preps=[o[0] for o in ops4],
        mvs=[o[1] for o in ops4], mv_ts=[o[2] for o in ops4], grad_ws=[o[3] for o in ops4],
        n=n, dt=dt, cls_name=cls_name)


def _forward_loop(p, wp, args, y0, xs, with_residuals: bool):
    y = y0
    outs, ys, srcs_t, s_ins_t = [], [], [[] for _ in p.wkeys], [[] for _ in p.wkeys]
    for x in xs.unbind(0):
        srcs = p.src_fn(y, args)
        s_ins = tuple(p.mvs[i](wp[i], s) for i, s in enumerate(srcs))
        y_new, out = p.step_x(y, s_ins, x, args)
        outs.append(out)
        if with_residuals:
            ys.append(y)
            for i in range(len(p.wkeys)):
                srcs_t[i].append(srcs[i])
                s_ins_t[i].append(s_ins[i])
        y = y_new
    res = None
    if with_residuals:
        res = (torch.stack(ys), [torch.stack(s) for s in srcs_t],
               [torch.stack(s) for s in s_ins_t])
    return y, torch.stack(outs), res


def _backward_loop(p, wp, args, xs, ys, s_ins_t, cot_yT, cot_outs, need_x: bool,
                   need_args: List[str]):
    """The reverse sweep.  Returns ``(lam0, deltas per coupling (T, N),
    d_xs or None, {arg: grad})``."""
    K = len(p.wkeys)
    T = ys.shape[0]
    lam = cot_yT
    d_args = {k: None for k in need_args}
    deltas_rev: List[List[torch.Tensor]] = [[] for _ in range(K)]
    d_xs_rev = []

    def add(acc, g):
        if g is None:
            return acc
        return g if acc is None else acc + g

    for t in range(T - 1, -1, -1):
        with torch.enable_grad():
            y_t = ys[t].detach().requires_grad_(True)
            s_leaves = [s_ins_t[i][t].detach().requires_grad_(True) for i in range(K)]
            x_t = xs[t].detach().requires_grad_(need_x)
            leaves = {k: args[k].detach().requires_grad_(True) for k in need_args}
            a_t = {**args, **leaves}
            y_new, out = p.step_x(y_t, s_leaves, x_t, a_t)
            srcs = p.src_fn(y_t, a_t)
        inputs = [y_t, *s_leaves] + ([x_t] if need_x else []) + list(leaves.values())
        g = torch.autograd.grad((y_new, out), inputs, grad_outputs=(lam, cot_outs[t]),
                                allow_unused=True)
        dy1, d_s_in = g[0], g[1:1 + K]
        rest = g[1 + K:]
        if need_x:
            d_xs_rev.append(rest[0] if rest[0] is not None else torch.zeros_like(x_t))
            rest = rest[1:]
        deltas = [d if d is not None else torch.zeros_like(s_ins_t[i][t])
                  for i, d in enumerate(d_s_in)]
        for i in range(K):
            deltas_rev[i].append(deltas[i])
        gsrc = [p.mv_ts[i](wp[i], deltas[i]) for i in range(K)]
        g2 = torch.autograd.grad(srcs, [y_t] + list(leaves.values()), grad_outputs=gsrc,
                                 allow_unused=True)
        lam = add(add(None, dy1), g2[0])
        if lam is None:
            lam = torch.zeros_like(y_t)
        for j, k in enumerate(need_args):
            d_args[k] = add(add(d_args[k], rest[j]), g2[1 + j])
    deltas_t = [torch.stack(d[::-1]) for d in deltas_rev]
    d_xs = torch.stack(d_xs_rev[::-1]) if need_x else None
    return lam.detach(), deltas_t, d_xs, d_args


class _Traj(torch.autograd.Function):
    """``(yT, outs)`` of the trajectory; gradients for the coupling masters
    (deferred), the differentiable args, ``y0`` and ``xs``.  Positional
    inputs: ``p, wp, prep_inside, arg_keys, other_args, n_w, *weights,
    *arg_values, y0, xs``; ``wp`` (the prepped couplings, when given) takes
    no gradient."""

    @staticmethod
    def forward(ctx, p, wp, prep_inside, arg_keys, other_args, n_w, *flat):
        weights = flat[:n_w]
        arg_vals = flat[n_w:n_w + len(arg_keys)]
        y0, xs = flat[-2], flat[-1]
        args = {**other_args, **dict(zip(arg_keys, arg_vals))}
        if prep_inside:
            wp = tuple(p.preps[i](w.detach()) for i, w in enumerate(weights))
        yT, outs, res = _forward_loop(p, wp, args, y0, xs, with_residuals=True)
        ctx.p, ctx.wp, ctx.args, ctx.arg_keys, ctx.n_w = p, wp, args, arg_keys, n_w
        ctx.res = res
        ctx.xs = xs
        ctx.w_dtypes = [w.dtype for w in weights]
        return yT, outs

    @staticmethod
    def backward(ctx, cot_yT, cot_outs):
        p, n_w, arg_keys = ctx.p, ctx.n_w, ctx.arg_keys
        needs = ctx.needs_input_grad[6:]
        need_w, need_a = needs[:n_w], needs[n_w:n_w + len(arg_keys)]
        need_y0, need_x = needs[-2], needs[-1]
        ys, srcs_t, s_ins_t = ctx.res
        if cot_yT is None:
            cot_yT = torch.zeros_like(ys[0])
        if cot_outs is None:
            raise RuntimeError("the trajectory's outputs received no gradient")
        need_args = [k for k, nd in zip(arg_keys, need_a) if nd]
        lam0, deltas_t, d_xs, d_args = _backward_loop(
            p, ctx.wp, ctx.args, ctx.xs, ys, s_ins_t, cot_yT, cot_outs, bool(need_x),
            need_args)
        # the deferred contraction: dW_i = Delta_i^T @ Src_i, one matmul each
        d_w = [p.grad_ws[i](deltas_t[i], srcs_t[i]).to(ctx.w_dtypes[i]) if need_w[i] else None
               for i in range(n_w)]
        d_a = [d_args.get(k) if nd else None for k, nd in zip(arg_keys, need_a)]
        del ctx.res
        return (None, None, None, None, None, None, *d_w, *d_a,
                lam0 if need_y0 else None, d_xs)


def _apply(p, wp, prep_inside: bool, weights: dict, args: dict, y0, xs):
    """Flatten the dicts into ``_Traj``'s positional inputs: tensors (which
    may take a gradient; integer ones never do) and the other args."""
    w_list = [weights[wk] for wk in p.wkeys]
    tensor_keys = [k for k, v in args.items() if isinstance(v, torch.Tensor)]
    other = {k: v for k, v in args.items() if not isinstance(v, torch.Tensor)}
    return _Traj.apply(p, wp, prep_inside, tensor_keys, other, len(w_list), *w_list,
                       *(args[k] for k in tensor_keys), y0, xs)


def _make_euler_traj(p):
    def traj(weights, args, y0, xs):
        return _apply(p, None, True, weights, args, y0, xs)

    return traj


def _make_euler_traj_prepped(p):
    def traj_p(wp, weights, args, y0, xs):
        return _apply(p, tuple(wp), False, weights, args, y0, xs)

    return traj_p


def make_coupled_traj(node, remat_steps: int = 0) -> Tuple[Callable, List[str]]:
    """Build ``traj(weights: dict, args: dict, y0, xs) -> (yT, outs)`` whose
    backward defers every coupling-weight gradient to one matmul after the
    reverse loop.  Returns ``(traj, weight_keys)``.

    ``weights`` maps each coupling key to its matrix (the trainable master);
    ``args`` holds every other vector-field argument; ``xs`` is the
    ``(T, n_in)`` drive fed to the node's input variable."""
    if int(remat_steps) > 1:
        raise NotImplementedError("Checkpointed deferred-gradient trajectories (remat_steps) "
                                  "are not ported yet (ROADMAP Queue 1 item 7).")
    p = _node_pieces(node)
    return _make_euler_traj(p), p.wkeys


def make_coupled_traj_prepped(node):
    """Like :func:`make_coupled_traj`, but the coupling prep (the int8
    quantization of each master) happens outside: ``traj_p(wp, weights,
    args, y0, xs)`` runs on the prepped ``wp`` while the gradients attach to
    the masters in ``weights`` (which the forward never reads).  Used by the
    fused adam + requantize path, where the optimizer step produces the next
    epoch's ``wp``.  Returns ``(traj_p, wkeys, preps)``."""
    p = _node_pieces(node)
    return _make_euler_traj_prepped(p), p.wkeys, p.preps
