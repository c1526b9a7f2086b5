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

The trajectory is a loop of *stages*: stage ``j`` reads a source
``producer_j(C, svals[:j], x, args)`` (a function of the carried state
``C``, the results of earlier stages and the drive) and contracts it,
``svals[j] = mv_j(W_j, src_j)``; then ``final(C, svals, x, args)`` advances
the carry and reads the output with every stage result supplied from
outside.  ``traj(weights, args, C0, xs) -> (CT, outs)``:

- forward: one loop, saving the pre-step carry ``C_t``, the stage sources
  ``src_t`` and the stage results (O(T*N) memory); with ``remat_steps=K``
  only the carry at the start of each K-step chunk;
- backward: one reverse loop carrying the carry's cotangent.  Per step it
  takes the VJP of ``final`` (``torch.autograd.grad`` on detached leaves),
  then peels the stages in reverse: each finished ``delta_j`` goes through
  ``W_j^T`` and the producer's VJP into the earlier stages' cotangents and
  the carry's.  A chunked trajectory recomputes one chunk's residuals at a
  time.  Afterwards each ``dW`` is one contraction.  Only the cotangents
  that ``ctx.needs_input_grad`` asks for are computed.

The population trajectory here (``make_coupled_traj``) is that loop with
the state vector as the carry: one stage per coupling for Euler, two for
Heun (the sources at the state and at the full-Euler midpoint, whose ``dW``
contributions add).  ``ops/graph_bptt.py`` builds the multi-population
graph trajectory on the same loop.

Surrogate spikes, the detached hard resets and the pre/post-update outputs
follow each node class (``nodes.py`` ``make_step``).  ``fit_bptt_batch``
runs the same trajectory on ``B`` trials at once: the carry is ``(B, S)``,
``xs`` is time-major ``(T, B, n_in)``, the per-step products take ``(B,
n)`` rows (``ops/quant.py``'s ``int8_mm``/``int8_mm_t`` for an
``int8_master`` coupling), and each ``dW`` is still ONE contraction, over
trials and time.

Scope: DSL-built ``RateNet`` (Euler or Heun), ``SpikeResetNet``,
``SpikeNet`` and ``MultiSpikeResetNet`` (Euler), with at least one coupling
(the graph trajectory also admits populations without one), dense in
float32/float64/bfloat16 or a master coupling (``bfloat16_master``,
``int8_master``, ``int4_master``), or block-sparse (float,
``bfloat16_master`` or ``int8_master``: the gather, scatter and per-block
contractions of ``_make_sparse_matvec`` and ``ops/quant.py``'s
``make_block_int8_ops``).  ``remat_steps`` is Euler-only here, as in the
JAX package (the graph trajectory checkpoints Heun populations too).
Anything else, frozen ``int8``/``int4`` included, raises ``ValueError`` as
in the JAX package, and the caller then takes plain autograd.

On a population shard (``comm``) every coupling above trains: a quantized
one's transposed product takes its scale over the model group and adds the
ranks' integer sums, so it gives the whole cotangent of the gathered source
(``presummed``: the gather then sums nothing more), the unsharded numbers.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, List, Tuple

import torch

__all__ = ["heun_fns", "make_coupled_traj", "make_coupled_traj_prepped", "staged_traj"]


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``(T, n)`` factors as they are; ``(T, B, n)`` flattened to ``(T*B,
    n)``, so that dW contracts trials and time in one product."""
    return t.reshape(-1, t.shape[-1])


def _make_matvec(cast, group=None):
    """Coupling contraction 4-tuple ``(prep, mv, mv_t, grad_w)`` matching
    ``dsl.lower``'s matvec numerics.  ``prep(w)`` runs once per trajectory;
    ``mv``/``mv_t`` take the prepped representation.  ``group``: a
    population shard's quantized coupling rows, whose ``mv_t`` gives the
    whole cotangent of the gathered source (``ops/quant.py``)."""
    if cast == "int8":  # int8_master quantized training (ops/quant.py)
        from .quant import int8_master_ops

        return int8_master_ops(group)
    if cast == "int4":  # int4_master quantized training (ops/quant.py)
        from .quant import int4_master_ops

        return int4_master_ops(group)
    from ..dsl.lower import _bf16_matvec, _bf16_values, _float_matvec, matvec

    if cast == "bf16":  # bfloat16_master: bf16 x bf16 products, float32 sums
        def mv_t_bf16(w, delta):
            return matvec(w.transpose(-1, -2),
                          delta.to(torch.bfloat16).to(torch.float32)).to(delta.dtype)

        def grad_w_bf16(deltas, srcs):
            """dW = Delta^T @ Src on bf16-rounded factors, float32 sums."""
            return (_rows(deltas).to(torch.bfloat16).to(torch.float32).T
                    @ _rows(srcs).to(torch.bfloat16).to(torch.float32))

        # prep rounds the master to bf16 once per trajectory (held in float32)
        return _bf16_values, _bf16_matvec, mv_t_bf16, grad_w_bf16

    def prep(w):
        return w

    def mv_t(w, delta):
        """W^T @ delta with the forward matvec's precision policy (a
        per-trial ``(B, n_out, n_in)`` W, swept frozen, per trial)."""
        wt = w.transpose(-1, -2)
        if w.dtype in (torch.bfloat16, torch.float16):
            out = matvec(wt.to(torch.float32), delta.to(w.dtype).to(torch.float32))
            return out.to(delta.dtype)
        if w.dtype != delta.dtype:
            dt = torch.promote_types(w.dtype, delta.dtype)
            return matvec(wt.to(dt), delta.to(dt)).to(delta.dtype)
        return matvec(wt, delta)

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


def _make_sparse_matvec(cast, cols, n_bc: int = None):
    """Block-sparse ``(prep, mv, mv_t, grad_w)`` of a float or
    ``bfloat16_master`` coupling (the JAX package's ``_make_sparse_matvec``);
    ``cols (n_br, cb)`` is its block structure.  The contractions round to
    float32 as that package's ``preferred_element_type=float32`` does (at
    float64 they sum in float64 and round once), and bfloat16 operands
    multiply exactly with float32 sums.  ``RECTIPY_SPARSE_BWD`` picks the
    transposed contraction's reduction over column blocks when the ops are
    built: ``scatter`` (default: contract in the forward tile layout and
    add the ``(n_br, cb, bs)`` contributions into their column blocks),
    ``onehot`` (the same contraction, the reduction a product with the
    constant one-hot membership matrix) or ``gather`` (each column block's
    incoming tiles through the transposed structure); all give the same
    gradient up to float32 summation order.  ``n_bc``: the source's column
    blocks, where ``cols`` holds some of the block rows (a population
    shard's; default: a square coupling's ``n_br``)."""
    from .quant import _np_cols, _onehot_col_matrix, _transposed_block_table, block_grad_w
    from .quant import sparse_bwd_mode
    from .sparse import block_contract, block_sparse_matvec

    bf16 = cast == "bf16"
    cols_np = _np_cols(cols)
    n_br, cb = cols_np.shape
    n_bc = n_bc or n_br
    cols_t = torch.as_tensor(cols_np)
    mode = sparse_bwd_mode()
    table = _transposed_block_table(cols_np, n_bc) if mode == "gather" else None
    onehot = _onehot_col_matrix(cols_np, n_bc) if mode == "onehot" else None

    def prep(w):
        if bf16 and w.dtype not in (torch.bfloat16, torch.int8):
            return w.to(torch.bfloat16)
        return w

    def mv(w, src):
        cast_dtype = torch.bfloat16 if (bf16 or w.dtype == torch.bfloat16) else None
        return block_sparse_matvec(w, cols_t.to(w.device), src, cast_dtype=cast_dtype)

    def mv_t(w, delta):
        """``A^T @ delta`` for the recurrent block-sparse ``A`` (its
        ``n_bc`` column blocks), float32-rounded, in ``delta``'s dtype."""
        bs = w.shape[-2]
        lead = delta.shape[:-1]
        d_blk = delta.reshape(-1, n_br, bs)
        L, dev = d_blk.shape[0], w.device
        wc, dc = w, d_blk
        if bf16 or w.dtype == torch.bfloat16:
            wc, dc = w.to(torch.bfloat16), d_blk.to(torch.bfloat16)
        acc = torch.float64 if torch.float64 in (wc.dtype, dc.dtype) else torch.float32
        if mode == "gather":
            rows_T, slot_T, mask_T = (t.to(dev) for t in table)
            G = wc[rows_T, slot_T]  # (n_bc, cb_t, bs, bs)
            D = dc[:, rows_T] * mask_T[..., None].to(dc.dtype)  # (L, n_bc, cb_t, bs)
            # out[l, q, j] = sum_c sum_i G[q, c, i, j] D[l, q, c, i]
            out = block_contract(G.transpose(-1, -2), D, acc).to(torch.float32)
        else:
            # contrib[l, r, c, j] = sum_i w[r, c, i, j] d[l, r, i]: the
            # forward layout with the blocks transposed and d repeated per slot
            contrib = block_contract(wc.transpose(-1, -2).reshape(n_br * cb, 1, bs, bs),
                                     dc[:, :, None].expand(L, n_br, cb, bs).reshape(
                                         L, n_br * cb, 1, bs), acc).to(torch.float32)
            contrib = contrib.reshape(L, n_br * cb, bs)
            if mode == "onehot":
                out = torch.einsum("lkj,kq->lqj", contrib, onehot.to(dev))
            else:
                out = torch.zeros((L, n_bc, bs), dtype=torch.float32, device=dev)
                out = out.index_add(1, cols_t.to(dev).reshape(-1), contrib)
        return out.reshape(*lead, n_bc * bs).to(delta.dtype)

    def grad_w(deltas, srcs):
        """``dA[r, c] = sum_t delta_t[row block r] (x) src_t[block cols[r,
        c]]``: one batched contraction over the saved trajectories (and
        trials), float32."""
        return block_grad_w(deltas, srcs, cols_t, cast=torch.bfloat16 if bf16 else None)

    return prep, mv, mv_t, grad_w


# ------------------------------------------------------------ the node pieces
def _node_pieces(node, allow_no_coupling: bool = False, comm=None):
    """Validate a node for deferred-gradient BPTT and build its per-population
    machinery: coupling source readers, the coupling-free step function and
    the per-coupling contractions.  Shared by the population trajectory and
    the graph trajectory (``ops/graph_bptt.py``), which admits populations
    without a coupling (``allow_no_coupling``: all their coupling rides on
    edges).  ``comm`` (``parallel/comm.TrajectoryComm``): the node is a
    population shard (``RateNet._shard``) whose couplings hold its rows;
    ``gathered(key, src)`` makes a coupling's source whole."""
    vf = getattr(node, "_vf", None)
    if vf is None or vf.tile_func is None:
        raise ValueError("Deferred-gradient BPTT requires a DSL-built node (raw-constructor "
                         "nodes use plain autograd).")
    if getattr(node, "_fused_attached", False):
        raise ValueError("Deferred-gradient BPTT requires the standard state layout; build a "
                         "fresh node without a fused kernel.")
    cls_name = type(node).__name__
    if cls_name not in ("RateNet", "SpikeResetNet", "SpikeNet", "MultiSpikeResetNet"):
        raise ValueError(f"Deferred-gradient BPTT does not support {cls_name} nodes")
    integrator = getattr(node, "integrator", "euler")
    if integrator not in ("euler", "heun"):
        raise ValueError(f"Deferred-gradient BPTT does not support integrator={integrator!r}")
    heun = integrator == "heun"  # nodes.py restricts heun to RateNet (no spikes)
    wkeys = [wk for _, _, wk in vf.couplings]
    if not wkeys and not allow_no_coupling:
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
    # a shard's quantized couplings take their scales over the model group
    # and give the whole cotangent of the gathered source (presummed)
    presummed = comm is not None and vf.coupling_cast in ("int8", "int4")
    ops4 = []
    for wk in wkeys:
        if node._args[wk].dim() == 4:  # a block-sparse coupling (its structure in __cols)
            n_bc = node._args[wk].shape[0] * (comm.size if comm is not None else 1)
            if vf.coupling_cast == "int8":
                from .quant import make_block_int8_ops

                ops4.append(make_block_int8_ops(node._args[wk + "__cols"], n_bc, comm))
            else:
                ops4.append(_make_sparse_matvec(vf.coupling_cast, node._args[wk + "__cols"],
                                                n_bc))
        else:
            ops4.append(_make_matvec(vf.coupling_cast, comm))

    # spiking configuration per node class (nodes.py make_step of each):
    # (surrogate keys, (lo, hi), hard reset)
    spike_fn = getattr(node, "spike", None)
    thresh = float(getattr(node, "_thresh", 0.0))
    reset_val = float(getattr(node, "_reset_val", 0.0))
    if cls_name == "SpikeResetNet":
        spike_specs = [((node._spike_key,), (node._reset_lo, node._reset_hi))]
    elif cls_name == "SpikeNet":
        spike_specs = [((node._spike_key, node._reset_key), (node._spike_lo, node._spike_hi))]
    elif cls_name == "MultiSpikeResetNet":
        spike_specs = [((k,), seg) for k, seg in zip(node._spike_keys, node._segments)]
    else:
        spike_specs = []
    post_out = cls_name in ("SpikeNet", "MultiSpikeResetNet")
    out_lo, out_hi = node._start, node._stop

    def split_states(y):
        return {q: y[..., a:b] for q, a, b in slices}

    def src_fn(y, args):
        """Coupling source rows: elementwise in the state."""
        states = split_states(y)
        shape = y.shape[:-1] + (n,)
        return tuple(rd(states, args).to(y.dtype).expand(shape) for rd in src_readers)

    def ext_of(s_ins):
        ext: Dict[str, torch.Tensor] = {}
        for tgt, s_in in zip(tgt_names, s_ins):
            ext[tgt] = ext[tgt] + s_in if tgt in ext else 0.0 + s_in
        return ext

    def read_out(y, a2):
        if out_reader_alg is not None:
            return out_reader_alg(split_states(y), a2).expand(y.shape[:-1] + (n,))
        return y[..., out_lo:out_hi]

    def step_x(y, s_ins, x, args):
        """One Euler step with the coupling matvec results supplied from
        outside; mirrors the node class's make_step."""
        states = split_states(y)
        a2 = dict(args)
        a2[inp_key] = x
        resets = []
        for keys, (lo, hi) in spike_specs:
            spikes = spike_fn(y[..., lo:hi] - thresh)
            if cls_name == "SpikeNet":
                sp = spikes / dt
                a2[keys[0]] = sp
                a2[keys[1]] = sp.detach()
            else:
                resets.append((lo, hi, spikes.detach()))
                a2[keys[0]] = spikes / dt
        d = tile_func(states, a2, ext_of(s_ins))
        y_new = torch.cat([states[q] + dt * d[q] for q in state_order], dim=-1)
        for lo, hi, reset in resets:
            seg = y_new[..., lo:hi]
            if cls_name == "MultiSpikeResetNet":
                seg = torch.where(reset > 0.0, reset_val, seg)
            else:
                seg = seg * (1.0 - reset) + reset * reset_val
            y_new = torch.cat((y_new[..., :lo], seg, y_new[..., hi:]), dim=-1)
        return y_new, read_out(y_new if post_out else y, a2)

    def gathered(key, src):
        """A coupling's source made whole (a shard's; its cotangent
        summed over the ranks unless the transposed product gives the
        whole one already, as the quantized couplings' do)."""
        return src if comm is None else comm.gather(key, src, not presummed)

    def out_pre(y, args):
        """The output read from a state (the pre-update output of the
        classes with ``post_out`` false; the fed-back output of all)."""
        return read_out(y, args)

    return SimpleNamespace(
        heun=heun, wkeys=wkeys, src_fn=src_fn, step_x=step_x, ext_of=ext_of,
        preps=[o[0] for o in ops4], mvs=[o[1] for o in ops4], mv_ts=[o[2] for o in ops4],
        grad_ws=[o[3] for o in ops4], gathered=gathered, comm=comm, n=n, dt=dt,
        state_order=state_order,
        split_states=split_states, tile_func=tile_func, inp_key=inp_key,
        src_readers=src_readers, post_out=post_out, out_pre=out_pre, read_out=read_out)


def heun_fns(p):
    """Heun (RK2) stage functions of a node-pieces bundle: ``src2_fn(y, s1,
    x, args)``, the coupling sources at the full-Euler midpoint (a function
    of the stage-1 matvec results, so its VJP routes cotangents into both),
    and ``step_x2(y, s1, s2, x, args)``, mirroring ``RateNet.make_step``
    with ``integrator='heun'``.  Shared by the population trajectory and the
    graph trajectory."""
    src_readers, n, dt, state_order = p.src_readers, p.n, p.dt, p.state_order

    def _mid(y, s1, x, args):
        states = p.split_states(y)
        a2 = dict(args)
        a2[p.inp_key] = x
        d1 = p.tile_func(states, a2, p.ext_of(s1))
        mid = {q: states[q] + dt * d1[q] for q in state_order}
        return states, a2, d1, mid

    def src2_fn(y, s1, x, args):
        _, _, _, mid = _mid(y, s1, x, args)
        shape = y.shape[:-1] + (n,)
        return tuple(rd(mid, args).to(y.dtype).expand(shape) for rd in src_readers)

    def step_x2(y, s1, s2, x, args):
        states, a2, d1, mid = _mid(y, s1, x, args)
        d2 = p.tile_func(mid, a2, p.ext_of(s2))
        y_new = torch.cat([states[q] + (dt * 0.5) * (d1[q] + d2[q]) for q in state_order],
                          dim=-1)
        return y_new, p.read_out(y, a2)

    return src2_fn, step_x2


# ------------------------------------------------------------------- trees
def _tree_flatten(tree, prefix=()) -> Tuple[list, list]:
    """``(paths, leaves)`` of a nested dict (insertion order); a bare value
    is the one leaf at ``()`` and an empty dict is a leaf of its own, so
    that :func:`_tree_unflatten` rebuilds the skeleton."""
    if isinstance(tree, dict) and tree:
        paths, leaves = [], []
        for k, v in tree.items():
            p, lv = _tree_flatten(v, prefix + (k,))
            paths += p
            leaves += lv
        return paths, leaves
    return [prefix], [tree]


def _tree_unflatten(paths, leaves):
    if list(paths) == [()]:
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = dict(leaf) if isinstance(leaf, dict) else leaf
    return out


def _split_tree(tree) -> Tuple[list, list, list]:
    """``(tensor paths, tensors, [(path, other leaf)])`` of a tree."""
    paths, leaves = _tree_flatten(tree)
    t_paths = [p for p, v in zip(paths, leaves) if isinstance(v, torch.Tensor)]
    tensors = [v for v in leaves if isinstance(v, torch.Tensor)]
    others = [(p, v) for p, v in zip(paths, leaves) if not isinstance(v, torch.Tensor)]
    return t_paths, tensors, others


def _join_tree(t_paths, tensors, others):
    return _tree_unflatten(list(t_paths) + [p for p, _ in others],
                           list(tensors) + [v for _, v in others])


def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _diff(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


# ------------------------------------------------------------ staged loop
def _forward_loop(prog, wp, args, C0, xs, with_residuals: bool):
    """The forward loop: ``(CT, outs, residuals)``; the residuals are the
    pre-step carries and each stage's sources and results, stacked over
    time (carries as a list of trees)."""
    S = len(prog.stages)
    comm = getattr(prog, "comm", None)
    C, outs = C0, []
    Cs, srcs_t, svals_t = [], [[] for _ in range(S)], [[] for _ in range(S)]
    for x in xs.unbind(0):
        if comm is not None:
            comm.forward_step(with_residuals)
        srcs, svals = [], []
        for j, st in enumerate(prog.stages):
            src = st.producer(C, svals, x, args)
            srcs.append(src)
            svals.append(st.mv(wp[j], src))
        C_new, out = prog.final(C, svals, x, args)
        outs.append(out)
        if with_residuals:
            Cs.append(C)
            for j in range(S):
                srcs_t[j].append(srcs[j])
                svals_t[j].append(svals[j])
        C = C_new
    res = None
    if with_residuals:
        res = (Cs, [torch.stack(s) for s in srcs_t], [torch.stack(s) for s in svals_t])
        if comm is not None:  # the gathered sources, for the backward's replay
            res += (comm.take_log(),)
    elif comm is not None:
        comm.done()
    return C, torch.stack(outs), res


def _grad(outputs, inputs, grad_outputs):
    """``torch.autograd.grad`` over the outputs that take a gradient (the
    others contribute nothing); ``None`` for inputs they do not reach."""
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs)
             if isinstance(o, torch.Tensor) and o.requires_grad and g is not None]
    if not pairs or not inputs:
        return [None] * len(inputs)
    return list(torch.autograd.grad([o for o, _ in pairs],
                                    inputs, grad_outputs=[g.to(o.dtype) for o, g in pairs],
                                    allow_unused=True))


def _add(acc, g):
    if g is None:
        return acc
    return g if acc is None else acc + g


def _backward_loop(prog, wp, args, xs, Cs, svals_t, lam, cot_outs, need_x: bool,
                   need_args: List[tuple], d_args: dict, gathered: list = None):
    """The reverse sweep over the steps of ``Cs``.  ``lam`` is the
    cotangent of the carry after the last step (a dict of path -> tensor
    or None); ``d_args`` (path -> gradient) accumulates in place.  Returns
    ``(lam0, deltas per stage (T, ...), d_xs or None)``.  ``gathered``: a
    population shard's per-step log of gathered sources, which the
    recomputed producers replay (``parallel/comm.TrajectoryComm``)."""
    comm = getattr(prog, "comm", None)
    S = len(prog.stages)
    T = len(Cs)
    c_paths = _split_tree(Cs[0])[0]
    deltas_rev: List[List[torch.Tensor]] = [[] for _ in range(S)]
    d_xs_rev = []
    arg_paths, arg_vals, arg_other = _split_tree(args)
    need_idx = [arg_paths.index(p) for p in need_args]
    indep = [j for j, st in enumerate(prog.stages) if not st.reads_svals]
    dep = [j for j, st in enumerate(prog.stages) if st.reads_svals]
    c_other = _split_tree(Cs[0])[2]
    for t in range(T - 1, -1, -1):
        if comm is not None:
            comm.replay_step(gathered[t])
        c_vals = [_tree_get(Cs[t], p) for p in c_paths]
        with torch.enable_grad():
            c_leaves = [v.detach().requires_grad_(_diff(v)) for v in c_vals]
            sv_leaves = [svals_t[j][t].detach().requires_grad_(True) for j in range(S)]
            x_t = xs[t].detach().requires_grad_(need_x)
            a_vals = list(arg_vals)
            for i in need_idx:
                a_vals[i] = arg_vals[i].detach().requires_grad_(True)
            C_t = _join_tree(c_paths, c_leaves, c_other)
            a_t = _join_tree(arg_paths, a_vals, arg_other)
            C_new, out = prog.final(C_t, sv_leaves, x_t, a_t)
        inputs = ([v for v in c_leaves if v.requires_grad] + sv_leaves
                  + ([x_t] if need_x else []) + [a_vals[i] for i in need_idx])
        nc = sum(1 for v in c_leaves if v.requires_grad)
        new_vals = [_tree_get(C_new, p) for p in c_paths]
        g = _grad(new_vals + [out], inputs, [lam.get(p) for p in c_paths] + [cot_outs[t]])
        dC, acc = g[:nc], g[nc:nc + S]
        rest = g[nc + S:]
        d_x = rest[0] if need_x else None
        rest = rest[1:] if need_x else rest
        for j, p in enumerate(need_args):
            d_args[p] = _add(d_args[p], rest[j])
        deltas = [None] * S

        def peel(js):
            """The VJP of the producers ``js`` (whose deltas are final)."""
            nonlocal d_x
            outs_, gs = [], []
            for j in js:
                delta = acc[j] if acc[j] is not None else torch.zeros_like(sv_leaves[j])
                deltas[j] = delta
                if acc[j] is None:
                    continue
                with torch.enable_grad():
                    outs_.append(prog.stages[j].producer(C_t, sv_leaves[:j], x_t, a_t))
                gs.append(prog.stages[j].mv_t(wp[j], delta))
            gp = _grad(outs_, inputs, gs)
            for i in range(nc):
                dC[i] = _add(dC[i], gp[i])
            for i in range(S):
                acc[i] = _add(acc[i], gp[nc + i])
            r = gp[nc + S:]
            if need_x:
                d_x = _add(d_x, r[0])
                r = r[1:]
            for k, p in enumerate(need_args):
                d_args[p] = _add(d_args[p], r[k])

        for j in reversed(dep):  # each adds into the cotangents of earlier stages
            peel([j])
        peel(indep)  # no stage reads their results: one VJP for all
        for j in range(S):
            deltas_rev[j].append(deltas[j])
        if need_x:
            d_xs_rev.append(d_x if d_x is not None else torch.zeros_like(x_t))
        lam = {}
        it = iter(dC)
        for p, v in zip(c_paths, c_leaves):
            lam[p] = next(it) if v.requires_grad else None
    if comm is not None:
        comm.done()
    deltas_t = [torch.stack(d[::-1]) for d in deltas_rev]
    d_xs = torch.stack(d_xs_rev[::-1]) if need_x else None
    return lam, deltas_t, d_xs


class _Traj(torch.autograd.Function):
    """``(*CT leaves, outs)`` of a staged trajectory; gradients for the
    weights (deferred), the differentiable args, the carry's start and
    ``xs``.  Positional inputs: ``prog, R, wp, arg_spec, c_spec, n_w,
    *weights, *arg tensors, *carry tensors, xs``; ``wp`` (the prepped
    weights, when given) takes no gradient."""

    @staticmethod
    def forward(ctx, prog, R, wp, arg_spec, c_spec, n_w, *flat):
        (a_paths, a_other), (c_paths, c_other) = arg_spec, c_spec
        n_a, n_c = len(a_paths), len(c_paths)
        weights = flat[:n_w]
        args = _join_tree(a_paths, flat[n_w:n_w + n_a], a_other)
        C0 = _join_tree(c_paths, flat[n_w + n_a:n_w + n_a + n_c], c_other)
        xs = flat[-1]
        if wp is None:
            wp = prog.prep([w.detach() for w in weights], args)
        T = xs.shape[0]
        if R > 1:
            if T % R:
                raise ValueError(f"remat_steps={R} must divide the trajectory length {T}")
            C, outs, starts = C0, [], []
            for c in range(T // R):
                starts.append(C)
                C, o, _ = _forward_loop(prog, wp, args, C, xs[c * R:(c + 1) * R], False)
                outs.append(o)
            CT, outs, res = C, torch.cat(outs), starts
        else:
            CT, outs, res = _forward_loop(prog, wp, args, C0, xs, with_residuals=True)
        ctx.prog, ctx.R, ctx.wp, ctx.args, ctx.res, ctx.xs = prog, R, wp, args, res, xs
        ctx.spec = (a_paths, n_w, c_paths)
        ctx.weights = [w.detach() for w in weights]
        c_out = [_tree_get(CT, p) for p in c_paths]
        # an output must not be one of the inputs (a carry leaf no step wrote)
        ins = {id(v) for v in flat}
        return (*[v.clone() if id(v) in ins else v for v in c_out], outs)

    @staticmethod
    def backward(ctx, *cots):
        prog, R, wp, args, xs = ctx.prog, ctx.R, ctx.wp, ctx.args, ctx.xs
        a_paths, n_w, c_paths = ctx.spec
        n_a, n_c = len(a_paths), len(c_paths)
        needs = ctx.needs_input_grad[6:]
        need_w, need_a = needs[:n_w], needs[n_w:n_w + n_a]
        need_c, need_x = needs[n_w + n_a:n_w + n_a + n_c], bool(needs[-1])
        cot_C, cot_outs = cots[:n_c], cots[-1]
        if cot_outs is None:
            raise RuntimeError("the trajectory's outputs received no gradient")
        need_args = [p for p, nd in zip(a_paths, need_a) if nd]
        d_args = {p: None for p in need_args}
        lam = dict(zip(c_paths, cot_C))
        S = len(prog.stages)

        def want(st):  # the weight's gradient, or a trained mask's (graph edges)
            return need_w[st.widx] or getattr(st, "mask_path", None) in d_args

        if R > 1:
            # the chunks in reverse: recompute one chunk's residuals, sweep
            # it, and add its contraction into each weight's dW
            dE: Dict[int, torch.Tensor] = {}
            d_xs_c = []
            starts = ctx.res
            for c in range(len(starts) - 1, -1, -1):
                xc = xs[c * R:(c + 1) * R]
                _, _, (Cs, srcs_t, svals_t, *log) = _forward_loop(prog, wp, args, starts[c], xc,
                                                                  True)
                lam, deltas_t, d_xc = _backward_loop(prog, wp, args, xc, Cs, svals_t, lam,
                                                     cot_outs[c * R:(c + 1) * R], need_x,
                                                     need_args, d_args, *log)
                for j, st in enumerate(prog.stages):
                    if want(st):
                        dE[j] = _add(dE.get(j), st.grad_w(deltas_t[j], srcs_t[j]))
                d_xs_c.append(d_xc)
                del Cs, srcs_t, svals_t, deltas_t
            d_xs = torch.cat(d_xs_c[::-1]) if need_x else None
            d_raw = [dE.get(j) for j in range(S)]
        else:
            Cs, srcs_t, svals_t, *log = ctx.res
            lam, deltas_t, d_xs = _backward_loop(prog, wp, args, xs, Cs, svals_t, lam,
                                                 cot_outs, need_x, need_args, d_args, *log)
            d_raw = [st.grad_w(deltas_t[j], srcs_t[j]) if want(st) else None
                     for j, st in enumerate(prog.stages)]
        del ctx.res
        d_w = prog.finish(d_raw, ctx.weights, args, d_args)
        d_w = [g if nd else None for g, nd in zip(d_w, need_w)]
        d_a = [d_args.get(p) if nd else None for p, nd in zip(a_paths, need_a)]
        d_c = [lam.get(p) if nd else None for p, nd in zip(c_paths, need_c)]
        return (None, None, None, None, None, None, *d_w, *d_a, *d_c,
                d_xs if need_x else None)


def staged_traj(prog, remat_steps: int = 0, wp=None):
    """``traj(weights: list, args: tree, C0: tree, xs) -> (CT, outs)`` of a
    staged program (see the module docstring).  ``prog`` holds ``stages``
    (each with ``producer``, ``mv``, ``mv_t``, ``grad_w``, ``widx`` and
    ``reads_svals``), ``final``, ``prep(weights, args)`` (once per
    trajectory, outside the differentiated loop) and ``finish(d_raw,
    weights, args, d_args)`` (the per-stage contractions to per-weight
    gradients).  ``wp`` given: the prepped weights, taken as they are."""
    R = int(remat_steps)

    def traj(weights, args, C0, xs):
        a_paths, a_vals, a_other = _split_tree(args)
        c_paths, c_vals, c_other = _split_tree(C0)
        flat = _Traj.apply(prog, R, wp, (a_paths, a_other), (c_paths, c_other), len(weights),
                           *weights, *a_vals, *c_vals, xs)
        return _join_tree(c_paths, flat[:-1], c_other), flat[-1]

    return traj


# ------------------------------------------------------ population trajectory
def _population_program(p):
    """The population trajectory as a staged program: the state vector is
    the carry; one stage per coupling (Euler), or two (Heun: at the state
    and at the full-Euler midpoint, both contracting the same weight)."""
    K = len(p.wkeys)
    stages = []
    for i in range(K):
        def producer(y, svals, x, args, i=i):
            return p.gathered(("c", i), p.src_fn(y, args)[i])

        stages.append(SimpleNamespace(producer=producer, mv=p.mvs[i], mv_t=p.mv_ts[i],
                                      grad_w=p.grad_ws[i], widx=i, reads_svals=False))
    if p.heun:
        src2_fn, step_x2 = heun_fns(p)
        for i in range(K):
            def producer2(y, svals, x, args, i=i):
                return p.gathered(("c2", i), src2_fn(y, tuple(svals[:K]), x, args)[i])

            stages.append(SimpleNamespace(producer=producer2, mv=p.mvs[i], mv_t=p.mv_ts[i],
                                          grad_w=p.grad_ws[i], widx=i, reads_svals=True))

        def final(y, svals, x, args):
            return step_x2(y, tuple(svals[:K]), tuple(svals[K:]), x, args)
    else:
        def final(y, svals, x, args):
            return p.step_x(y, tuple(svals), x, args)

    def prep(weights, args):
        wp = [p.preps[i](w) for i, w in enumerate(weights)]
        return [wp[st.widx] for st in stages]

    def finish(d_raw, weights, args, d_args):
        """The stages' contractions summed per coupling (Heun: two)."""
        d_w = [None] * K
        for st, d in zip(stages, d_raw):
            if d is not None:
                d = d.to(weights[st.widx].dtype)
                d_w[st.widx] = d if d_w[st.widx] is None else d_w[st.widx] + d
        return d_w

    return SimpleNamespace(stages=stages, final=final, prep=prep, finish=finish, comm=p.comm)


def _population_traj(p, remat_steps: int = 0, wp=None):
    traj = staged_traj(_population_program(p), remat_steps, wp)

    def run(weights, args, y0, xs):
        return traj([weights[wk] for wk in p.wkeys], args, y0, xs)

    return run


def make_coupled_traj(node, remat_steps: int = 0, comm=None) -> Tuple[Callable, List[str]]:
    """Build ``traj(weights: dict, args: dict, y0, xs) -> (yT, outs)`` whose
    backward defers every coupling-weight gradient to one contraction after
    the reverse loop.  Returns ``(traj, weight_keys)``.

    ``weights`` maps each coupling key to its matrix (the trainable master);
    ``args`` holds every other vector-field argument; ``xs`` is the
    ``(T, n_in)`` drive fed to the node's input variable.

    ``remat_steps=K`` (Euler only, ``T`` divisible by ``K``) checkpoints the
    trajectory in K-step chunks: the forward keeps the chunk-entry states
    only (O(T/K) memory instead of O(T) residuals) and the backward
    recomputes each chunk's residuals before its reverse sweep, one more
    forward pass over ``W``.

    ``comm`` (``parallel/comm.TrajectoryComm``): ``node`` is a population
    shard; each step gathers the coupling sources once (the weight rows
    contract the whole source), the backward all-reduces their cotangents,
    and ``dW`` contracts the shard's cotangent rows with the saved whole
    sources."""
    p = _node_pieces(node, comm=comm)
    if p.heun and int(remat_steps) > 1:
        raise ValueError("Deferred-gradient BPTT with remat_steps is Euler-only (Heun takes "
                         "plain autograd, or the graph trajectory, when checkpointing is "
                         "requested).")
    return _population_traj(p, remat_steps), p.wkeys


def make_coupled_traj_prepped(node):
    """Like :func:`make_coupled_traj`, but the coupling prep (the int8
    quantization of each master) happens outside: ``traj_p(wp, weights,
    args, y0, xs)`` runs on the prepped ``wp`` while the gradients attach to
    the masters in ``weights`` (which the forward never reads).  Used by the
    fused adam + requantize path, where the optimizer step produces the next
    epoch's ``wp``.  Euler only, no remat.  Returns ``(traj_p, wkeys,
    preps)``."""
    p = _node_pieces(node)
    if p.heun:
        raise ValueError("prepped-coupling BPTT is Euler-only")

    def traj_p(wp, weights, args, y0, xs):
        return _population_traj(p, 0, list(wp))(weights, args, y0, xs)

    return traj_p, p.wkeys, p.preps
