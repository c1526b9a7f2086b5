"""Deferred-gradient BPTT for multi-population graphs.

Counterpart of ``rectipy_tpu/ops/graph_bptt.py``.  The population
trajectory of ``ops/bptt.py`` generalized to any compiled network of
DSL-built populations and instant nodes joined by linear-family edges:
every large linear contraction inside the loop -- each population's
coupling matvec and each edge projection -- is a *stage* of the staged
loop in ``ops/bptt.py``.  The forward saves only the per-step stage sources
and results (O(N) per step) and the carry; the backward emits the per-stage
cotangents, and every weight gradient becomes ONE contraction after the
loop, where plain autograd would build an ``(n_out, n_in)`` gradient per
step for every trained coupling and edge.

Stages follow the network's topological order.  A stage's source is a
function of the carry ``C = {"Y": population states, "fb": the previous
step's feedback outputs, "E": edge states}``, the results of earlier
stages and the drive: e.g. the source of an edge leaving a spiking
population with a post-update output is that population's stepped output,
which depends on the population's own coupling stages.  The backward peels
the stages in reverse (``ops/bptt.py``).

Feedback edges (``FeedbackNetwork``): the previous step's source output
rides in the carry, each feedback edge is a stage that reads it, and the
step re-reads every feedback source's post-update output into the carry.

Edges: ``Linear`` (2-D, or 1-D diagonal gains), ``LinearMasked`` (the mask
multiplies outside the differentiated loop, so a trained mask's cotangent
``dE * w`` is emitted from the same deferred contraction), ``LinearMemory``
(the shifted, written buffer in ``C["E"]``), ``LinearFilter`` (an extra
filter stage), ``LinearMemoryFilter`` (one filter stage over the whole
``(n, D)`` buffer, whatever the delay depth) and ``BlockSparseLinear``
(``block_dtype`` bfloat16 or ``'int8_master'``, whose forward stage is
``ops/quant.py``'s ``block_int8_mv`` kernel on the card; per-block delays
ride as a rolled, cursor-free buffer that ``spec.estate_pack`` and
``spec.estate_unpack`` convert to and from the edge's circular ``(hist,
t)`` form), as regular or feedback edges.  Populations: those of
``ops/bptt.py``'s ``_node_pieces``, with or without a coupling (Heun
populations get two stages per coupling).  Anything else raises
``ValueError``, and ``fit_bptt`` takes plain autograd.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, List, Tuple

import torch

from .bptt import _add, _make_matvec, _node_pieces, heun_fns, staged_traj

__all__ = ["make_graph_traj"]


def _ident_eff():
    def eff(w, args):
        return w

    def deff(dE, w, args):
        return dE

    return eff, deff


def _edge_ops(w):
    """``(prep, mv, mv_t, grad_w)`` of a linear edge: an ``(n_out, n_in)``
    matvec, or 1-D diagonal gains (per-source elementwise)."""
    if w.dim() == 1:
        def prep(w):
            return w

        def mv(w, s):
            return w * s

        def mv_t(w, d):
            return w * d

        def grad_w(deltas, srcs):
            # each gain's sum runs along its own row: its order does not
            # depend on how many gains there are (a shard's rows sum as
            # the whole vector's do)
            return (deltas * srcs).reshape(-1, deltas.shape[-1]).T.contiguous().sum(-1)

        return prep, mv, mv_t, grad_w
    return _make_matvec(None)


def _filter_matrix_ops():
    """``(prep, mv, mv_t, grad_w)`` of a synaptic filter on the whole ``(n,
    D)`` rolled delay buffer in one stage: ``F @ buf`` is one ``(n, n) x
    (n, D)`` product per step whatever the delay depth, and ``dF`` one
    contraction of the saved ``(T, n, D)`` records."""
    def prep(w):
        return w

    def mv(w, s):
        return w @ s

    def mv_t(w, d):
        return w.T @ d

    def grad_w(deltas, srcs):
        n, D = deltas.shape[-2:]
        return torch.einsum("mid,mjd->ij", deltas.reshape(-1, n, D),
                            srcs.reshape(-1, srcs.shape[-2], D))

    return prep, mv, mv_t, grad_w


def _block_edge_ops(e, group=None):
    """``(prep, mv, mv_t, grad_w)`` of a ``BlockSparseLinear`` edge on the
    delay-resolved ``(..., n_br, cb, bs)`` source stack its producer
    gathers: ``mv`` and ``grad_w`` are batched block contractions, and
    ``mv_t`` returns the cotangent in gathered form (the producer's own VJP
    scatters it into the history buffer or the source vector).
    ``block_dtype`` bfloat16 rounds both operands (the master and the saved
    records stay full precision; sums at float32 or wider); ``'int8_master'``
    quantizes the master once per trajectory and contracts through
    ``ops/quant.py``'s ``make_block_int8_stack_ops`` (``block_int8_mv`` on
    the card), with float32 master gradients; ``group``: an edge into a
    population shard, its dynamic scales the model group's maxima."""
    from .sparse import _bmm, block_contract

    dtype = e.dtype
    if e._int8_master:
        from .quant import make_block_int8_stack_ops

        qprep, qmv, qmv_t, qgrad_w = make_block_int8_stack_ops(group)

        def mv8(wp, s_blk):
            return qmv(wp, s_blk).to(dtype)

        def mv_t8(wp, delta):
            return qmv_t(wp, delta).to(dtype)

        return qprep, mv8, mv_t8, qgrad_w
    bd = e.block_dtype
    acc = torch.float64 if dtype == torch.float64 else torch.float32

    def mb(x):
        return x.to(bd) if bd is not None else x

    def mv(w, s_blk):
        y = block_contract(w, mb(s_blk), acc)
        return y.reshape(*s_blk.shape[:-3], -1).to(dtype)

    def mv_t(w, delta):
        n_br, cb, bs = w.shape[0], w.shape[1], w.shape[2]
        lead = delta.shape[:-1]
        d = mb(delta.reshape(-1, n_br, bs))
        L = d.shape[0]
        x = d.permute(1, 2, 0)[:, None].expand(n_br, cb, bs, L).reshape(n_br * cb, bs, L)
        ds = _bmm(w.reshape(n_br * cb, bs, bs).transpose(1, 2), x, acc)  # (n_br*cb, bs, L)
        return ds.permute(2, 0, 1).reshape(*lead, n_br, cb, bs).to(dtype)

    def grad_w(deltas, srcs):
        # one contraction over the saved records replaces the per-step
        # (n_br, cb, bs, bs) gradient plain autograd would build
        n_br, cb, bs = srcs.shape[-3:]
        d = mb(deltas.reshape(-1, n_br, bs)).to(acc)
        s = mb(srcs.reshape(-1, n_br, cb * bs)).to(acc)
        dW = torch.bmm(d.permute(1, 2, 0), s.permute(1, 0, 2))  # (n_br, bs, cb*bs)
        return dW.reshape(n_br, bs, cb, bs).permute(0, 2, 1, 3).contiguous()

    return mb, mv, mv_t, grad_w


def make_graph_traj(net, remat_steps: int = 0, shard=None) -> Tuple[Callable, SimpleNamespace]:
    """Build ``traj(weights, args, Y0, xs) -> (YT, outs)`` for the whole
    compiled network, whose backward defers every coupling and edge weight
    gradient to one contraction after the reverse loop.

    - ``weights``: a flat dict keyed ``"n:<label>:<wkey>"`` (population
      couplings), ``"e:<ekey>"`` (edge weights) and ``"ef:<ekey>"`` (edge
      filters);
    - ``args``: ``{"nodes": {label: {...}}, "edges": {ekey: {...}}}``, every
      other parameter (masks ride in ``edges``);
    - ``Y0``: the population states by label; ``xs``: ``(T, n_in)``, or
      ``(T, B, n_in)`` with ``(B, S)`` states for ``B`` trials.

    With feedback edges or stateful edges (``spec.needs_carry``) the
    trajectory takes and returns the whole carry ``{"Y": states, "fb":
    previous outputs, "E": edge states}`` instead of ``Y``, the block edges'
    states packed by ``spec.estate_pack`` (``estate_unpack(rolled, orig,
    T)`` turns one back).  ``spec.weight_paths`` lists ``(flatkey, kind,
    label, key)`` per stage, so callers can assemble ``weights`` from the
    params tree; ``spec.pop_labels``, ``has_fb`` and ``stateful_edges`` say
    what the carry holds.

    ``remat_steps=K`` (``T`` divisible by ``K``) checkpoints the trajectory
    in K-step chunks: the forward keeps the chunk-entry carries only and the
    backward recomputes each chunk's stage records (``ops/bptt.py``).

    ``shard`` (``parallel/sharding.NetworkShard``): the trajectory of this
    rank's rows.  Its populations are the shard's local nodes and its edges
    the local edges (their rows of the weights); ``weights``, ``args`` and
    the carry are the placed trees (edge states whole), ``outs`` the output
    node's rows.  Each sharded source is gathered once a step and its
    cotangent all-reduced once in the backward (``parallel/comm.
    TrajectoryComm``).  A leaf that a sharded node or edge holds whole
    gets the gradient of the shard's rows, which the caller sums over the
    model group.  Diagonal gains into a shard hold their rows.  Unfiltered,
    they read the rank's rows of their source with no collective (of a
    source every rank runs whole: its rows, the cotangent summed over the
    model group), and a delayed edge carries its buffer's rows; filtered,
    they read their rows of the filtered gathered source.  An
    ``int8_master`` block edge into a shard takes its stack's scales over
    the model group.  On a model axis of one the shard is the network
    itself."""
    from ..edges import (BlockSparseLinear, Linear, LinearFilter, LinearMasked, LinearMemory,
                         LinearMemoryFilter)
    from ..network import _ekey
    from ..nodes import InstantNode

    if net._compiled is None:
        net.compile()
    order = list(net._compiled["order"])
    preds = {n: sorted(net.graph.predecessors(n)) for n in order}
    out_node = net._out_node
    rows = shard.rows if shard is not None else {}
    comm = shard.traj_comm() if rows else None
    get_node = shard.node if rows else net.get_node
    get_edge = shard.edge if rows else net.get_edge
    fb_edges = shard.fb_edges if rows else net._fb_edge_list()
    fb_by_target: Dict[str, list] = {}
    for u, v, _ in fb_edges:
        fb_by_target.setdefault(v, []).append(u)
    fb_sources = sorted({u for u, _, _ in fb_edges})

    progs: Dict[str, SimpleNamespace] = {}
    inst_steps: Dict[str, Callable] = {}
    for lbl in order:
        node = get_node(lbl)
        if isinstance(node, InstantNode):
            inst_steps[lbl] = node.make_step()
        else:
            progs[lbl] = _node_pieces(node, allow_no_coupling=True,
                                      comm=comm if lbl in rows else None)
    if not progs:
        raise ValueError("Deferred-gradient graph BPTT requires at least one DSL-built "
                         "population.")
    allowed = (Linear, LinearMasked, LinearMemory, LinearFilter, LinearMemoryFilter,
               BlockSparseLinear)
    for u, n, e in ([(u, n, get_edge(u, n)) for n in order for u in preds[n]]
                    + list(fb_edges)):
        if type(e) not in allowed:
            raise ValueError(f"Deferred-gradient graph BPTT requires linear-family edges; "
                             f"edge {u}->{n} is {type(e).__name__}.")
        if n in rows and type(e) is LinearMasked and e.params["weights"].dim() == 1:
            raise ValueError(f"edge {u}->{n}: masked diagonal gains into a population shard "
                             f"take plain autograd (the shard's rows of a whole mask)")

    def own_rows(u, producer, r0, r1):
        """What diagonal gains into a shard's rows ``[r0, r1)`` read of
        their source ``u``: the rank's rows of a sharded source (the same
        rows: its width is the target's), with no collective; those rows
        of a source every rank runs whole, its cotangent summed over the
        model group."""
        if u in rows:
            return producer

        def part(C, svals, x, args):
            return comm.to_partial(producer(C, svals, x, args))[..., r0:r1]
        return part

    def source(u, v, producer, kind: str):
        """The producer of what edge ``u -> v`` reads of its source: a
        sharded source gathered, once a step per kind of consumer (its
        cotangent summed over the model group where the shard's rows
        consume it), a whole source into the shard's rows marked as such
        (summed cotangent).  A stateful edge's buffer or filter state is
        whole on every rank: its cotangent stays the shard's part until the
        source read sums it."""
        if comm is None or (u not in rows and v not in rows):
            return producer
        if u not in rows:
            def partial(C, svals, x, args):
                return comm.to_partial(producer(C, svals, x, args))
            return partial
        summed = v in rows

        def gathered(C, svals, x, args):
            return comm.gather((kind, u, summed), producer(C, svals, x, args), summed)
        return gathered

    # stages along the topological order; a producer sees (C, svals[:j], x,
    # args).  ``reads`` marks producers that read earlier stage results (the
    # backward peels the others together)
    stages: List[SimpleNamespace] = []
    stage_idx: Dict[tuple, int] = {}
    inp_expr: Dict[str, Callable] = {}
    out_expr: Dict[str, Callable] = {}
    inp_reads: Dict[str, bool] = {}
    out_reads: Dict[str, bool] = {}
    weight_paths: List[tuple] = []
    estate_update: Dict[str, Callable] = {}
    estate_pack: Dict[str, Callable] = {}
    estate_unpack: Dict[str, Callable] = {}
    heun_steppers: Dict[str, Callable] = {}

    def stage(flatkey, ops, producer, reads, eff=None, deff=None, mask_path=None):
        if eff is None:
            eff, deff = _ident_eff()
        prep, mv, mv_t, grad_w = ops
        return SimpleNamespace(flatkey=flatkey, prep=prep, mv=mv, mv_t=mv_t, grad_w=grad_w,
                               eff=eff, deff=deff, producer=producer, reads_svals=reads,
                               mask_path=mask_path)

    def block_edge_stage(e, producer, reads, ek, v):
        """The stage of a ``BlockSparseLinear`` edge: the producer emits the
        delay-resolved ``(..., n_br, cb, bs)`` gathered stack.  A delayed
        edge's trajectory carries a cursor-free ROLLED buffer (newest
        column 0, delay ``d`` read at column ``d``: a fixed ``cols * D1 +
        d`` gather), converted at the call boundary; the edge's own int32
        cursor never rides the differentiated carry."""
        bs, nb_in, D1 = e.bs, e.nb_in, e._D1
        cols = e.cols.long()
        edtype = e.dtype
        if e.delays is None:
            def b_producer(C, svals, x, args):
                xv = producer(C, svals, x, args).to(edtype)
                return xv.reshape(*xv.shape[:-1], nb_in, bs)[..., cols, :]
        else:
            flat = cols * D1 + e.delays.long()

            def buf_new(C, svals, x, args):
                xv = producer(C, svals, x, args)
                buf = C["E"][ek]  # (..., nb_in, D1, bs)
                new = xv.to(buf.dtype).reshape(*xv.shape[:-1], nb_in, 1, bs)
                return torch.cat((new, buf[..., :D1 - 1, :]), dim=-2)

            estate_update[ek] = buf_new

            def b_producer(C, svals, x, args):
                b = buf_new(C, svals, x, args)
                return b.reshape(*b.shape[:-3], nb_in * D1, bs)[..., flat, :]

            def b_pack(state):
                # circular slot s holds x(latest t' < t with t' mod D1 == s);
                # rolled[..., j, :] = x(t - 1 - j) (unwritten slots stay zero)
                hist, t = state
                k = torch.arange(D1, device=hist.device)
                return hist.index_select(-2, torch.remainder(t.reshape(-1)[0] - 1 - k, D1))

            def b_unpack(rolled, orig, T):
                # the inverse permutation at t + T
                t1 = orig[1] + T
                k = torch.arange(D1, device=rolled.device)
                idx = torch.remainder(t1.reshape(-1)[0] - 1 - k, D1)
                return torch.zeros_like(rolled).index_copy(-2, idx, rolled), t1

            estate_pack[ek] = b_pack
            estate_unpack[ek] = b_unpack
        return [(stage(f"e:{ek}", _block_edge_ops(e, comm if v in rows else None), b_producer,
                       reads), ("edges", ek, "weights"))]

    def edge_stages(u, nname, e, producer, reads, kind="out"):
        """Stage(s) of one edge, ``[(stage, path)]``; the last stage is the
        edge's output.  Stateless ``Linear``/``LinearMasked``: one stage of
        the source output.  ``LinearMemory``: the stage projects slot 0 of
        the shifted, written buffer (carried in ``C["E"]``).
        ``LinearFilter``: a filter stage of the carried ``y``, then the
        weight stage of ``y' = F @ y + x``.  ``LinearMemoryFilter``: a
        filter stage over the rolled buffer, then the weight stage of the
        written slot 0."""
        ek = _ekey(u, nname)
        if type(e) is BlockSparseLinear:
            return block_edge_stage(e, source(u, nname, producer, kind), reads, ek, nname)
        w = e.params["weights"]
        # diagonal gains into a shard: their rows scale the source's rows
        diag_rows = rows.get(nname) if w.dim() == 1 and type(e) is not LinearMasked else None
        local = diag_rows is not None and type(e) in (Linear, LinearMemory)
        producer = (own_rows(u, producer, *diag_rows) if local
                    else source(u, nname, producer, kind))
        # the ops follow the EFFECTIVE weight: w * mask is 2-D even for 1-D
        # gains, as the edge's (w * mask) @ x
        ops = _edge_ops(e.params["mask"] if type(e) is LinearMasked else w)
        out = []
        if type(e) is LinearMemoryFilter:
            wm = e._write_mask
            fidx = len(stages) + len(out)

            def f_producer(C, svals, x, args):
                return torch.roll(C["E"][ek], -1, dims=-1)

            out.append((stage(f"ef:{ek}", _filter_matrix_ops(), f_producer, False),
                        ("edges", ek, "filter")))

            def buf_new(C, svals, x, args, src=producer):
                x_u = src(C, svals, x, args)
                return svals[fidx] * (1.0 - wm) + wm * x_u[..., None]

            estate_update[ek] = buf_new

            def producer(C, svals, x, args):
                return buf_new(C, svals, x, args)[..., 0]

            reads = True
        elif type(e) is LinearMemory:
            wm = e._write_mask
            if local:  # the carry holds the buffer's rows (whole between chunks)
                r0, r1 = diag_rows
                wm = wm[r0:r1]
                estate_pack[ek] = lambda buf, r0=r0, r1=r1: buf[..., r0:r1, :]
                estate_unpack[ek] = lambda buf, orig, T: comm.gather_rows(buf)

            def buf_new(C, svals, x, args, src=producer):
                x_u = src(C, svals, x, args)
                return torch.roll(C["E"][ek], -1, dims=-1) * (1.0 - wm) + wm * x_u[..., None]

            estate_update[ek] = buf_new

            def producer(C, svals, x, args):
                return buf_new(C, svals, x, args)[..., 0]
        elif type(e) is LinearFilter:
            fidx = len(stages) + len(out)

            def f_producer(C, svals, x, args):
                return C["E"][ek]  # the carried filter state y

            out.append((stage(f"ef:{ek}", _edge_ops(e.params["filter"]), f_producer, False),
                        ("edges", ek, "filter")))

            def y_new(C, svals, x, args, src=producer):
                return svals[fidx] + src(C, svals, x, args)

            estate_update[ek] = y_new
            producer, reads = y_new, True
        if diag_rows is not None and not local:  # a filtered edge: its rows of the whole
            def producer(C, svals, x, args, whole=producer, r0=diag_rows[0], r1=diag_rows[1]):
                return whole(C, svals, x, args)[..., r0:r1]

        if type(e) is LinearMasked:
            diag = w.dim() == 1  # eff[i, j] = w[j] * m[i, j]

            def eff(wv, args):
                return wv * args["edges"][ek]["mask"]

            def deff(dE, wv, args):
                d = dE * args["edges"][ek]["mask"]
                return d.sum(0) if diag else d

            # the mask multiplies in the prep, outside the differentiated
            # loop: its cotangent d(w*m)/dm = w is emitted from the same dE
            out.append((stage(f"e:{ek}", ops, producer, reads, eff, deff,
                              mask_path=("edges", ek, "mask")), ("edges", ek, "weights")))
        else:
            out.append((stage(f"e:{ek}", ops, producer, reads), ("edges", ek, "weights")))
        return out

    def add(st_path, key):
        for st, path in st_path:
            stage_idx[key] = len(stages)  # the last stage is the edge's output
            stages.append(st)
            weight_paths.append((st.flatkey,) + path)

    # feedback-edge stages first: their producers read the carried value only
    for u, v, e in fb_edges:
        def fb_producer(C, svals, x, args, u=u):
            return C["fb"][u]

        add(edge_stages(u, v, e, fb_producer, False, "fb"), ("fb", u, v))

    for nname in order:
        # 1. the stages of this node's input edges (sources: their outputs)
        for u in preds[nname]:
            add(edge_stages(u, nname, get_edge(u, nname), out_expr[u], out_reads[u]),
                ("e", u, nname))

        # 2. the node's input: regular edges (sorted), then feedback, summed
        # as the composed step sums them; a pred-less node takes x first
        idxs = tuple(stage_idx[("e", u, nname)] for u in preds[nname])
        fb_idxs = tuple(stage_idx[("fb", u, nname)] for u in fb_by_target.get(nname, []))
        if idxs or fb_idxs:
            def inp_fn(C, svals, x, args, idxs=idxs, fb_idxs=fb_idxs):
                all_ = idxs + fb_idxs
                v = x + svals[all_[0]] if not idxs else svals[all_[0]]
                for j in all_[1:]:
                    v = v + svals[j]
                return v
        else:
            def inp_fn(C, svals, x, args):
                return x
        inp_expr[nname] = inp_fn
        inp_reads[nname] = bool(idxs or fb_idxs)

        # 3. coupling stages: stage 1 reads the pre-step state; a Heun
        # population's stage 2 reads the full-Euler midpoint, a function of
        # the stage-1 results and the input
        if nname in progs:
            pk = progs[nname]
            for i, wk in enumerate(pk.wkeys):
                def c_producer(C, svals, x, args, nname=nname, i=i, pk=pk):
                    src = pk.src_fn(C["Y"][nname], args["nodes"][nname])[i]
                    return pk.gathered(("c", nname, i), src)

                ops = (pk.preps[i], pk.mvs[i], pk.mv_ts[i], pk.grad_ws[i])
                add([(stage(f"n:{nname}:{wk}", ops, c_producer, False),
                      ("nodes", nname, wk))], ("c", nname, i))
            if pk.heun:
                src2_fn, step_x2 = heun_fns(pk)
                heun_steppers[nname] = step_x2
                c1 = tuple(stage_idx[("c", nname, i)] for i in range(len(pk.wkeys)))
                for i, wk in enumerate(pk.wkeys):
                    def c2_producer(C, svals, x, args, nname=nname, c1=c1, i=i,
                                    src2_fn=src2_fn, pk=pk):
                        s1 = tuple(svals[j] for j in c1)
                        src = src2_fn(C["Y"][nname], s1, inp_expr[nname](C, svals, x, args),
                                      args["nodes"][nname])[i]
                        return pk.gathered(("c2", nname, i), src)

                    ops = (pk.preps[i], pk.mvs[i], pk.mv_ts[i], pk.grad_ws[i])
                    add([(stage(f"n:{nname}:{wk}", ops, c2_producer, True),
                          ("nodes", nname, wk))], ("c2", nname, i))

        # 4. the node's output
        if nname in inst_steps:
            def out_fn(C, svals, x, args, nname=nname):
                return inst_steps[nname](None, args["nodes"].get(nname, {}),
                                         inp_expr[nname](C, svals, x, args))[1]
            out_reads[nname] = inp_reads[nname]
        elif progs[nname].post_out:
            cidx = tuple(stage_idx[("c", nname, i)] for i in range(len(progs[nname].wkeys)))

            def out_fn(C, svals, x, args, nname=nname, cidx=cidx):
                s_ins = tuple(svals[j] for j in cidx)
                return progs[nname].step_x(C["Y"][nname], s_ins,
                                           inp_expr[nname](C, svals, x, args),
                                           args["nodes"][nname])[1]
            out_reads[nname] = bool(cidx) or inp_reads[nname]
        else:
            def out_fn(C, svals, x, args, nname=nname):
                return progs[nname].out_pre(C["Y"][nname], args["nodes"][nname])
            out_reads[nname] = False
        out_expr[nname] = out_fn

    pop_cidx = {lbl: tuple(stage_idx[("c", lbl, i)] for i in range(len(progs[lbl].wkeys)))
                for lbl in progs}
    pop_c2idx = {lbl: tuple(stage_idx[("c2", lbl, i)] for i in range(len(progs[lbl].wkeys)))
                 for lbl in progs if progs[lbl].heun}

    def final(C, svals, x, args):
        """Advance every population one Euler/Heun step with the stage
        results supplied from outside, read the network output, re-read the
        feedback sources' post-update outputs and write the edge states."""
        Y_new = {}
        for lbl in order:
            if lbl in progs:
                s_ins = tuple(svals[j] for j in pop_cidx[lbl])
                inp = inp_expr[lbl](C, svals, x, args)
                if lbl in heun_steppers:
                    s2 = tuple(svals[j] for j in pop_c2idx[lbl])
                    Y_new[lbl] = heun_steppers[lbl](C["Y"][lbl], s_ins, s2, inp,
                                                    args["nodes"][lbl])[0]
                else:
                    Y_new[lbl] = progs[lbl].step_x(C["Y"][lbl], s_ins, inp,
                                                   args["nodes"][lbl])[0]
        out = out_expr[out_node](C, svals, x, args)
        new_fb = {}
        for u in fb_sources:
            if u in progs:
                new_fb[u] = progs[u].out_pre(Y_new[u], args["nodes"][u])
            else:
                new_fb[u] = out_expr[u](C, svals, x, args)
        new_E = {ek: upd(C, svals, x, args) for ek, upd in estate_update.items()}
        return {"Y": Y_new, "fb": new_fb, "E": new_E}, out

    wkeys = list(dict.fromkeys(st.flatkey for st in stages))
    for st in stages:
        st.widx = wkeys.index(st.flatkey)

    def prep(weights, args):
        """Per-stage effective weights (the masking) and precision prep
        (casts, quantization), once per trajectory; a weight two stages
        share (a Heun coupling) is prepped once."""
        cache, wp = {}, []
        for st in stages:
            if st.mask_path is None and st.widx in cache:
                wp.append(cache[st.widx])
                continue
            wp.append(st.prep(st.eff(weights[st.widx], args)))
            if st.mask_path is None:
                cache[st.widx] = wp[-1]
        return wp

    def finish(d_raw, weights, args, d_args):
        """Each stage's contraction through its masking, summed per weight
        (a Heun coupling has two stages); a trained mask's cotangent ``dE *
        w`` into ``d_args``."""
        d_w = [None] * len(wkeys)
        for st, dE in zip(stages, d_raw):
            if dE is None:
                continue
            w = weights[st.widx]
            d_w[st.widx] = _add(d_w[st.widx], st.deff(dE, w, args).to(w.dtype))
            if st.mask_path in d_args:
                d_args[st.mask_path] = _add(d_args[st.mask_path], (dE * w).to(w.dtype))
        return d_w

    prog = SimpleNamespace(stages=stages, final=final, prep=prep, finish=finish, comm=comm)
    core = staged_traj(prog, remat_steps)

    def traj_carry(weights, args, C0, xs):
        CT, outs = core([weights[fk] for fk in wkeys], args, C0, xs)
        return {"Y": CT.get("Y", {}), "fb": CT.get("fb", {}), "E": CT.get("E", {})}, outs

    needs_carry = bool(fb_edges) or bool(estate_update)

    def ident_unpack(s, orig, T):
        return s

    spec = SimpleNamespace(
        weight_paths=weight_paths, pop_labels=sorted(progs), has_fb=bool(fb_edges),
        stateful_edges=sorted(estate_update), needs_carry=needs_carry,
        estate_pack={ek: estate_pack.get(ek, lambda s: s) for ek in estate_update},
        estate_unpack={ek: estate_unpack.get(ek, ident_unpack) for ek in estate_update})
    if needs_carry:
        return traj_carry, spec

    def traj(weights, args, Y0, xs):
        """No feedback and no stateful edge: the carry is the state dict."""
        CT, outs = traj_carry(weights, args, {"Y": Y0, "fb": {}, "E": {}}, xs)
        return CT["Y"], outs

    return traj, spec


def graph_weights_args(spec, params: dict) -> tuple:
    """Split a params tree into the graph trajectory's ``(weights, args)``:
    the stage weights keyed by flat key, everything else in the nested args
    tree."""
    excl = {(kind, label, key) for _, kind, label, key in spec.weight_paths}
    weights = {fk: params[kind][label][key] for fk, kind, label, key in spec.weight_paths}
    args = {sec: {lbl: {k: v for k, v in sub.items() if (sec, lbl, k) not in excl}
                  for lbl, sub in params[sec].items()}
            for sec in ("nodes", "edges")}
    return weights, args
