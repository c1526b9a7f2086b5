"""The hand-written forward kernels as registered operators (``torch.library``).

``torch.export`` traces a program through PyTorch's dispatcher.  The
package's kernels are launched through ``ctypes`` from Python
(``ops/_build.py``), which a trace cannot see, so a network step that
launches one cannot be exported as it stands.  Registered here, under the
namespace ``rectipy::``, each becomes an operator that an exported program
names and calls.  Every forward kernel of the package is one:

- ``rectipy::qif_sfa_step`` and ``rectipy::qif_sfa_rows_step``: the fused
  QIF+SFA step for one state and for ``B`` trials' states
  (``ops/kernels.py``, ``csrc/qif_sfa_step.cu``);
- ``rectipy::int8_mv`` and ``rectipy::int8_mm``: the int8 products with
  their epilogue for one source and for ``B`` rows (``ops/quant.py``,
  ``csrc/int8_matvec.cu``);
- ``rectipy::int4_mv`` and ``rectipy::int4_mm``: the same for packed int4
  weights (``ops/quant.py``, ``csrc/int4_matvec.cu``);
- ``rectipy::block_int8_mv``: the gathered int8 block contraction with its
  row scales (``ops/quant.py``, ``csrc/block_int8.cu``), on the route
  ``quant.block_int8_mv_route`` picks;
- ``rectipy::generic_fused_step`` and ``rectipy::generic_fused_rows``: the
  generic fused step for one state and for ``B`` trials
  (``ops/generic_fused.py``, ``csrc/generic_fused_step.cuh`` with the tail
  that ``dsl/cuda.py`` generates from the node's template).

Each operator has three implementations: on CUDA tensors the wrapper's
launch (its checks, route and launch counters), on CPU tensors the plain
version the wrapper takes there, and a fake one that gives the output's
shape and dtype alone (what ``torch.export`` traces with).  Scalars cross
the operator boundary as ``float`` arguments of its schema.

**The generic step.**  Its CUDA source is generated per template, and its
plain version runs the template's lowered vector field, a Python function
that no schema can carry.  So its operators take the generated source's
key (``generic_fused.generic_key``, a hash of the text) with the baked
scalars, and a registry of this process maps each key to what the
implementations need: the generated text, which the CUDA implementation
builds (``ops/_build.build_generated``: the same text builds once) and
launches, and, for the CPU implementation, the node's plain step
(:func:`register_generic`, which ``attach_generic_fused_step`` calls) or
the plain step exported as a program of its own at a bundle's shapes.  A
serving bundle carries both, under ``generic/``: :func:`export_generic`
writes them and :func:`load_generic` records them (``serving.py`` calls
both), so a process that builds no network serves it.  A key this process does not know raises, as does a
CPU call whose key has neither; nothing stands in for the kernel.

They are registered with ``torch.library.Library.define``/``impl`` and
``torch.library.register_fake``, not ``torch.library.custom_op``: a
``custom_op`` wraps every call in a Python autograd kernel (which runs
even under ``torch.no_grad()``) and an output-aliasing check, which cost
more than the rest of a served step's host time (``chip_smoke.py`` phase
45 times both registrations of the QIF step's operator).  None of the
kernels has a backward, so no autograd kernel is registered: the fused
steps' CUDA implementations refuse inputs that require grad, as their
wrappers do, and the products take integer operands.

Eager code never calls these operators.  The wrappers call them only while
``torch.export`` traces (``torch.compiler.is_exporting()``) and launch
their kernels directly otherwise: a Python operator adds the dispatcher's
time to every call, and the main path's eager step already loses a quarter
of its time to the host.  So ``Network.run`` costs what it cost before,
and a served program runs the same kernels in the same order.

Importing this module registers the operators; nothing is compiled until a
CUDA implementation first runs.  ``serving.load_network`` imports it when a
bundle's program calls an operator of this namespace.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import torch

from . import generic_fused, kernels, quant

__all__ = ["NAMESPACE", "OPS", "GENERIC_OPS", "GENERIC_DIR", "qif_sfa_step",
           "qif_sfa_rows_step", "int8_mv", "int8_mm", "int4_mv", "int4_mm", "block_int8_mv",
           "generic_fused_step", "generic_fused_rows", "generic_args", "register_generic",
           "generic_source", "export_generic", "load_generic"]

NAMESPACE = "rectipy"
GENERIC_OPS = ("generic_fused_step", "generic_fused_rows")
OPS = ("qif_sfa_step", "qif_sfa_rows_step", "int8_mv", "int8_mm", "int4_mv", "int4_mm",
       "block_int8_mv") + GENERIC_OPS


_lib = torch.library.Library(NAMESPACE, "DEF")

QIF_SCHEMA = ("(Tensor v, Tensor s, Tensor x, Tensor W, Tensor eta, Tensor inp, float dt, "
              "float tau, float tau_s, float tau_x, float k, float alpha, float thresh, "
              "float v_reset) -> Tensor")
INT8_SCHEMA = "(Tensor wq, Tensor xq, Tensor row_scale, Tensor act_scale) -> Tensor"
BLOCK_SCHEMA = "(Tensor bq, Tensor row_scale, Tensor xq, Tensor idx) -> Tensor"
GENERIC_SCHEMA = ("(Tensor[] srcs, Tensor[] Ws, Tensor drive, Tensor[] states, Tensor[] vecs, "
                  "str key, float[] scalars, float dt, float thresh, float reset_val) -> Tensor")


def _register(name: str, schema: str, cpu, cuda, fake):
    _lib.define(name + schema)
    _lib.impl(name, cpu, "CPU")
    _lib.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_lib)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


# --------------------------------------------------------------- QIF+SFA step
def _qif_plain(v, s, x, W, eta, inp, dt, tau, tau_s, tau_x, k, alpha, thresh, v_reset):
    return torch.stack(kernels.qif_sfa_reference_step(
        v, s, x, W, eta, inp, dt=dt, tau=tau, tau_s=tau_s, tau_x=tau_x, k=k, alpha=alpha,
        thresh=thresh, v_reset=v_reset), dim=-2)


def _qif_cuda(v, s, x, W, eta, inp, dt, tau, tau_s, tau_x, k, alpha, thresh, v_reset):
    return kernels.qif_sfa_launch(v, s, x, W, eta, inp, dt=dt, tau=tau, tau_s=tau_s,
                                  tau_x=tau_x, k=k, alpha=alpha, thresh=thresh,
                                  v_reset=v_reset)


def _qif_rows_cuda(v, s, x, W, eta, inp, dt, tau, tau_s, tau_x, k, alpha, thresh, v_reset):
    return kernels.qif_sfa_rows_step(v, s, x, W, eta, inp, dt=dt, tau=tau, tau_s=tau_s,
                                     tau_x=tau_x, k=k, alpha=alpha, thresh=thresh,
                                     v_reset=v_reset)


def _qif_fake(v, *args):
    return v.new_empty((3, v.shape[-1]), dtype=torch.float32)


def _qif_rows_fake(v, *args):
    return v.new_empty((v.shape[0], 3, v.shape[1]), dtype=torch.float32)


#: one fused QIF+SFA step of one state ``(n,)``: ``(3, n)`` rows ``v'``,
#: ``s'``, ``x'`` (``ops.kernels.qif_sfa_step``)
qif_sfa_step = _register("qif_sfa_step", QIF_SCHEMA, _qif_plain, _qif_cuda, _qif_fake)
#: the same for ``B`` trials' states ``(B, n)``: ``(B, 3, n)``
#: (``ops.kernels.qif_sfa_rows_step``, the B-row kernel)
qif_sfa_rows_step = _register("qif_sfa_rows_step", QIF_SCHEMA, _qif_plain, _qif_rows_cuda,
                              _qif_rows_fake)


# ------------------------------------------------------------- int8 products
def _int8_mv_plain(wq, xq, row_scale, act_scale):
    return (quant.int8_dot_plain(wq, xq) * row_scale) * act_scale


def _int8_mv_fake(wq, xq, row_scale, act_scale):
    return wq.new_empty((wq.shape[0],), dtype=torch.float32)


def _int8_mm_plain(wq, xq, row_scale, act_scale):
    return (quant.int8_mm_plain(wq, xq) * row_scale) * act_scale[:, None]


def _int8_mm_fake(wq, xq, row_scale, act_scale):
    return wq.new_empty((xq.shape[0], wq.shape[0]), dtype=torch.float32)


#: the forward int8 matvec with its epilogue, ``(n_out,)`` float32
#: (``ops.quant.int8_mv``)
int8_mv = _register("int8_mv", INT8_SCHEMA, _int8_mv_plain, quant.int8_mv_launch,
                    _int8_mv_fake)
#: the forward int8 product of ``B`` rows with their scales, ``(B, n_out)``
#: float32 (``ops.quant.int8_mm``)
int8_mm = _register("int8_mm", INT8_SCHEMA, _int8_mm_plain, quant.int8_mm_launch,
                    _int8_mm_fake)


def _int4_mv_plain(wp, xq, row_scale, act_scale):
    return (quant.int4_dot_plain(wp, xq) * row_scale) * act_scale


def _int4_mm_plain(wp, xq, row_scale, act_scale):
    return (quant.int4_mm_plain(wp, xq) * row_scale) * act_scale[:, None]


#: the forward int4 matvec of packed weights with its epilogue, ``(n_out,)``
#: float32 (``ops.quant.int4_mv``)
int4_mv = _register("int4_mv", INT8_SCHEMA, _int4_mv_plain, quant.int4_mv_launch,
                    _int8_mv_fake)
#: the forward int4 product of ``B`` rows with their scales, ``(B, n_out)``
#: float32 (``ops.quant.int4_mm``)
int4_mm = _register("int4_mm", INT8_SCHEMA, _int4_mm_plain, quant.int4_mm_launch,
                    _int8_mm_fake)


# ------------------------------------------------------- int8 block product
def _block_fake(bq, row_scale, xq, idx):
    return bq.new_empty((xq.shape[0], bq.shape[0] * bq.shape[2]), dtype=torch.float32)


#: the gathered int8 block contraction with its row scales, ``(B, n_br *
#: bs)`` float32 (``ops.quant.block_int8_mv``)
block_int8_mv = _register("block_int8_mv", BLOCK_SCHEMA, quant.block_int8_mv_plain,
                          quant.block_int8_mv_launch, _block_fake)


# ------------------------------------------------------ generic fused step
class _Generic:
    """What the generic operators need of one generated source (one key):
    its text; the live plain steps of the nodes attached in this process, by
    their baked parameters; and the exported plain steps a bundle brought,
    by operator, parameters and input signature."""

    def __init__(self, source: str):
        self.source = source
        self.steps: Dict[tuple, generic_fused.GenericStep] = {}
        self.programs: Dict[tuple, Callable] = {}


_GENERIC: Dict[str, _Generic] = {}
#: a serving bundle's folder of generated sources and exported plain steps
GENERIC_DIR = "generic"


def _params(scalars, dt: float, thresh: float, reset_val: float) -> tuple:
    """The baked parameters of a generic step as the operators receive them:
    the scalars in the source's order, ``dt``, the threshold and the reset
    value, as floats."""
    return (tuple(float(c) for c in scalars), float(dt), float(thresh), float(reset_val))


def _signature(srcs, Ws, drive, states, vecs) -> tuple:
    """The shapes and dtypes of one call's tensors, group by group (tensors
    or the fake values of a traced call)."""
    def group(ts):
        return tuple((tuple(int(d) for d in t.shape), str(t.dtype).replace("torch.", ""))
                     for t in ts)

    return (group(srcs), group(Ws), group([drive]), group(states), group(vecs))


def register_generic(step: "generic_fused.GenericStep") -> str:
    """Record a node's generic step under its source's key (its plain
    version serves the CPU implementation in this process); returns the
    key."""
    key = generic_fused.generic_key(step.source)
    entry = _GENERIC.setdefault(key, _Generic(step.source))
    entry.steps[_params(step.scalars.values(), step.dt, step.thresh, step.reset_val)] = step
    return key


def _entry(key: str) -> _Generic:
    entry = _GENERIC.get(key)
    if entry is None:
        raise RuntimeError(
            f"The generic fused step's generated source {key!r} is not known to this process "
            f"(attach_generic_fused_step records it; serving.load_network records a "
            f"bundle's)")
    return entry


def generic_source(key: str) -> str:
    """The generated source of ``key``; an unknown key raises ``RuntimeError``."""
    return _entry(key).source


def generic_args(step, srcs, Ws, drive, states, vecs) -> tuple:
    """A generic step's call as the operators' arguments; records the step."""
    return (list(srcs), list(Ws), drive, list(states), list(vecs), register_generic(step),
            [float(c) for c in step.scalars.values()], float(step.dt), float(step.thresh),
            float(step.reset_val))


def export_generic(nodes, path: str, cpu: bool, export: Callable) -> dict:
    """Write a serving bundle's generic steps: for every call of a generic
    operator among ``nodes`` (an exported graph's calls of this namespace),
    its key's generated source to ``path/generic/<key>.cu`` and, when
    ``cpu``, the plain step of each distinct call (operator, baked scalars,
    shapes) as a program of its own, ``export(fn, example_inputs)`` at those
    shapes, for the CPU implementation of a process that attaches no node.
    Returns what ``meta.json`` lists under ``generic``."""
    plains = {"generic_fused_step": generic_fused.generic_fused_step_plain,
              "generic_fused_rows": generic_fused.generic_fused_rows_plain}
    generic, seen = {}, set()
    for node in nodes:
        op = node.target._schema.name.split("::")[1]
        if op not in GENERIC_OPS:
            continue
        srcs, Ws, drive, states, vecs, key, scalars, dt, thresh, reset_val = node.args
        groups = [[a.meta["val"] for a in group] for group in (srcs, Ws, [drive], states, vecs)]
        params = _params(scalars, dt, thresh, reset_val)
        signature = _signature(groups[0], groups[1], groups[2][0], groups[3], groups[4])
        if not generic:
            os.makedirs(os.path.join(path, GENERIC_DIR))
        entry = generic.setdefault(key, {"source": f"{GENERIC_DIR}/{key}.cu", "programs": []})
        if not cpu or (key, op, params, signature) in seen:
            continue
        seen.add((key, op, params, signature))
        step = _entry(key).steps.get(params)
        if step is None:
            raise RuntimeError(f"export_network: the generic step {key!r} is not attached in "
                               f"this process")
        counts = [len(group) for group in signature]

        def fn(*flat, step=step, counts=counts, plain=plains[op]):
            parts = []
            for c in counts:
                parts.append(list(flat[:c]))
                flat = flat[c:]
            return plain(step, parts[0], parts[1], parts[2][0], parts[3], parts[4])

        example = [torch.zeros(shape, dtype=getattr(torch, dtype))
                   for group in signature for shape, dtype in group]
        file = f"{GENERIC_DIR}/{key}_{len(entry['programs'])}.pt2"
        torch.export.save(export(fn, example), os.path.join(path, file))
        entry["programs"].append({
            "op": op, "params": [list(params[0]), *params[1:]], "file": file,
            "signature": [[[list(shape), dtype] for shape, dtype in group]
                          for group in signature]})
    for key, entry in generic.items():
        with open(os.path.join(path, entry["source"]), "w") as f:
            f.write(generic_source(key))
    return generic


def load_generic(path: str, generic: dict, device: torch.device,
                 load_program: Callable) -> None:
    """Record the generic steps of the bundle at ``path`` (``generic``, its
    ``meta.json`` entry) with this process: each key's generated source (a
    text whose hash is not its key raises ``ValueError``), built on CUDA (a
    source nvcc refuses raises), and on the CPU each exported plain step,
    ``load_program(file)`` of the bundle's file."""
    for key, entry in generic.items():
        with open(os.path.join(path, entry["source"])) as f:
            source = f.read()
        if generic_fused.generic_key(source) != key:
            raise ValueError(f"The generated source of the generic step {key!r} does not "
                             f"hash to its key")
        known = _GENERIC.setdefault(key, _Generic(source))
        if device.type == "cuda":
            generic_fused.build_source(source)
            continue
        for call in entry["programs"]:
            if call["op"] not in GENERIC_OPS:
                raise ValueError(f"{call['op']!r} is not one of {GENERIC_OPS}")
            signature = tuple(tuple((tuple(shape), dtype) for shape, dtype in group)
                              for group in call["signature"])
            known.programs[(call["op"], _params(*call["params"]), signature)] = load_program(
                os.path.join(path, call["file"]))


def _generic_cpu(op: str, plain):
    def impl(srcs, Ws, drive, states, vecs, key, scalars, dt, thresh, reset_val):
        entry = _entry(key)
        params = _params(scalars, dt, thresh, reset_val)
        program = entry.programs.get((op, params, _signature(srcs, Ws, drive, states, vecs)))
        if program is not None:
            return program(*srcs, *Ws, drive, *states, *vecs)[0]
        step = entry.steps.get(params)
        if step is None:
            raise RuntimeError(
                f"rectipy::{op}: no plain step of the generated source {key!r} with these "
                f"parameters and shapes in this process (attach the node, or load a bundle "
                f"exported for the CPU)")
        return plain(step, srcs, Ws, drive, states, vecs)

    return impl


def _generic_cuda(launch):
    def impl(srcs, Ws, drive, states, vecs, key, scalars, dt, thresh, reset_val):
        return launch(generic_source(key), srcs, Ws, drive, states, vecs, scalars, dt, thresh,
                      reset_val)

    return impl


def _generic_fake(srcs, Ws, drive, states, vecs, *args):
    return drive.new_empty((len(states), drive.shape[-1]), dtype=torch.float32)


def _generic_rows_fake(srcs, Ws, drive, states, vecs, *args):
    B = next(t.shape[0] for t in list(states) + list(srcs) + [drive] if t.dim() == 2)
    return drive.new_empty((B, len(states), drive.shape[-1]), dtype=torch.float32)


#: one generic fused step of one state: ``(V, n)`` float32, the updated
#: state rows or, in derivative mode, the vector field
#: (``ops.generic_fused.generic_fused_step``)
generic_fused_step = _register(
    "generic_fused_step", GENERIC_SCHEMA,
    _generic_cpu("generic_fused_step", generic_fused.generic_fused_step_plain),
    _generic_cuda(generic_fused.generic_step_launch), _generic_fake)
#: the same for ``B`` trials: ``(B, V, n)`` (``ops.generic_fused.generic_fused_rows``)
generic_fused_rows = _register(
    "generic_fused_rows", GENERIC_SCHEMA,
    _generic_cpu("generic_fused_rows", generic_fused.generic_fused_rows_plain),
    _generic_cuda(generic_fused.generic_rows_launch), _generic_rows_fake)
