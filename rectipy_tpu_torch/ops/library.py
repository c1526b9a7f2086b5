"""The hand-written forward kernels as registered operators (``torch.library``).

``torch.export`` traces a program through PyTorch's dispatcher.  The
package's kernels are launched through ``ctypes`` from Python
(``ops/_build.py``), which a trace cannot see, so a network step that
launches one cannot be exported as it stands.  Registered here, under the
namespace ``rectipy::``, each becomes an operator that an exported program
names and calls:

- ``rectipy::qif_sfa_step`` and ``rectipy::qif_sfa_rows_step``: the fused
  QIF+SFA step for one state and for ``B`` trials' states
  (``ops/kernels.py``, ``csrc/qif_sfa_step.cu``);
- ``rectipy::int8_mv`` and ``rectipy::int8_mm``: the int8 products with
  their epilogue for one source and for ``B`` rows (``ops/quant.py``,
  ``csrc/int8_matvec.cu``).

Each operator has three implementations: on CUDA tensors the wrapper's
launch (its checks, route and launch counters), on CPU tensors the plain
version the wrapper takes there, and a fake one that gives the output's
shape and dtype alone (what ``torch.export`` traces with).  Scalars cross
the operator boundary as ``float`` arguments of its schema.

They are registered with ``torch.library.Library.define``/``impl`` and
``torch.library.register_fake``, not ``torch.library.custom_op``: a
``custom_op`` wraps every call in a Python autograd kernel (which runs
even under ``torch.no_grad()``) and an output-aliasing check, which cost
more than the rest of a served step's host time (``chip_smoke.py`` phase
45 times both registrations of the QIF step's operator).  None of the
kernels has a backward, so no autograd kernel is registered: the QIF
step's CUDA implementation refuses inputs that require grad, as its
wrapper does, and the int8 products take integer operands.

Eager code never calls these operators.  The wrappers (``qif_sfa_step``,
``int8_mv``, ``int8_mm``) call them only while ``torch.export`` traces
(``torch.compiler.is_exporting()``) and launch their kernels directly
otherwise: a Python operator adds the dispatcher's time to every call, and
the main path's eager step already loses a quarter of its time to the host.
So ``Network.run`` costs what it cost before, and a served program runs the
same kernels in the same order.

The other kernels of the forward path are not registered yet: the generic
fused step (its CUDA source is generated per template), ``int4_mv``/
``int4_mm`` and ``block_int8_mv``.  Their wrappers raise
:func:`export_refused` while ``torch.export`` traces, so that no exported
program carries a plain stand-in for a kernel.

Importing this module registers the operators; nothing is compiled until a
CUDA implementation first runs.  ``serving.load_network`` imports it when a
bundle's program calls an operator of this namespace.
"""

from __future__ import annotations

import torch

from . import kernels, quant

__all__ = ["NAMESPACE", "OPS", "export_refused", "qif_sfa_step", "qif_sfa_rows_step",
           "int8_mv", "int8_mm"]

NAMESPACE = "rectipy"
OPS = ("qif_sfa_step", "qif_sfa_rows_step", "int8_mv", "int8_mm")


def export_refused(kernel: str) -> NotImplementedError:
    """The error a kernel's wrapper raises while ``torch.export`` traces it,
    for the kernels that are not registered operators yet."""
    return NotImplementedError(
        f"Exporting a program that launches {kernel} is not ported yet (ROADMAP Queue 1 "
        f"entry K): the kernel is not a registered operator, and a bundle must not carry "
        f"its plain version in its place. The network still runs, trains and checkpoints.")


_lib = torch.library.Library(NAMESPACE, "DEF")

QIF_SCHEMA = ("(Tensor v, Tensor s, Tensor x, Tensor W, Tensor eta, Tensor inp, float dt, "
              "float tau, float tau_s, float tau_x, float k, float alpha, float thresh, "
              "float v_reset) -> Tensor")
INT8_SCHEMA = "(Tensor wq, Tensor xq, Tensor row_scale, Tensor act_scale) -> Tensor"


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
