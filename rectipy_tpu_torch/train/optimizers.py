"""Optimizers with optax's formulas and defaults, on dicts of tensors.

Counterpart of ``rectipy_tpu/train/optimizers.py``, which wraps
``optax.inject_hyperparams(optax.<name>)``.  The port does not import optax;
each optimizer here repeats the installed optax's update formulas, defaults
and order of operations (not ``torch.optim``'s: for example rmsprop puts
``eps`` inside the square root, adam has ``eps_root``, adagrad starts its
accumulator at 0.1):

    sgd, adam, adamw, adagrad, adadelta, adamax, rmsprop, rprop

An optimizer is a pair of pure functions on trees (nested dicts) of tensors:
``init(params) -> state`` and ``update(grads, state, params) -> (params',
state')``.  As ``inject_hyperparams`` makes them, the numeric
hyperparameters (the learning rate among them) are values in
``state["hyperparams"]``, converted to the dtype of the first parameter
leaf, and a callable hyperparameter is a schedule of the update count.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

__all__ = ["get_optimizer", "Optimizer", "tree_map", "tree_leaves"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (the order ``jax.tree.leaves`` gives)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


# each optimizer's keyword arguments and defaults (optax 0.2.6); the learning
# rate comes first
_DEFAULTS: Dict[str, dict] = {
    "sgd": dict(momentum=None, nesterov=False),
    "adam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, nesterov=False),
    "adamw": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4,
                  nesterov=False),
    "adagrad": dict(initial_accumulator_value=0.1, eps=1e-7),
    "adadelta": dict(rho=0.9, eps=1e-6, weight_decay=0.0),
    "adamax": dict(b1=0.9, b2=0.999, eps=1e-8),
    "rmsprop": dict(decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True, centered=False,
                    momentum=None, nesterov=False, bias_correction=False),
    "rprop": dict(eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6, max_step_size=50.0),
}

# torch-style kwarg names mapped onto the optax ones
_KWARG_ALIASES = {
    "rprop": {"etas": ("eta_minus", "eta_plus"), "step_sizes": ("min_step_size", "max_step_size")},
    "sgd": {"momentum": "momentum"},
}


def _is_numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _convert(v, dtype):
    """inject_hyperparams' conversion: floats become 0-dim tensors of the
    parameters' dtype; everything else passes through."""
    if isinstance(v, float) or (isinstance(v, torch.Tensor) and v.is_floating_point()):
        return torch.as_tensor(v, dtype=dtype)
    return v


def _bias_correction(moment, decay, count: int):
    bc = 1 - decay ** torch.tensor(count, dtype=torch.int32)
    return tree_map(lambda t: t / bc.to(t.dtype), moment)


def _ema(grads, moments, decay, order: int):
    return tree_map(lambda g, t: (1 - decay) * (g ** order) + decay * t, grads, moments)


def _trace(grads, trace, decay, nesterov: bool):
    new = tree_map(lambda g, t: g + decay * t, grads, trace)
    upd = tree_map(lambda g, t: g + decay * t, grads, new) if nesterov else new
    return upd, new


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def _full(params, value):
    return tree_map(lambda p: torch.full_like(p, float(value)), params)


def _scale(updates, step):
    return tree_map(lambda g: step * g, updates)


def _inner_init(name: str, hp: dict, params) -> dict:
    if name == "sgd":
        return {"trace": _zeros(params)} if hp["momentum"] is not None else {}
    if name in ("adam", "adamw", "adamax"):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}
    if name == "adagrad":
        return {"sum_of_squares": _full(params, hp["initial_accumulator_value"])}
    if name == "adadelta":
        return {"e_g": _zeros(params), "e_x": _zeros(params)}
    if name == "rmsprop":
        st = {"count": 0, "nu": _full(params, hp["initial_scale"])}
        if hp["centered"]:
            st["mu"] = _zeros(params)
        if hp["momentum"] is not None:
            st["trace"] = _zeros(params)
        return st
    if name == "rprop":
        return {"step_sizes": _full(params, hp["learning_rate"]),
                "prev_updates": _zeros(params)}
    raise AssertionError(name)


def _inner_update(name: str, hp: dict, g, st: dict, params):
    """One update of the optax chain: returns ``(updates, inner_state')``."""
    lr = hp["learning_rate"]
    if name == "sgd":
        if hp["momentum"] is not None:
            g, tr = _trace(g, st["trace"], hp["momentum"], hp["nesterov"])
            st = {"trace": tr}
        return _scale(g, -1 * lr), st
    if name in ("adam", "adamw"):
        b1, b2 = hp["b1"], hp["b2"]
        mu = _ema(g, st["mu"], b1, 1)
        nu = _ema(g, st["nu"], b2, 2)
        count = st["count"] + 1
        if hp["nesterov"]:
            mu_hat = tree_map(lambda m, gg: b1 * m + (1 - b1) * gg,
                              _bias_correction(mu, b1, count + 1),
                              _bias_correction(g, b1, count))
        else:
            mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        eps, eps_root = hp["eps"], hp["eps_root"]
        upd = tree_map(lambda m, v: m / (torch.sqrt(v + eps_root) + eps), mu_hat, nu_hat)
        if name == "adamw":
            wd = hp["weight_decay"]
            upd = tree_map(lambda u, p: u + wd * p, upd, params)
        return _scale(upd, -1 * lr), {"count": count, "mu": mu, "nu": nu}
    if name == "adagrad":
        eps = hp["eps"]
        sos = tree_map(lambda gg, t: gg * gg + t, g, st["sum_of_squares"])
        inv = tree_map(lambda t: torch.where(t > 0, torch.rsqrt(t + eps), torch.zeros_like(t)),
                       sos)
        upd = tree_map(lambda i, gg: i * gg, inv, g)
        return _scale(upd, -1 * lr), {"sum_of_squares": sos}
    if name == "adadelta":
        wd, rho, eps = hp["weight_decay"], hp["rho"], hp["eps"]
        g = tree_map(lambda gg, p: gg + wd * p, g, params)
        e_g = _ema(g, st["e_g"], rho, 2)
        upd = tree_map(lambda gg, cur, prev: (torch.sqrt(prev + eps) / torch.sqrt(cur + eps)) * gg,
                       g, e_g, st["e_x"])
        e_x = _ema(upd, st["e_x"], rho, 2)
        return _scale(upd, -1 * lr), {"e_g": e_g, "e_x": e_x}
    if name == "adamax":
        b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
        count = st["count"] + 1
        mu = _ema(g, st["mu"], b1, 1)
        nu = tree_map(lambda gg, t: torch.maximum(torch.abs(gg) + eps, b2 * t), g, st["nu"])
        mu_hat = _bias_correction(mu, b1, count)
        upd = tree_map(lambda m, v: m / v, mu_hat, nu)
        return _scale(upd, -1 * lr), {"count": count, "mu": mu, "nu": nu}
    if name == "rmsprop":
        decay, eps = hp["decay"], hp["eps"]
        new = dict(st)
        nu = _ema(g, st["nu"], decay, 2)
        new["nu"] = nu
        if hp["bias_correction"]:
            new["count"] = st["count"] + 1
            nu_hat = _bias_correction(nu, decay, new["count"])
        else:
            nu_hat = nu
        if hp["centered"]:
            mu = _ema(g, st["mu"], decay, 1)
            new["mu"] = mu
            mu_hat = _bias_correction(mu, decay, new["count"]) if hp["bias_correction"] else mu
            if hp["eps_in_sqrt"]:
                scaling = tree_map(lambda m, n: torch.rsqrt(n - m * m + eps), mu_hat, nu_hat)
            else:
                scaling = tree_map(lambda m, n: 1 / (torch.sqrt(n - m * m) + eps), mu_hat, nu_hat)
        elif hp["eps_in_sqrt"]:
            scaling = tree_map(lambda n: torch.rsqrt(n + eps), nu_hat)
        else:
            scaling = tree_map(lambda n: 1 / (torch.sqrt(n) + eps), nu_hat)
        upd = _scale(tree_map(lambda sc, gg: sc * gg, scaling, g), -1 * lr)
        if hp["momentum"] is not None:
            upd, new["trace"] = _trace(upd, st["trace"], hp["momentum"], hp["nesterov"])
        return upd, new
    if name == "rprop":
        sign = tree_map(lambda gg, prev: gg * prev, g, st["prev_updates"])
        eta_p, eta_m = hp["eta_plus"], hp["eta_minus"]
        lo, hi = hp["min_step_size"], hp["max_step_size"]
        steps = tree_map(
            lambda s, step: torch.where(
                s == 0, step,
                torch.clamp(step * torch.where(s > 0, eta_p.to(s.device), eta_m.to(s.device)),
                            min=lo, max=hi)),
            sign, st["step_sizes"])
        prev = tree_map(lambda s, gg, step: torch.where(s < 0, torch.zeros_like(gg),
                                                        step * torch.sign(gg)),
                        sign, g, steps)
        # optax reads the PREVIOUS step's updates here (its lambda's third
        # argument); repeated as it is
        upd = tree_map(lambda s, old: torch.where(s < 0, torch.zeros_like(old), old),
                       sign, st["prev_updates"])
        return _scale(upd, -1.0), {"step_sizes": steps, "prev_updates": prev}
    raise AssertionError(name)


def _apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def get_optimizer(optimizer: str, lr, optimizer_kwargs: dict = None) -> Optimizer:
    """Resolve an optimizer name to an :class:`Optimizer` with optax's
    formulas, its hyperparameters injected into the state."""
    kwargs = dict(optimizer_kwargs or {})
    if optimizer not in _DEFAULTS:
        raise ValueError(
            "Invalid optimizer choice. Please see the documentation of the "
            "`Network.fit_bptt()` method for valid options."
        )
    for torch_name, optax_name in _KWARG_ALIASES.get(optimizer, {}).items():
        if torch_name in kwargs:
            val = kwargs.pop(torch_name)
            if isinstance(optax_name, tuple):
                kwargs.update(zip(optax_name, val))
            else:
                kwargs[optax_name] = val
    unknown = sorted(set(kwargs) - set(_DEFAULTS[optimizer]))
    if unknown:
        raise TypeError(f"{optimizer}() got unexpected keyword arguments {unknown}")
    hp0 = {"learning_rate": lr, **_DEFAULTS[optimizer], **kwargs}
    schedules = {k: v for k, v in hp0.items() if callable(v)}

    def resolve(count: int, dtype) -> dict:
        hp = {}
        for k, v in hp0.items():
            if k in schedules:
                v = schedules[k](count)
            hp[k] = _convert(v, dtype) if (_is_numeric(v) or isinstance(v, torch.Tensor)) else v
        return hp

    def init(params) -> dict:
        dtype = tree_leaves(params)[0].dtype
        hp = resolve(0, dtype)
        return {"count": 0, "hyperparams": hp, "inner": _inner_init(optimizer, hp, params)}

    def update(grads, state, params):
        dtype = tree_leaves(grads)[0].dtype
        hp = resolve(state["count"], dtype)
        hp.update({k: _convert(state["hyperparams"][k], dtype)
                   for k in hp0 if k not in schedules})
        upd, inner = _inner_update(optimizer, hp, grads, state["inner"], params)
        return _apply_updates(params, upd), {"count": state["count"] + 1, "hyperparams": hp,
                                             "inner": inner}

    return Optimizer(init, update)
