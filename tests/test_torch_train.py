"""The port's losses and optax-formula optimizers (``train/``) against the JAX
package's ``get_loss_function``/``get_optimizer`` (optax).  CPU, float64,
inputs from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rectipy_tpu.train import get_loss_function as j_loss
from rectipy_tpu.train import get_optimizer as j_opt
from rectipy_tpu_torch.train import get_loss_function, get_optimizer


def _loss_inputs(name, rng):
    pred = rng.normal(size=(7, 5))
    if name in ("nll", "ce"):
        return pred, rng.integers(0, 5, size=7).astype(np.float64)
    if name == "kld":
        return np.log(rng.dirichlet(np.ones(5), size=7)), rng.dirichlet(np.ones(5), size=7)
    if name == "hinge":
        return pred, np.where(rng.random((7, 5)) > 0.5, 1.0, -1.0)
    return pred, rng.normal(size=(7, 5))


@pytest.mark.parametrize("name,kw", [("mse", None), ("l1", None), ("nll", None), ("ce", None),
                                     ("kld", None), ("hinge", None), ("hinge", {"margin": 0.3})])
def test_losses_match_jax(name, kw):
    # the same elementwise formulas and mean reductions: equal to rounding
    pred, tgt = _loss_inputs(name, np.random.default_rng(0))
    ref = float(j_loss(name, kw)(jnp.asarray(pred), jnp.asarray(tgt)))
    got = float(get_loss_function(name, kw)(torch.as_tensor(pred), torch.as_tensor(tgt)))
    np.testing.assert_allclose(got, ref, rtol=1e-13)


def test_cross_entropy_with_probability_targets_matches_jax():
    rng = np.random.default_rng(1)
    pred, tgt = rng.normal(size=(6, 4)), rng.dirichlet(np.ones(4), size=6)
    np.testing.assert_allclose(
        float(get_loss_function("ce")(torch.as_tensor(pred), torch.as_tensor(tgt))),
        float(j_loss("ce")(jnp.asarray(pred), jnp.asarray(tgt))), rtol=1e-13)


OPTIMIZERS = [
    ("sgd", 1e-2, None),
    ("sgd", 1e-2, {"momentum": 0.9}),
    ("sgd", 1e-2, {"momentum": 0.9, "nesterov": True}),
    ("adam", 1e-2, None),
    ("adam", 1e-2, {"b1": 0.8, "eps": 1e-6, "nesterov": True}),
    ("adamw", 1e-2, None),
    ("adagrad", 1e-1, None),
    ("adadelta", 1.0, {"weight_decay": 0.1}),
    ("adamax", 1e-2, None),
    ("rmsprop", 1e-2, None),
    ("rmsprop", 1e-2, {"centered": True, "momentum": 0.5, "bias_correction": True}),
    ("rmsprop", 1e-2, {"eps_in_sqrt": False}),
    ("rprop", 1e-2, {"etas": (0.4, 1.3), "step_sizes": (1e-5, 1.0)}),
]


@pytest.mark.parametrize("name,lr,kw", OPTIMIZERS)
def test_optimizers_match_optax_over_five_steps(name, lr, kw):
    # a params tree of the network's shape, five updates on seeded gradients;
    # the optax formulas in the same order at float64: rtol 1e-12 (the only
    # differences are roundings of the same operations)
    rng = np.random.default_rng(2)
    params = {"nodes": {"rnn": {"weights": rng.normal(size=(4, 4)), "eta": rng.normal(size=4)}},
              "edges": {"a->b": {"weights": rng.normal(size=(3, 4))}}}
    grads = [jax.tree.map(lambda p: rng.normal(size=np.shape(p)), params) for _ in range(5)]
    # a few gradient entries repeat the previous sign flip (rprop's branches)
    grads[2]["nodes"]["rnn"]["eta"] = -grads[1]["nodes"]["rnn"]["eta"]

    jopt = j_opt(name, lr, kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    topt = get_optimizer(name, lr, kw)
    tp = jax.tree.map(torch.as_tensor, params)
    ts = topt.init(tp)
    for g in grads:
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update(jax.tree.map(torch.as_tensor, g), ts, tp)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in path]
        got = tp[keys[0]][keys[1]][keys[2]].numpy()
        np.testing.assert_allclose(got, np.asarray(leaf), rtol=1e-12, atol=1e-15)
    assert float(ts["hyperparams"]["learning_rate"]) == float(js.hyperparams["learning_rate"])


def test_schedule_learning_rate_and_errors():
    # a callable lr is a schedule of the update count, as inject_hyperparams
    # makes it
    sched = lambda count: 1e-2 * 0.5 ** count  # noqa: E731
    jopt, topt = j_opt("sgd", sched), get_optimizer("sgd", sched)
    jp, tp = jnp.ones(3), torch.ones(3, dtype=torch.float64)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        upd, js = jopt.update(jnp.ones(3), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update(torch.ones(3, dtype=torch.float64), ts, tp)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-14)
    with pytest.raises(ValueError, match="optimizer choice"):
        get_optimizer("lbfgs", 1e-3)
    with pytest.raises(ValueError, match="loss function"):
        get_loss_function("huber")
    with pytest.raises(TypeError, match="unexpected keyword"):
        get_optimizer("adam", 1e-3, {"beta1": 0.9})
