"""The port's DSL (YAML reader, expressions, parser, lowering) against the JAX package.

Inputs come from numpy seeds and go through both packages on the CPU.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rectipy_tpu.dsl import evaluate as j_evaluate
from rectipy_tpu.dsl import lower as j_lower
from rectipy_tpu.dsl import parse as j_parse
from rectipy_tpu_torch.dsl import TemplateError, evaluate, load_template, lower, parse
from rectipy_tpu_torch.dsl import parser as t_parser
from rectipy_tpu_torch.dsl.yaml_lite import YAMLError, load, load_file

PORT_MODELS = os.path.join(os.path.dirname(t_parser._PKG_DIR), "rectipy_tpu_torch", "models")
YAML_FILES = sorted(glob.glob(os.path.join(PORT_MODELS, "**", "*.yaml"), recursive=True))
NODE_TEMPLATES = [
    f"{os.path.relpath(f, PORT_MODELS)[:-5].replace(os.sep, '.')}.{name}"
    for f in YAML_FILES
    for name, spec in load_file(f).items()
    if isinstance(spec, dict) and spec.get("base") == "NodeTemplate"
]


# ---------------------------------------------------------------- YAML reader


def test_template_library_is_complete():
    # the port carries all 15 template files of the JAX package with the same
    # content: every line but the comments is identical
    jax_dir = os.path.join(os.path.dirname(PORT_MODELS), "..", "rectipy_tpu", "models")
    jax_files = sorted(os.path.relpath(f, jax_dir) for f in
                       glob.glob(os.path.join(jax_dir, "**", "*.yaml"), recursive=True))
    assert [os.path.relpath(f, PORT_MODELS) for f in YAML_FILES] == jax_files
    assert len(YAML_FILES) == 15
    for rel in jax_files:
        with open(os.path.join(jax_dir, rel)) as a, open(os.path.join(PORT_MODELS, rel)) as b:
            a_lines, b_lines = a.read().splitlines(), b.read().splitlines()
        assert len(a_lines) == len(b_lines), rel
        for la, lb in zip(a_lines, b_lines):
            assert la == lb or (la.lstrip().startswith("#") and lb.lstrip().startswith("#")), rel
        assert yaml.safe_load("\n".join(a_lines)) == load_file(os.path.join(PORT_MODELS, rel))


@pytest.mark.parametrize("path", YAML_FILES, ids=lambda p: os.path.relpath(p, PORT_MODELS))
def test_yaml_reader_matches_pyyaml_on_templates(path):
    with open(path) as f:
        expect = yaml.safe_load(f)
    assert load_file(path) == expect


@pytest.mark.parametrize("text", [
    "a: 1\nb: -2.5\nc: 6.0e-3\nd: 1e-3\ne: 1.0e3\nf: .5\ng: +7\n",
    "t: yes\nu: Off\nv: ~\nw: null\nx:\ny: true\n",
    "k:\n- one\n- 'it''s'\n- \"tab\\there\"\n- 3\n",
    "%YAML 1.2\n---\nouter:\n  inner:\n    - &a first   # comment\n    - *a\n  'quoted key': \"v' = x # not a comment\"\n",
    "m:\n  k*r_in: k*s_in\n  eta: eta - x\n  \"2.0*r*v/tau\": \"(2.0*v - g)*r/tau\"\n",
])
def test_yaml_reader_matches_pyyaml_on_subset(text):
    assert load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: [1, 2]\n", "a: {b: 1}\n", "a: |\n  x\n", "a: 0x1f\n",
                                  "- a: 1\n", "a: *missing\n"])
def test_yaml_reader_refuses_outside_subset(text):
    with pytest.raises(YAMLError):
        load(text)


# ---------------------------------------------------------------- expressions

EXPRESSIONS = [
    "exp(x)", "log(abs(x) + 1.0)", "log10(abs(x) + 1.0)", "sin(x)", "cos(x)", "tan(x/2)",
    "sinh(x)", "cosh(x)", "tanh(x)", "arcsin(x/4)", "arccos(x/4)", "arctan(x)",
    "sqrt(abs(x))", "abs(x) + absv(y)", "sign(x)", "x - mean(x)", "sum(x) + min(y) * max(x)",
    "maxi(x, y) + mini(x, 0.5)", "maximum(x, y) - minimum(y, x)", "sigmoid(x)", "softmax(x)",
    "heaviside(x)", "round(x*3.0)", "floor(x) + ceil(y)", "expm1(x)", "exprel(x)",
    "power(abs(x), y) + pow(abs(y), 2.5)", "x^2 - y^3 + x^4 - -x^2", "2^x", "exp(1.0) * x + pi",
    "x^3^0.5 / (1 + y^2)",
]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_expression_matches_jax(expr):
    # float64 on both sides and the same operation order: equal to rounding
    rng = np.random.default_rng(0)
    x = np.concatenate([[0.0, -2.0, 3.0], rng.uniform(-3.0, 3.0, 5)])
    y = rng.uniform(0.1, 2.0, x.shape[0])
    got = evaluate(parse(expr), {"x": torch.as_tensor(x), "y": torch.as_tensor(y)})
    expect = j_evaluate(j_parse(expr), {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(expect), rtol=1e-13, atol=1e-13)


def test_heaviside_is_zero_at_zero_and_literals_stay_on_host():
    out = evaluate(parse("heaviside(x)"), {"x": torch.tensor([-1.0, 0.0, 2.0])})
    assert out.tolist() == [0.0, 0.0, 1.0]
    assert isinstance(evaluate(parse("exp(2.0) + 1"), {}), float)


# -------------------------------------------------------------------- parser


@pytest.mark.parametrize("prefix", ["rectipy_tpu_torch.models", "rectipy_tpu.models",
                                    "neuron_model_templates"])
def test_parser_aliases_resolve_into_port_models(prefix):
    path = t_parser._resolve_yaml_file(f"{prefix}.spiking_neurons.qif")
    assert path == os.path.join(PORT_MODELS, "spiking_neurons", "qif.yaml")
    tpl = load_template(f"{prefix}.spiking_neurons.lif.lif")
    # lif inherits li_op through a 'rectipy_tpu.models' path inside the file:
    # the port must read the parent from its own copy too
    assert all(p.startswith(PORT_MODELS) for p in t_parser._TemplateFile._cache)
    assert tpl.operators[0].equations[0] == "v' = -v/tau + (k*s_in) + I_ext + eta"


def test_parser_compat_alias_and_errors():
    assert t_parser._resolve_yaml_file("model_templates.base_templates") == os.path.join(
        PORT_MODELS, "compat", "base_templates.yaml")
    assert [op.name for op in load_template("model_templates.base_templates.tanh_node").operators] \
        == ["li_op", "tanh_op"]
    with pytest.raises(FileNotFoundError):
        load_template("rectipy_tpu.models.no_such_file.x")
    with pytest.raises(TemplateError):
        load_template("bare_name")


# ------------------------------------------------------------------ lowering


def _compare_vector_fields(vt, vj, rng, rtol):
    assert vt.keys == vj.keys
    assert vt.var_map == {k: tuple(v) for k, v in vj.var_map.items()}
    assert vt.param_map == vj.param_map
    assert vt.alg_vars == vj.alg_vars
    assert vt.input_vars == vj.input_vars
    np.testing.assert_array_equal(vt.y0.numpy(), np.asarray(vj.y0))
    for k in vj.keys:  # bf16 couplings compare as exact f32 values
        a = vt.args[k].float() if vt.args[k].dtype == torch.bfloat16 else vt.args[k]
        np.testing.assert_array_equal(a.numpy(), np.asarray(vj.args[k]).astype(a.numpy().dtype))
    y = rng.uniform(-1.0, 1.0, vt.y0.shape[0])
    ta = dict(vt.args)
    ja = dict(vj.args)
    for k in vt.input_vars:  # drive every input placeholder
        u = rng.uniform(-1.0, 1.0, vt.n)
        ta[k] = torch.as_tensor(u, dtype=vt.dtype)
        ja[k] = jnp.asarray(u, dtype=vj.dtype)
    dy_t = vt.func(0.0, torch.as_tensor(y, dtype=vt.dtype), ta)
    dy_j = vj.func(0.0, jnp.asarray(y, dtype=vj.dtype), ja)
    np.testing.assert_allclose(dy_t.numpy(), np.asarray(dy_j), rtol=rtol, atol=rtol)
    for q in vt.alg_vars:
        np.testing.assert_allclose(
            vt.read_var(q, torch.as_tensor(y, dtype=vt.dtype), ta).numpy(),
            np.asarray(vj.read_var(q, jnp.asarray(y, dtype=vj.dtype), ja)), rtol=rtol, atol=rtol)


@pytest.mark.parametrize("template", NODE_TEMPLATES)
def test_lowered_template_matches_jax(template):
    # float64 on both sides, same expression trees: equal to a few ulps
    path = f"rectipy_tpu.models.{template}"
    vt = lower(path, n=7, dtype=torch.float64, device="cpu")
    vj = j_lower(path, n=7, dtype=jnp.float64)
    _compare_vector_fields(vt, vj, np.random.default_rng(len(template)), rtol=1e-12)


COUPLED = [
    ("spiking_neurons.qif.qif_sfa", "s", "s_in", {"all/qif_sfa_op/eta": "per-neuron"}),
    ("spiking_neurons.qif.qif", "s", "s_in", {}),
    ("spiking_neurons.lif.lif", "s", "s_in", {}),
    ("rate_neurons.leaky_integrator.tanh", "tanh_op/r", "li_op/r_in", {"li_op/k": 2.0}),
]


@pytest.mark.parametrize("template,src,tgt,node_vars", COUPLED, ids=[c[0] for c in COUPLED])
def test_lowered_coupled_field_matches_jax_f64(template, src, tgt, node_vars):
    # float64 both sides; only the matvec's summation order may differ
    n = 9
    rng = np.random.default_rng(1)
    W = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.5)
    nv = {k: (rng.normal(size=n) if v == "per-neuron" else v) for k, v in node_vars.items()}
    path = f"rectipy_tpu.models.{template}"
    vt = lower(path, weights=W, source_var=src, target_var=tgt, node_vars=nv,
               dtype=torch.float64, device="cpu")
    vj = j_lower(path, weights=W, source_var=src, target_var=tgt, node_vars=nv,
                 dtype=jnp.float64)
    assert vt.couplings == vj.couplings
    _compare_vector_fields(vt, vj, rng, rtol=1e-12)


def test_lowered_bf16_coupling_matches_jax():
    # bf16 W and bf16-rounded source on both sides, products summed in f32:
    # the same function up to the summation order of f32 sums (~1e-6 rel.)
    n = 64
    rng = np.random.default_rng(2)
    W = rng.random((n, n)) * (rng.random((n, n)) < 0.2)
    path = "rectipy_tpu.models.spiking_neurons.qif.qif_sfa"
    vt = lower(path, weights=W, source_var="s", target_var="s_in", dtype=torch.float32,
               coupling_dtype=torch.bfloat16, device="cpu")
    vj = j_lower(path, weights=W, source_var="s", target_var="s_in", dtype=jnp.float32,
                 coupling_dtype=jnp.bfloat16)
    assert vt.args["weights"].dtype == torch.bfloat16
    _compare_vector_fields(vt, vj, rng, rtol=2e-6)


@pytest.mark.parametrize("coupling", ["int8", "int8_master", "bfloat16_master", "int4"])
def test_lowering_refuses_unported_couplings(coupling):
    from rectipy_tpu_torch.nodes import resolve_dtype

    cd = coupling if coupling.endswith(("master", "int4")) else resolve_dtype(coupling)
    kw = dict(weights=np.eye(4), source_var="s", target_var="s_in", coupling_dtype=cd,
              device="cpu")
    # every dense coupling is ported (ops/quant.py, tests/test_torch_int4.py):
    # stored as the JAX package stores it, with the JAX coupling_cast
    vf = lower("rectipy_tpu.models.spiking_neurons.qif.qif", **kw)
    frozen = coupling in ("int8", "int4")
    assert vf.args["weights"].dtype == (torch.int8 if frozen else torch.float32)
    assert ("weights__scale" in vf.args) == frozen
    vj = j_lower("rectipy_tpu.models.spiking_neurons.qif.qif", weights=np.eye(4),
                 source_var="s", target_var="s_in",
                 coupling_dtype=jnp.int8 if coupling == "int8" else coupling)
    assert vf.coupling_cast == vj.coupling_cast
    assert sorted(vf.args) == sorted(vj.args)
    assert (vf.prep_args is not None) == (coupling != "int8")
