"""YAML model-template frontend.

Parses the same operator/node template format that the reference consumes via
PyRates (see RectiPy's ``neuron_model_templates/**/*.yaml`` and the API
surface documented in SURVEY.md §2.8): operator templates with string
equations, ``output()/input()/variable()`` variable tags, template inheritance
with ``replace:``/``add:``, and node templates composed of operator lists.

Counterpart of ``rectipy_tpu/dsl/parser.py``; the files are read with the
port's own YAML reader (``yaml_lite``), not PyYAML.

Templates are addressed by dotted paths (``rectipy_tpu_torch.models.
spiking_neurons.qif.qif_sfa``).  Paths written for the JAX package
(``rectipy_tpu.models.``), and the ``neuron_model_templates.`` and
``model_templates.`` prefixes of reference user scripts, resolve into this
package's own ``models/`` directory, so such scripts run unchanged.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from .expr import substitute
from .yaml_lite import load_file

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # rectipy_tpu_torch/
_REPO_DIR = os.path.dirname(_PKG_DIR)

# dotted-path prefixes remapped for compatibility with reference user scripts
_PATH_ALIASES = {
    "neuron_model_templates": os.path.join(_PKG_DIR, "models"),
    "rectipy_tpu_torch.models": os.path.join(_PKG_DIR, "models"),
    # scripts (and the templates' own cross-file references) written for the
    # JAX package resolve into this package's copy of the library
    "rectipy_tpu.models": os.path.join(_PKG_DIR, "models"),
    # PyRates' own base template library entries used in documentation/rls_example.py
    "model_templates": os.path.join(_PKG_DIR, "models", "compat"),
}


class TemplateError(ValueError):
    """Raised on malformed or unresolvable templates."""


@dataclass
class VarSpec:
    """One entry of an operator's ``variables:`` block."""

    role: str  # 'output' | 'input' | 'variable' | 'constant'
    default: float = 0.0

    @classmethod
    def parse(cls, raw) -> "VarSpec":
        if isinstance(raw, (int, float)):
            return cls("constant", float(raw))
        if isinstance(raw, str):
            m = re.fullmatch(r"\s*(output|input|variable)\s*(?:\(\s*([^)]*)\s*\))?\s*", raw)
            if m:
                default = float(m.group(2)) if m.group(2) not in (None, "") else 0.0
                return cls(m.group(1), default)
            try:
                return cls("constant", float(raw))
            except ValueError:
                raise TemplateError(f"Cannot parse variable spec {raw!r}")
        raise TemplateError(f"Cannot parse variable spec {raw!r}")


@dataclass
class OperatorTemplate:
    name: str
    equations: List[str] = field(default_factory=list)
    variables: Dict[str, VarSpec] = field(default_factory=dict)

    def inherit(self, name: str, eq_spec, var_spec: Optional[dict]) -> "OperatorTemplate":
        """Derive a child operator: ``replace:``/``add:``/``remove:`` on the
        equations, merged variables (child wins)."""
        equations = list(self.equations)
        if eq_spec is not None:
            if isinstance(eq_spec, str):
                equations = [eq_spec]
            elif isinstance(eq_spec, list):
                equations = [str(e) for e in eq_spec]
            elif isinstance(eq_spec, dict):
                if "replace" in eq_spec and eq_spec["replace"]:
                    for old, new in eq_spec["replace"].items():
                        equations = [substitute(eq, str(old), str(new)) for eq in equations]
                if "remove" in eq_spec and eq_spec["remove"]:
                    removed = [str(r) for r in eq_spec["remove"]]
                    equations = [eq for eq in equations if eq not in removed]
                if "add" in eq_spec and eq_spec["add"]:
                    equations = equations + [str(e) for e in eq_spec["add"]]
            else:
                raise TemplateError(f"Invalid equations spec for operator {name!r}")
        variables = dict(self.variables)
        if var_spec:
            for k, v in var_spec.items():
                variables[k] = VarSpec.parse(v)
        return OperatorTemplate(name=name, equations=equations, variables=variables)


@dataclass
class NodeTemplate:
    name: str
    operators: List[OperatorTemplate] = field(default_factory=list)

    @classmethod
    def from_yaml(cls, path: str) -> "NodeTemplate":
        """Load a node template by dotted path (``pkg.module.file.template``)
        or explicit ``/path/to/file.yaml/template`` reference."""
        tpl = load_template(path)
        if not isinstance(tpl, NodeTemplate):
            raise TemplateError(f"{path!r} resolved to an operator template, expected a node template")
        return tpl


def _resolve_yaml_file(module_path: str) -> str:
    """Map a dotted module path (without the trailing template name) to a YAML file."""
    for prefix, root in _PATH_ALIASES.items():
        if module_path == prefix or module_path.startswith(prefix + "."):
            rel = module_path[len(prefix):].lstrip(".")
            candidate = os.path.join(root, *rel.split(".")) + ".yaml" if rel else root + ".yaml"
            if os.path.exists(candidate):
                return candidate
    for root in (_REPO_DIR, os.getcwd()):
        candidate = os.path.join(root, *module_path.split(".")) + ".yaml"
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(f"No YAML template file found for module path {module_path!r}")


class _TemplateFile:
    """All templates defined in one YAML file, resolved lazily with inheritance."""

    _cache: Dict[str, "_TemplateFile"] = {}

    def __init__(self, path: str):
        self.path = path
        self.raw = load_file(path) or {}
        self.raw.pop("aliases", None)
        self._resolved: Dict[str, Union[OperatorTemplate, NodeTemplate]] = {}

    @classmethod
    def load(cls, path: str) -> "_TemplateFile":
        path = os.path.abspath(path)
        if path not in cls._cache:
            cls._cache[path] = cls(path)
        return cls._cache[path]

    def get(self, name: str) -> Union[OperatorTemplate, NodeTemplate]:
        if name in self._resolved:
            return self._resolved[name]
        if name not in self.raw:
            raise AttributeError(f"Template {name!r} not found in {self.path}")
        spec = self.raw[name]
        base = spec.get("base")
        if base == "NodeTemplate":
            ops = []
            for op_ref in spec.get("operators", []):
                ops.append(self._lookup_operator(str(op_ref)))
            tpl: Union[OperatorTemplate, NodeTemplate] = NodeTemplate(name=name, operators=ops)
        elif base == "OperatorTemplate":
            eqs = spec.get("equations", [])
            if isinstance(eqs, str):
                eqs = [eqs]
            variables = {k: VarSpec.parse(v) for k, v in (spec.get("variables") or {}).items()}
            tpl = OperatorTemplate(name=name, equations=[str(e) for e in eqs], variables=variables)
        elif isinstance(base, str):
            parent = self._lookup_operator(base)
            tpl = parent.inherit(name, spec.get("equations"), spec.get("variables"))
        else:
            raise TemplateError(f"Template {name!r} in {self.path} has no valid 'base'")
        self._resolved[name] = tpl
        return tpl

    def _lookup_operator(self, ref: str) -> OperatorTemplate:
        if "." in ref:
            tpl = load_template(ref)
        else:
            tpl = self.get(ref)
        if not isinstance(tpl, OperatorTemplate):
            raise TemplateError(f"{ref!r} is not an operator template")
        return tpl


def load_template(path: str) -> Union[OperatorTemplate, NodeTemplate]:
    """Resolve a dotted path or ``file.yaml/name`` reference to a template."""
    if path.endswith(".yaml") or "/" in path:
        if path.endswith(".yaml"):
            raise TemplateError(f"Template reference {path!r} is missing the template name suffix")
        file_part, name = path.rsplit("/", 1)
        return _TemplateFile.load(file_part).get(name)
    if "." not in path:
        raise TemplateError(f"Cannot resolve bare template name {path!r}; use a dotted path")
    module_path, name = path.rsplit(".", 1)
    yaml_file = _resolve_yaml_file(module_path)
    return _TemplateFile.load(yaml_file).get(name)


@dataclass
class CircuitGroup:
    """One structurally-homogeneous population inside a CircuitTemplate:
    every member node shares the same operator equations, so the group
    lowers to ONE vectorized Network node.  ``indices`` are the members'
    global neuron indices (insertion order), ``node_vars`` the merged
    per-member parameter overrides (``{op/var: (n_group,) array}``)."""

    name: str
    template: "NodeTemplate"
    indices: "object"  # np.ndarray of global indices
    node_vars: dict

    @property
    def n(self) -> int:
        return len(self.indices)

    def owns(self, qualified_var: str) -> bool:
        """True iff this group's template declares ``op/var``."""
        parts = _strip_node_prefix(qualified_var).split("/")
        if len(parts) != 2:
            return False
        op_name, var = parts
        return any(op.name == op_name and var in op.variables
                   for op in self.template.operators)


@dataclass
class CircuitTemplate:
    """API-compat shim for PyRates' CircuitTemplate as the reference uses it
    (RectiPy's rectipy/nodes.py:241-252): N identical node copies plus
    edges added from a weight matrix.  The lowering stays symbolic -- the node
    count and edge matrices are extracted, never unrolled.

    Beyond the reference (which only ever replicates ONE template): nodes may
    be heterogeneous.  PARAMETER heterogeneity (same equations, different
    variable defaults) merges into per-neuron override arrays within one
    vectorized node.  EQUATION heterogeneity groups the nodes by operator
    structure; such circuits cannot lower to one vector field (``lower()``
    raises) but ``Network.add_diffeq_node`` auto-expands them into one
    Network node per group wired with inter-group edges -- trained at the
    same deferred-gradient roofline by the graph trajectory.
    """

    name: str
    nodes: Dict[str, NodeTemplate]

    def __post_init__(self):
        if not self.nodes:
            raise TemplateError("CircuitTemplate requires at least one node")
        import numpy as _np

        tlist = list(self.nodes.values())  # insertion order = neuron index

        def sig(t: NodeTemplate):
            return tuple(
                (op.name, tuple(op.equations),
                 tuple(sorted((v, s.role) for v, s in op.variables.items())))
                for op in t.operators)

        sigs = [sig(t) for t in tlist]
        order: list = []
        for s in sigs:
            if s not in order:
                order.append(s)
        self.groups: List[CircuitGroup] = []
        used_names: set = set()
        for s in order:
            idx = _np.asarray([i for i, x in enumerate(sigs) if x == s])
            members = [tlist[i] for i in idx]
            first = members[0]
            # merge per-member parameter heterogeneity inside the group:
            # each differing default becomes an (n_group,) override array
            gvars: dict = {}
            for oi, op in enumerate(first.operators):
                for vname in op.variables:
                    vals = [m.operators[oi].variables[vname].default for m in members]
                    if any(v != vals[0] for v in vals[1:]):
                        gvars[f"{op.name}/{vname}"] = _np.asarray(vals, dtype=float)
            gname = first.name or f"group{len(self.groups)}"
            while gname in used_names:
                gname = f"{gname}_{len(self.groups)}"
            used_names.add(gname)
            self.groups.append(CircuitGroup(name=gname, template=first,
                                            indices=idx, node_vars=gvars))
        names = list(self.nodes)
        self._member_group: Dict[str, CircuitGroup] = {
            names[i]: g for g in self.groups for i in g.indices}
        self.heterogeneous: bool = len(self.groups) > 1
        # homogeneous-circuit surface (node_template/node_vars) kept for the
        # single-group lowering path and API compatibility
        self.node_template: Optional[NodeTemplate] = (
            None if self.heterogeneous else self.groups[0].template)
        self.node_vars: dict = {} if self.heterogeneous else dict(self.groups[0].node_vars)
        self.n: int = len(tlist)
        self.edges: list = []  # (source_var, target_var, weight matrix)

    def owner_group(self, qualified_var: str) -> CircuitGroup:
        """The unique group whose template declares ``op/var``."""
        owners = [g for g in self.groups if g.owns(qualified_var)]
        if len(owners) != 1:
            raise TemplateError(
                f"Variable {qualified_var!r} is declared by "
                f"{[g.name for g in owners] or 'no'} groups of circuit "
                f"{self.name!r}; it must belong to exactly one node template. "
                "Qualify it with a member node name ('<node>/<op>/<var>') to "
                "disambiguate."
            )
        return owners[0]

    def resolve_group(self, var: str):
        """Resolve a possibly node-qualified variable to ``(group,
        'op/var')``.  ``'p3/li_op/r_in'`` resolves via member node 'p3';
        a bare ``'op/var'`` must be declared by exactly one group."""
        parts = var.split("/")
        if len(parts) >= 3 and parts[0] in self._member_group:
            return self._member_group[parts[0]], "/".join(parts[-2:])
        qvar = _strip_node_prefix(var)
        return self.owner_group(qvar), qvar

    def add_edges_from_matrix(self, source_var: str, target_var: str,
                              source_nodes: list = None, weight=None, **kwargs):
        """Record an all-to-all coupling realized by ``weight`` (rows = targets)."""
        del source_nodes, kwargs
        # raw var strings are kept: heterogeneous circuits may need the
        # node-name qualification ('p3/li_op/r_in') to resolve which group a
        # variable lives on when several groups share an op/var name; the
        # homogeneous lowering strips prefixes at consumption
        self.edges.append((source_var, target_var, weight))

    def update_var(self, node_vars: dict = None, **kwargs):
        del kwargs
        if node_vars:
            self.node_vars.update(node_vars)


def _strip_node_prefix(var: str) -> str:
    """'n0/op/var' -> 'op/var' (per-node prefixes are meaningless after
    symbolic vectorization)."""
    parts = var.split("/")
    return "/".join(parts[-2:]) if len(parts) >= 2 else var


def clear_frontend_caches():
    """Drop all cached template files (API parity with the reference's
    ``pyrates.clear_frontend_caches``, RectiPy's ``rectipy/nodes.py:5``)."""
    _TemplateFile._cache.clear()
