"""The port stands alone: it imports neither JAX, nor the JAX package, nor PyYAML."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "rectipy_tpu_torch")
SOURCES = sorted(
    os.path.join(d, f) for d, _, files in os.walk(PORT) for f in files if f.endswith(".py"))
FORBIDDEN = ("jax", "jaxlib", "optax", "rectipy_tpu", "yaml")
# the port's smoke run on the card imports nothing of JAX either
SCANNED = SOURCES + [os.path.join(ROOT, "chip_smoke.py")]


def _module(path):
    name = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
    return name[:-len(".__init__")] if name.endswith(".__init__") else name


def test_subprocess_import_loads_no_jax_or_yaml():
    modules = [_module(p) for p in SOURCES]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len([m for m in sys.modules if m.startswith('rectipy_tpu_torch')]), bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_loaded, _ = proc.stdout.split(" ", 1)
    assert int(n_loaded) >= len(SOURCES)


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: os.path.relpath(p, ROOT))
def test_port_sources_import_nothing_forbidden(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"
