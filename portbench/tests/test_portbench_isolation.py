"""Nothing that portbench runs loads JAX or the JAX package, judged by
whole top-level module names."""

import os
import subprocess
import sys

from portbench.harness import forbidden_modules
from portbench.tests.conftest import ROOT


def test_whole_top_level_names():
    found = forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                               "rectipy_tpu", "rectipy_tpu.ops.kernels"])
    assert found == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "rectipy_tpu",
                     "rectipy_tpu.ops.kernels"]
    assert forbidden_modules(["rectipy_tpu_torch", "rectipy_tpu_torch.ops.kernels", "jaxtyping",
                              "flaxen", "portbench.harness", "torch", "numpy"]) == []


def test_a_run_loads_no_jax(toy_bench):
    """A toy run in a fresh process, every file of the cell loaded, leaves
    no forbidden module behind."""
    bench_json, bench_dir = toy_bench
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench import harness\n"
        f"r, _ = harness.run_cell('toy.dense.sweep', 2 ** 31 + 7, 0.2, False, device='cpu', "
        f"bench_path={bench_json!r}, bench_dir={bench_dir!r})\n"
        f"r, _ = harness.run_cell('toy.blocks.single', 2 ** 31 + 7, 0.2, False, device='cpu', "
        f"bench_path={bench_json!r}, bench_dir={bench_dir!r})\n"
        "assert r['correct'], r\n"
        "print(harness.forbidden_modules(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
