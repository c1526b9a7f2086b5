"""Run one cell of rectipy_tpu_torch's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell asks
for.  The last line of standard output is the result (JSON); the last
lines of standard error give each number the correctness check compared,
beside its limit.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read from a profiled stretch at the
end of the window.  The program's kernel builds stay in the checkout
(``rectipy_tpu_torch/_build/``), and so do the caches set below.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# import portbench as a package from the checkout's root, never its files as
# top-level modules (which could shadow the standard library's)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, ".portbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)

    import torch

    t_torch = time.perf_counter() - T_START
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no cell {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    from portbench.harness import forbidden_modules, run_cell

    def log(text: str) -> None:
        print(f"portbench: {text}", file=sys.stderr, flush=True)

    log(f"torch imported at {t_torch:.3f} s, CUDA found at {time.perf_counter() - T_START:.3f} s")

    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             device="cuda:0", t_start=T_START, log=log)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
