"""The readings that the correctness check's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 3 [--out calibrate.jsonl]

For each of ``--seeds``: one run of the cell with a short window (the
program, at the cell's own shapes and load), and its compared numbers.
For each of ``--control-seeds``: the control, the plain reference at the
configuration's ``control_precision`` (the next precision below the stated
one) put in the program's place, over as many calls as a run checks,
against the reference at the stated precision.  The lower reading is the
largest number the program gives, the upper the smallest the control
gives; a limit lies between them (``portbench/limits/<cell>.json``).
The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)


def control_reading(cell, seed: int, device) -> dict:
    """The control's number on ``seed``: the first ``check_calls`` calls of
    the window through the reference at ``control_precision`` against the
    reference at ``precision``."""
    import torch

    from portbench import calls, check

    cfg, mix = cell.cfg, cell.mix
    inputs = cell.family.make_inputs(cfg, seed, device)
    ref_c = cell.reference.Coupling(cfg, inputs, cfg["precision"])
    ctl_c = cell.reference.Coupling(cfg, inputs, cfg["control_precision"])
    key, worst = tuple(cell.family.COMPARED), 0.0
    for index in range(mix["check_calls"]):
        c = calls.make_call(mix, cfg["n"], seed, index, device)
        ref = cell.reference.simulate(cfg, inputs, ref_c, mix, c)[key]
        ctl = cell.reference.simulate(cfg, inputs, ctl_c, mix, c)[key]
        worst = max(worst, check.v_gap_q99(ctl, ref))
    del inputs, ref_c, ctl_c
    torch.cuda.empty_cache()
    return {check.NUMBER: worst}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import Cell, run_cell

    device = "cuda:0"
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None

        def emit(line: dict) -> None:
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()

        program, control = [], []
        for seed in [int(s) for s in args.seeds.split(",") if s]:
            t0 = time.perf_counter()
            res, _ = run_cell(args.workload, seed, args.seconds, False, device=device)
            value = res["check"]["v_gap_q99"]["value"]
            program.append(value)
            emit({"workload": args.workload, "side": "program", "seed": seed,
                  "v_gap_q99": value, "correct": res["correct"], "attempted": res["attempted"],
                  "metrics": res["metrics"], "seconds": time.perf_counter() - t0})
            torch.cuda.empty_cache()
        cell = Cell(os.path.join(ROOT, "BENCHMARK.json"), args.workload)
        for seed in [int(s) for s in args.control_seeds.split(",") if s]:
            t0 = time.perf_counter()
            value = control_reading(cell, seed, device)["v_gap_q99"]
            control.append(value)
            emit({"workload": args.workload, "side": "control",
                  "precision": cell.cfg["control_precision"], "seed": seed, "v_gap_q99": value,
                  "seconds": time.perf_counter() - t0})
        emit({"workload": args.workload, "lower": max(program) if program else None,
              "upper": min(control) if control else None, "program_seeds": len(program),
              "control_seeds": len(control), "device": torch.cuda.get_device_name(0)})
    return 0

if __name__ == "__main__":
    sys.exit(main())
