"""
The readings that a cell's limits are set from, on the chip:

    python3 -m portbench.readings --workload <cell> --seeds 1,2,... \
        [--control 7,8,9] [--fault half_batch --fault-seeds 4,5,6]

For each seed the cell is set up as a run sets it up (no window), the
program's outputs are compared with the float32 reference, and a JSON
line gives the numbers. `--control` seeds also put the reference in the
program's place one precision below the configuration's (the cell's
`control_mode`, `reference/precision.py`) and compare that; `--fault`
seeds run the program with a fault planted under the timed path (the
cell's `FAULTS`). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

import torch

from portbench.run import ROOT, load_cell, load_json


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control", default="")
    parser.add_argument("--fault", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--window", type=float, default=0.0,
                        help="seconds of the cell's own traffic before its "
                        "answers are compared (serving cells)")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, cfg, traffic, _ = load_cell(load_json(ROOT / "BENCHMARK.json"),
                                   args.workload)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")

    def seeds(text):
        return [int(s) for s in text.split(",") if s]
    jobs = ([(s, "program") for s in seeds(args.seeds)]
            + [(s, "control") for s in seeds(args.control)]
            + [(s, args.fault) for s in seeds(args.fault_seeds)])
    for seed, what in jobs:
        t0 = time.time()
        fault = what if what not in ("program", "control") else None
        cell = kind.Cell(cfg, traffic, seed, device, fault=fault)
        if args.window:
            cell.window(args.window)
        prog = cell.program_outputs()
        cell.free_program()
        ref = cell.reference("float32")
        if what == "control":
            prog = cell.reference(cell.control_mode)
        numbers = cell.compare(prog, ref)
        if hasattr(cell, "diagnostics"):
            numbers.update(cell.diagnostics(prog, ref))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": what, "numbers": numbers,
                          "seconds": time.time() - t0}), flush=True)
        del cell, prog, ref
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
