"""
The benchmark of the PyTorch and CUDA port (`coot_videotext_tpu_torch`).

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. One run loads and warms the cell (set-up),
measures for `--seconds`, then, with `--trace 1`, traces a short stretch
of the same work, frees the program's state, runs the plain reference on
the inputs it was given and decides `correct`. The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, and with `--trace 1` `breakdown`; its last key `checks` holds
each number compared beside its limit, which are also the last lines on
standard error.

Everything is found by name from BENCHMARK.json: the configuration file
(`configs/<config>.json`), the traffic mix (`traffic/<traffic>.json`,
whose `kind` names the code of that kind, `kinds/<kind>.py`), the limits of
the cell (`limits/<workload>.json`) and each per-layer metric's reader
(`metrics/<metric>.py`, else `metrics/<stem>.py` for the name before its
first dot: a `read(ctx)` that returns the value or None).
"""

from __future__ import annotations

import time

T_START = time.time()  # before the heavy imports: they are set-up

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "coot_videotext_tpu")


def load_json(path: Path):
    with open(path, encoding="utf8") as fh:
        return json.load(fh)


def load_cell(bench: dict, name: str):
    """(workload entry, configuration, traffic, limits) of a cell."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] ==
                     entry["config"])
    cfg = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return entry, cfg, traffic, limits


def metrics_of(bench: dict, name: str, section: str,
               reported=None) -> list:
    """The metrics of `section` this cell reports: those that list it,
    and those without a list that move a metric the cell reports (every
    end-to-end metric without a list is reported everywhere)."""
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def reader(metric: str):
    """`metrics/<metric>.py`, or where there is none the reader of its
    quantity, `metrics/<stem>.py` (the name before its first dot)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def execute(bench: dict, name: str, seed: int, seconds: float, trace: bool,
            device, started: float, overrides=None) -> dict:
    """One run of a cell on `device`; `overrides` (tests) may replace the
    configuration, traffic or limits, or plant one of the cell's
    `FAULTS`."""
    import torch
    from portbench import check
    from portbench.trace import traced

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry, cfg, traffic, limits = load_cell(bench, name)
    overrides = overrides or {}
    cfg = overrides.get("config", cfg)
    traffic = overrides.get("traffic", traffic)
    limits = overrides.get("limits", limits)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    imported = time.time()
    cell = kind.Cell(cfg, traffic, seed, device,
                     fault=overrides.get("fault"))
    cell.sync()
    setup_s = time.time() - started
    print(f"setup: start and imports {imported - started:.3f} s, the cell "
          f"{setup_s - (imported - started):.3f} s", file=sys.stderr)

    e2e = cell.window(seconds)
    result: Dict[str, object] = {}
    if trace:
        run, counts, steps = cell.traced_work()
        tr = traced(run)
        ctx = cell.layer_context(tr, counts, steps)
        values = {}
        for m in metrics_of(bench, name, "per_layer", set(e2e) | {"setup_s"}):
            v = reader(m["name"])(ctx)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
        result["breakdown"] = tr.breakdown()
        busy = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        e2e["setup_s"] = setup_s
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in e2e.items()}
        busy = {}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    attempted = cell.attempted()
    prog_out = cell.program_outputs()
    cell.free_program()
    numbers = cell.compare(prog_out, cell.reference("float32"))
    correct = check.verdict(numbers, limits)
    result.update(
        correct=correct, attempted=attempted,
        failed=0 if correct else 1,
        device={"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak), **busy},
        checks={k: {"value": v, "limit": limits[k]}
                for k, v in numbers.items()})
    return result


def card_line() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = execute(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0), T_START)
    print(f"card: {card_line()}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    checks = result.pop("checks")
    result["checks"] = checks  # the last key
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
