"""Run one cell once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's driver (`drivers/<kind>.py`, the kind its traffic names) sets
up the program, measures the window and compares what the timed path
produced with the plain reference. With `--trace 0` the result carries the
cell's end-to-end metrics; with `--trace 1` its per-layer metrics, each
read by its own reader from the run's readings.

The last lines of standard error are the comparison's numbers beside their
limits; the last line of standard output is the result, a JSON object
with `correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` `breakdown`, and last `checks`. Without a CUDA card, or with
fewer than the cell asks for, it prints no result and exits 3; when the
process holds JAX or the JAX package after the window, it exits 4.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import NamedTuple, Optional

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "taichi_3d_gaussian_splatting_tpu")
NO_CARD, FORBIDDEN_MODULES = 3, 4


class RunResult(NamedTuple):
    """What a driver's run gives the harness."""
    attempted: int
    failed: int
    end_to_end: dict          # metric name -> value (trace 0)
    readings: dict            # what the per-layer readers read (trace 1)
    checks: dict              # compared number -> value
    memory_peak_bytes: int
    trace: Optional[dict]     # harness.trace.summarize of the traced stretch


def note(t0: float, what: str):
    """A progress line on standard error: what was done, seconds since
    the process started."""
    print(f"portbench: {what} at {time.time() - t0:.2f} s", file=sys.stderr,
          flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run may not hold."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def card_count() -> int:
    import torch
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.device_count()


def result_line(cell: spec.Cell, run: RunResult, trace: bool,
                device_kind: str, power_w) -> dict:
    """The result object, `checks` last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.reader(m["name"])(run.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": run.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in run.checks.items()}
    correct = (run.attempted > 0 and run.failed == 0
               and set(checks) == set(cell.limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes),
              "power_limit_w": power_w}
    out = {"correct": bool(correct), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv, t0: float, require_card: bool = True,
         benchmark_path: str = None, pieces: str = spec.BENCH_DIR) -> int:
    """Run the cell; `require_card`, `benchmark_path` and `pieces` serve
    the CPU tests, which drive a run at a tiny size without a card."""
    args = parse(argv)
    cell = spec.load_cell(args.workload, benchmark_path, pieces)
    if require_card and card_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA card(s);"
              f" torch sees {card_count()}", file=sys.stderr, flush=True)
        return NO_CARD
    import torch
    run = spec.driver(cell.traffic["kind"]).run(cell, args, t0)
    held = forbidden_modules()
    if held:
        print(f"portbench: the process holds {', '.join(held)}",
              file=sys.stderr, flush=True)
        return FORBIDDEN_MODULES
    kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")
    out = result_line(cell, run, bool(args.trace), kind,
                      power_limit_w() if require_card else None)
    print(f"portbench: {cell.name} seed {args.seed} on {kind}, power limit "
          f"{out['device']['power_limit_w']} W; correct {out['correct']}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
