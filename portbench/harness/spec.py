"""Find a cell's pieces by the names in BENCHMARK.json.

- the cell: an entry of `workloads`;
- its configuration: `configs/<config>.json`;
- its traffic mix: `traffic/<traffic>.json`, whose `kind` names the driver
  module `drivers/<kind>.py`;
- its comparison limits: `limits/<cell>.json`;
- its scene recipe: `scenes/<recipe>.py`;
- each per-layer metric's reader: `metrics/<metric>.py`.

Every piece is a file of its own, so a later change adds a cell, a
configuration, a mix or a metric as new files and new entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# What the scene recipes, the reference and the program's kernels fix
# (4 rotation, 3 log-scale, 1 alpha and 3 x 16 SH features; 16x16 tiles),
# and the render slabs the program has. A configuration that states
# anything else is refused rather than run under its name.
FIXED = {("features",): 56, ("sh_degree",): 3, ("camera", "tile"): 16}
SLABS = ("packed8", "wide16")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list


def _json(path):
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether `cell` reports `metric`: the cells its `workloads` lists;
    without one, every cell for an end-to-end metric, and for a per-layer
    metric every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def honoured(config: dict, traffic: dict):
    """Raise ValueError where the configuration or the mix states what a
    run cannot honour (`FIXED`, `SLABS`, an SH band above the degree)."""
    wrong = []
    for keys, value in FIXED.items():
        stated = config
        for k in keys:
            stated = stated[k]
        if stated != value:
            wrong.append(f"{'.'.join(keys)} {stated!r} (only {value!r})")
    if config["render"]["slab"] not in SLABS:
        wrong.append(f"render.slab {config['render']['slab']!r} (one of "
                     f"{', '.join(SLABS)})")
    if int(traffic.get("sh_band", 0)) > int(config["sh_degree"]):
        wrong.append(f"sh_band {traffic['sh_band']!r} above sh_degree")
    if wrong:
        raise ValueError("cannot honour " + "; ".join(wrong))


def load_cell(name: str, benchmark_path: str = None,
              pieces: str = BENCH_DIR) -> Cell:
    """The cell `name` with its configuration, traffic, limits and the
    metrics it reports; traffic and limits are looked up under `pieces`.
    Raises KeyError for an unknown name, FileNotFoundError for a missing
    piece and ValueError for a configuration it cannot honour."""
    bench = _json(benchmark_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"no configuration named {w['config']!r}")
    config = _json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(pieces, "traffic", w["traffic"] + ".json"))
    honoured(config, traffic)
    limits = _json(os.path.join(pieces, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)


def _module(path: str, name: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str):
    """The driver module of a traffic kind."""
    return _module(os.path.join(BENCH_DIR, "drivers", kind + ".py"),
                   f"portbench_driver_{kind}")


def recipe(name: str):
    """The scene recipe module `scenes/<name>.py`."""
    return _module(os.path.join(BENCH_DIR, "scenes", name + ".py"),
                   f"portbench_scene_{name}")


def reader(metric: str):
    """The reader of a per-layer metric, `metrics/<metric>.py`'s `read`."""
    return _module(os.path.join(BENCH_DIR, "metrics", metric + ".py"),
                   "portbench_metric_" + metric.replace(".", "_")).read
