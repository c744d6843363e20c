"""Cell resolution and the run's result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix. Every
piece of a cell is found by name, so a cell is added with files and entries
alone:

- ``configs/<config>.json``: the configuration's sizes and settings;
- ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` key names
  ``drivers/<driver>.py``, the general generator and timed loop of that kind
  of traffic;
- ``limits/<workload>.json``: each number the output check compares, with
  its limit;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(record)``,
  which returns the metric's value from the traced run's record or None.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# Top-level module names that must not be loaded in the process that prints
# the result: the JAX stack and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "triangulation_in_deformable_scenes_tpu")


@dataclasses.dataclass
class Cell:
    config: dict
    traffic: dict
    limits: dict
    driver: object
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list
    chips: int


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with every piece it
    names; the benchmark's own files are read from ``root``'s copy of this
    folder."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = os.path.join(root, os.path.basename(HERE))
    traffic = _json(os.path.join(here, "traffic", f"{entry['traffic']}.json"))
    return Cell(
        config=_json(os.path.join(root, conf["file"])),
        traffic=traffic,
        limits=_json(os.path.join(here, "limits", f"{name}.json")),
        driver=importlib.import_module(f"{os.path.basename(HERE)}.drivers.{traffic['driver']}"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        chips=int(entry["chips"]),
    )


def reader(root: str, metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(root, os.path.basename(HERE), "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def judge(numbers: dict, limits: dict):
    """(correct, [[name, value, limit]]): every number at or below its limit;
    a number that is missing or not finite fails."""
    rows = []
    ok = True
    for name, lim in limits["limits"].items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        rows.append([name, v, lim])
    return ok, rows
