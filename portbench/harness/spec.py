"""Finding a cell's files by name.

``BENCHMARK.json`` names the cells and metrics; ``cells/<workload>.json``
holds a cell's traffic and settings, ``configs/<config>.json`` its model,
``traffic/<kind>.py`` the driver its traffic kind runs through and
``metrics/<metric>.py`` each metric's reader. A later cell, configuration,
traffic kind or metric is a new file and a new entry: nothing here changes.
"""
from __future__ import annotations

import copy
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from .env import ROOT

#: the benchmark's own directory
HOME = Path(__file__).resolve().parents[1]


@dataclass
class Spec:
    """One cell as a run sees it."""
    workload: str
    cell: Dict[str, Any]
    config: Dict[str, Any]
    #: the cell's entries of BENCHMARK.json's end_to_end and per_layer
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)
    home: Path = HOME


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as handle:
        return json.load(handle)


def merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """``base`` with ``over``'s keys laid over it, nested dicts merged."""
    out = copy.deepcopy(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _workload_entry(benchmark: Dict[str, Any], workload: str
                    ) -> Dict[str, Any]:
    for entry in benchmark.get("workloads", []):
        if entry["name"] == workload:
            return entry
    raise KeyError(f"BENCHMARK.json names no workload {workload!r}")


def metrics_of(benchmark: Dict[str, Any], workload: str) -> tuple:
    """The end-to-end and per-layer metrics a workload reports: those that
    list it, and those without a ``workloads`` key (a per-layer metric
    without one goes wherever its ``moves`` metric is reported)."""
    end_to_end = [m for m in benchmark.get("end_to_end", [])
                  if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in benchmark.get("per_layer", [])
                 if (workload in m["workloads"] if "workloads" in m
                     else m.get("moves") in reported)]
    return end_to_end, per_layer


def load(workload: str, root: Path = ROOT, home: Path = HOME,
         dry: bool = False) -> Spec:
    """The spec of ``workload``; ``dry`` lays the cell's ``dry`` section
    over it (the tiny CPU rehearsal of the tests)."""
    benchmark = read_json(root / "BENCHMARK.json")
    entry = _workload_entry(benchmark, workload)
    cell = read_json(home / "cells" / f"{workload}.json")
    if cell["config"] != entry["config"]:
        raise ValueError(f"cells/{workload}.json runs {cell['config']!r}, "
                         f"BENCHMARK.json says {entry['config']!r}")
    config = read_json(home / "configs" / f"{cell['config']}.json")
    if dry:
        config = merge(config, cell.get("dry", {}).get("config", {}))
        cell = merge(cell, {k: v for k, v in cell.get("dry", {}).items()
                            if k != "config"})
    end_to_end, per_layer = metrics_of(benchmark, workload)
    return Spec(workload, cell, config, end_to_end, per_layer, home)


def load_module(path: Path, name: str):
    """Import the file at ``path`` under ``name`` (files are found by the
    name BENCHMARK.json or a cell gives them, dots included)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic_driver(spec: Spec):
    kind = spec.cell["kind"]
    return load_module(spec.home / "traffic" / f"{kind}.py",
                       f"portbench_traffic_{kind}")


def metric_reader(spec: Spec, name: str):
    return load_module(spec.home / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def read_metrics(spec: Spec, entries: List[Dict[str, Any]], record
                 ) -> Dict[str, Dict[str, Any]]:
    """Each entry's value from its reader; a reader that finds nothing to
    read returns None and the metric is left out."""
    out: Dict[str, Dict[str, Any]] = {}
    for entry in entries:
        value: Optional[float] = metric_reader(spec, entry["name"]).read(
            record)
        if value is not None:
            out[entry["name"]] = {"value": float(value),
                                  "unit": entry["unit"]}
    return out
