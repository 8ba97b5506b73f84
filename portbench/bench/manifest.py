"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix:
- ``configs/<config>.json``: the configuration's sizes (the file
  ``BENCHMARK.json`` points to), with its source, ``reduced`` and
  ``assumed``; ``configs/<config>.py`` builds the port's engine and the
  plain reference from it;
- ``traffic/<traffic>.json``: the mix's parameters, among them the
  ``entry`` (``entries/<entry>.py``) that drives the port's public entry
  point with them;
- ``limits/<cell>.json``: the limit of each number the cell's correctness
  check compares;
- ``metrics/<metric>.py``: one reader a per-layer metric.
Nothing here knows a cell, a configuration or a metric by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent
BENCHMARK = REPO / "BENCHMARK.json"


def load_module(path: Path, name: str) -> ModuleType:
    """A module of the benchmark by file path (its name may hold dots or
    dashes)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench._loaded.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict             # configs/<config>.json
    config_module: ModuleType
    traffic: dict            # traffic/<traffic>.json
    entry: ModuleType        # entries/<entry>.py
    limits: Dict[str, float]
    end_to_end: List[dict]   # BENCHMARK.json's metrics this cell reports
    per_layer: List[dict]


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: it is in the metric's
    ``workloads``; a metric without that key, every cell (a per-layer
    reader that finds nothing to read in a cell leaves its metric out)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None, pkg: Path = PKG) -> Cell:
    bench = bench if bench is not None else read_json(pkg.parent / "BENCHMARK.json")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(w['name'] for w in bench['workloads'])})")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = read_json(pkg.parent / conf["file"])
    traffic = read_json(pkg / "traffic" / f"{work['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    return Cell(
        name=name, chips=int(work["chips"]), config=config,
        config_module=load_module(pkg / "configs" / f"{work['config']}.py", work["config"]),
        traffic=traffic,
        entry=load_module(pkg / "entries" / f"{traffic['entry']}.py", traffic["entry"]),
        limits=read_json(pkg / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def metric_reader(name: str, pkg: Path = PKG) -> ModuleType:
    return load_module(pkg / "metrics" / f"{name}.py", name)
