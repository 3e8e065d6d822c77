"""Finding a cell's pieces by name.

``BENCHMARK.json`` names the cells; a cell names its configuration
(``configs/<config>.json``) and its traffic mix (``traffic/<traffic>.json``);
each per-layer metric has a reader ``metrics/<name>.py`` with a function
``read(window)`` that returns a number or None (nothing to read).  A later
cell, mix or metric is therefore added as files and entries only.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    root: str


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its config, its
    traffic mix and the metrics it reports; raises KeyError for an
    unknown cell."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "benchmark", "traffic",
                                      w["traffic"] + ".json"))
    return Cell(
        name=name, config=cfg, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root)


def metric_reader(name: str, root: str = ROOT):
    """``read`` of ``<root>/benchmark/metrics/<name>.py``, loaded by path
    (a metric's name may hold dots)."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
