"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them, or to one metric, lives in a file of
its own, so that a later change adds a cell, mix, configuration or metric by
adding files and entries:

- ``configs/<name>.json`` (the path is the configuration's ``file``);
- ``traffic/<name>.json``, whose ``entry`` and ``generator`` name a module
  of ``entries/`` and of ``generators/``;
- ``metrics/<name>.py``, each with ``read(run) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_manifest(root: str = REPO_ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = REPO_ROOT,
              bench_dir: Optional[str] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and the
    metrics that it reports; ``KeyError`` for an unknown cell."""
    bench_dir = bench_dir or os.path.join(root, "port_bench")
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config,
                traffic,
                [m for m in man["end_to_end"] if _applies(m, name)],
                [m for m in man["per_layer"] if _applies(m, name)])


def load_module(kind: str, name: str,
                bench_dir: str = BENCH_DIR) -> ModuleType:
    """``<bench_dir>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{kind} module {name!r}: no file {path}")
    mod_name = f"port_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_metrics(metrics: List[dict], run, bench_dir: str = BENCH_DIR
                 ) -> Dict[str, dict]:
    """Each metric's reader applied to ``run``; a reader that finds nothing
    returns None and its metric is left out."""
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"], bench_dir).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
