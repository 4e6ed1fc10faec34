"""Find a cell's pieces by name from BENCHMARK.json: its configuration
file, its traffic mix (a data file under traffic/), the driver the mix
names (drivers/<driver>.py), its correctness limits (limits/<cell>.json),
the plain reference of its configuration (reference/<config>.py), and the
reader of each of its per-layer metrics (metrics/<metric>.py). Adding a
cell, a configuration, a mix or a metric is adding files and entries."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import List

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, pkg: str = PKG) -> dict:
    return load_json(os.path.join(pkg, "traffic", f"{name}.json"))


def limits(cell: str, pkg: str = PKG) -> dict:
    return load_json(os.path.join(pkg, "limits", f"{cell}.json"))


def load_file(path: str, name: str) -> ModuleType:
    """A module from its file (names may hold dots: metrics/mfu.train.py)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def piece(kind: str, name: str, pkg: str = PKG) -> ModuleType:
    """drivers/, reference/, counts/ or metrics/<name>.py."""
    path = os.path.join(pkg, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if name.isidentifier() and pkg == PKG:
        return importlib.import_module(f"portbench.{kind}.{name}")
    return load_file(path, f"portbench_{kind}_{name}")


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of `section` ('end_to_end' or 'per_layer') this cell reports."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]

