"""What ``BENCHMARK.json`` names, found by name under ``benchmark/``.

- a configuration ``<c>``: ``configs/<c>.json`` (its sizes), its reference
  ``reference/<c>.py`` and its work ``work/<c>.py``;
- a cell ``<w>``: ``workloads/<w>.json`` (its configuration, driver,
  traffic parameters and the limits of its comparison);
- a driver ``<d>``: ``drivers/<d>.py``;
- a per-layer metric ``<m>``: ``metrics/<m>.py``, whose ``read(ctx)``
  returns the metric or ``None`` where it finds nothing to read.

A later cell, configuration or metric is added by adding its files and its
entry in ``BENCHMARK.json``; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Mapping

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, name: str) -> ModuleType:
    """The module at ``path``, imported under ``name`` once per process."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "configs" / f"{name}.json")


def workload(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "workloads" / f"{name}.json")


def driver(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _module(bench_dir / "drivers" / f"{name}.py", f"benchmark.drivers.{name}")


def reference(config_name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _module(bench_dir / "reference" / f"{config_name}.py",
                   f"benchmark.reference.{config_name}")


def work(config_name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _module(bench_dir / "work" / f"{config_name}.py", f"benchmark.work.{config_name}")


def metric(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """A metric's reader; its file is named after the metric, dots and all."""
    return _module(bench_dir / "metrics" / f"{name}.py",
                   "benchmark.metrics." + name.replace(".", "__"))


def cell_metrics(bench: Mapping, cell: str, section: str) -> List[dict]:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, or list no cells."""
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]


def cell_entry(bench: Mapping, cell: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
