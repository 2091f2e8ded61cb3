"""`BENCHMARK.json` and the files it names, found by name.

- a configuration: `benchmark/configs/<name>.json` (the `file` of its entry);
- a traffic mix: `benchmark/traffic/<traffic>.json`;
- a cell's correctness limits: `benchmark/limits/<workload>.json`;
- a per-layer metric: `benchmark/metrics/<metric>.py`, whose `read(ctx)`
  returns the value, or None where it finds nothing to read;
- a hand-written kernel's bound: `benchmark/kernels/<kernel>.py`, with the
  kernel's name `PATTERNS` and `bound_s(cfg, traffic, kind)`.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path) -> ModuleType:
    """A Python file of the benchmark loaded by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location("benchmark_file_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of the manifest with its configuration, traffic and limits."""

    def __init__(self, name: str, doc: dict = None):
        doc = doc or manifest()
        cells = {w["name"]: w for w in doc["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        entry = {c["name"]: c for c in doc["configs"]}[self.workload["config"]]
        self.config_doc = load_json(ROOT / entry["file"])
        self.traffic = load_json(BENCH / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.end_to_end = [m for m in doc["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in doc["per_layer"] if name in m.get("workloads", [name])]

    def readers(self) -> Dict[str, ModuleType]:
        return {m["name"]: load_module(BENCH / "metrics" / f"{m['name']}.py") for m in self.per_layer}


def kernel_specs() -> List[ModuleType]:
    """Every kernel file under `benchmark/kernels/`."""
    return [load_module(p) for p in sorted((BENCH / "kernels").glob("*.py"))]
