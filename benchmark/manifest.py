"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json`` and each per-layer metric ``metrics/<name>.py``
(a module with ``read(ctx) -> float | None``), so that a cell, a mix or a
metric is added as a new file and a new manifest entry.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json",
                 traffic_dir: Path = HERE / "traffic"):
        with open(path) as f:
            self.data = json.load(f)
        self.root = Path(path).resolve().parent
        self.traffic_dir = Path(traffic_dir)
        self.cells = {w["name"]: w for w in self.data["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise SystemExit(f"unknown workload {name!r}; the manifest has "
                             f"{sorted(self.cells)}")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.data["configs"]
                     if c["name"] == cell["config"])
        with open(self.root / entry["file"]) as f:
            return json.load(f)

    def traffic(self, cell: dict) -> dict:
        with open(self.traffic_dir / f"{cell['traffic']}.json") as f:
            return json.load(f)

    @staticmethod
    def _reports(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"] if self._reports(m, cell)]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it."""
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]


def load_metric(name: str):
    """The reader module of per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
