"""Finds what ``BENCHMARK.json`` names, by name: a cell's configuration
file, its traffic mix (``traffic/<mix>.json``), the mix's driver
(``drivers/<driver>.py``), each metric's reader (``metrics/<metric>.py``:
a per-layer metric's reads the traced window's record, an end-to-end
metric's what the driver measured over the window; ``setup_s`` is the
harness's own) and a cell's correctness limits
(``limits/<cell>.json``). Adding a cell, a mix or a metric is adding files
and entries; nothing here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Registry:
    def __init__(self, bench_path: Path = ROOT / "BENCHMARK.json",
                 here: Path = HERE):
        self.root = Path(bench_path).parent
        self.here = Path(here)
        with open(bench_path) as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.here / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, cell: str) -> dict:
        with open(self.here / "limits" / f"{cell}.json") as f:
            return json.load(f)["limits"]

    def driver(self, name: str):
        return importlib.import_module(f"{self.here.name}.drivers.{name}")

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"_bench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
