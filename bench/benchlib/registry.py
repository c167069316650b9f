"""Finds what ``BENCHMARK.json`` names, by name: the cell, its
configuration file, its traffic mix, the driver module the mix names and
the per-layer metric readers.  Nothing here knows a cell, a configuration
or a metric by its name: a later change adds files and entries only."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TRAFFIC = BENCH / "traffic"
DRIVERS = BENCH / "drivers"
METRICS = BENCH / "metrics"
CHECKS = BENCH / "checks"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, bench: dict | None = None,
                 root: Path = ROOT):
        bench = benchmark(root) if bench is None else bench
        self.bench = bench
        self.workload = _by_name(bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.workload["chips"])
        cfg_entry = _by_name(bench["configs"], self.workload["config"],
                             "config")
        self.config_name = cfg_entry["name"]
        self.config = load_json(root / cfg_entry["file"])
        self.traffic_name = self.workload["traffic"]
        self.traffic = load_json(TRAFFIC / f"{self.traffic_name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and self._reports(m["moves"])]

    def _reports(self, metric: str) -> bool:
        return any(m["name"] == metric for m in self.end_to_end)

    def driver(self):
        d = self.traffic["driver"]
        return load_module(DRIVERS / f"{d}.py", f"bench_driver_{d}")

    def limits(self) -> dict:
        """{number: limit} of the cell's check (``checks/<cell>.json``)."""
        return load_json(CHECKS / f"{self.name}.json")["limits"]

    def reader(self, metric: str):
        return load_module(METRICS / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_"))
