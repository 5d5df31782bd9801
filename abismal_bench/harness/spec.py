"""What a run measures, found by name: the cell's entry in BENCHMARK.json,
its workload file (abismal_bench/workloads/<cell>.json), its
configuration file (the entry's `file`), and one reader module a metric
(abismal_bench/metrics/<metric>.py, a function read(run) that returns a
number, or None where it finds nothing to read).  A new configuration,
cell or metric is a new file and a new entry; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    workload: dict  # abismal_bench/workloads/<cell>.json
    config: dict  # the configuration's file
    end_to_end: list = field(default_factory=list)  # metric entries
    per_layer: list = field(default_factory=list)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT, bench_dir: str = BENCH) -> Cell:
    """The cell `name` of root's BENCHMARK.json, with its files and the
    metrics it reports; KeyError when the benchmark has no such cell."""
    spec = _load(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    workload = _load(os.path.join(bench_dir, "workloads", f"{name}.json"))
    config = _load(os.path.join(root, conf["file"]))
    return Cell(name, entry, workload, config,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def reader(metric: str, bench_dir: str = BENCH):
    """The reader module of a metric: abismal_bench/metrics/<metric>.py."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"abismal_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
