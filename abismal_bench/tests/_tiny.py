"""A benchmark of tiny cells for the CPU tests: a copy of BENCHMARK.json's
metrics over a 2 Mb genome, in a directory of its own, with the real
metric readers."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

SETTINGS = {"engine": "torch", "max_distance": 0.1, "min_frag": 32,
            "max_frag": 3000, "lmax": 128, "unit_batch": 256, "threads": 2}
GENOME = {"generator": "abismal_bench/gen/genome.py:gen_genome",
          "genome_size": 2_000_000, "chrom_len": 1_000_000,
          "genome_seed": 11}


def traffic(read_length=100, frag_min=100, frag_max=250, n=600, files=2):
    return {"read_length": read_length, "frag_min": frag_min,
            "frag_max": frag_max, "pool_reads": n, "pool_files": files,
            "mutation_rate": 0.01, "sub_ins_del": [1, 1, 1],
            "bs_conv": 0.98, "traffic_seed": 16,
            "protocol": "directional"}


CELLS = {
    "se_tiny.len100": ("se_tiny", False, traffic()),
    "pe_tiny.len100": ("pe_tiny", True, traffic(n=300)),
    "pe_tiny.len150": ("pe_tiny", True, traffic(150, 150, 400, n=200)),
}


def make(dst: str, missed_share: float = 0.08) -> str:
    """The tiny benchmark under dst (its root and its bench directory at
    once); returns dst."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for sub in ("configs", "workloads"):
        os.makedirs(os.path.join(dst, sub), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(dst, "metrics"), dirs_exist_ok=True)
    bench["configs"], bench["workloads"] = [], []
    for conf, paired in (("se_tiny", False), ("pe_tiny", True)):
        json.dump({"name": conf, "paired": paired, "genome": GENOME,
                   "settings": SETTINGS},
                  open(os.path.join(dst, "configs", f"{conf}.json"), "w"))
        bench["configs"].append({"name": conf, "source": "test",
                                 "file": f"configs/{conf}.json",
                                 "reduced": [], "why": "test"})
    for name, (conf, paired, tr) in CELLS.items():
        json.dump({"config": conf, "traffic": tr,
                   "check": {"sample_reads": 200,
                             "missed_share": missed_share},
                   "why": "test"},
                  open(os.path.join(dst, "workloads", f"{name}.json"), "w"))
        bench["workloads"].append({"name": name, "config": conf,
                                   "traffic": name.split(".")[1],
                                   "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    json.dump(bench, open(os.path.join(dst, "BENCHMARK.json"), "w"))
    return dst


def add_cell(root: str, cell: str, conf: str, paired: bool,
             settings: dict | None = None, **traffic_over) -> str:
    """A configuration conf (the tiny settings and `settings` over them)
    and a cell of it, added to the tiny benchmark under root as files and
    entries; returns the cell's name."""
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    if conf not in [c["name"] for c in bench["configs"]]:
        json.dump({"name": conf, "paired": paired, "genome": GENOME,
                   "settings": {**SETTINGS, **(settings or {})}},
                  open(os.path.join(root, "configs", f"{conf}.json"), "w"))
        bench["configs"].append({"name": conf, "source": "test",
                                 "file": f"configs/{conf}.json",
                                 "reduced": [], "why": "test"})
    tr = {**traffic(n=300 if paired else 600), **traffic_over}
    json.dump({"config": conf, "traffic": tr,
               "check": {"sample_reads": 200, "missed_share": 0.08},
               "why": "test"},
              open(os.path.join(root, "workloads", f"{cell}.json"), "w"))
    bench["workloads"].append({"name": cell, "config": conf,
                               "traffic": cell.split(".", 1)[1],
                               "chips": 1, "why": "test"})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return cell
