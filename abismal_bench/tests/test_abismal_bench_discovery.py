"""A configuration, a cell and a metric are added as files and entries;
the harness finds them by name, and no file of the harness changes."""

from __future__ import annotations

import json
import os

from abismal_bench.harness import spec


def test_new_config_cell_and_metric_are_found(tiny, run_tiny):
    root, _ = tiny
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    conf = json.load(open(os.path.join(root, "configs", "se_tiny.json")))
    conf["name"] = "se_tiny_b"
    conf["settings"] = dict(conf["settings"], max_distance=0.08)
    json.dump(conf, open(os.path.join(root, "configs", "se_tiny_b.json"),
                         "w"))
    bench["configs"].append({"name": "se_tiny_b", "source": "test",
                             "file": "configs/se_tiny_b.json",
                             "reduced": [], "why": "test"})
    wl = json.load(open(os.path.join(root, "workloads",
                                     "se_tiny.len100.json")))
    wl["config"] = "se_tiny_b"
    wl["traffic"]["read_length"] = 90
    json.dump(wl, open(os.path.join(root, "workloads",
                                    "se_tiny_b.len90.json"), "w"))
    bench["workloads"].append({"name": "se_tiny_b.len90",
                               "config": "se_tiny_b", "traffic": "len90",
                               "chips": 1, "why": "test"})
    with open(os.path.join(root, "metrics", "pool_files_seen.py"), "w") as f:
        f.write("def read(run):\n    return run.maps\n")
    bench["end_to_end"].append({"name": "pool_files_seen", "unit": "maps",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["se_tiny_b.len90"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))

    cell = spec.find_cell("se_tiny_b.len90", root, root)
    assert cell.config["settings"]["max_distance"] == 0.08
    assert [m["name"] for m in cell.end_to_end][-1] == "pool_files_seen"
    assert "pool_files_seen" not in [
        m["name"] for m in spec.find_cell("se_tiny.len100", root,
                                          root).end_to_end]
    out = run_tiny("se_tiny_b.len90", 5)
    assert out["metrics"]["pool_files_seen"]["value"] >= 1
    assert out["correct"], out["check"]
