"""The control of a cell's correctness check, at the cell's own size:
for each seed, the cell's pool is drawn as a run draws it, the control
(reference/control.py: the reference in the mapper's place, matching
plain DNA) writes one SAM a pool file, and the judge reads them as it
reads a window's maps.  Prints one JSON line a seed with the numbers the
judge compares; a sound check finds every seed not correct.  Needs no
card, and the benchmark's own runs do not run it.

  python3 abismal_bench/control.py --workload <cell> --seeds 1,2,3"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_readings(cell_name: str, seed: int, root: str = ROOT,
                     bench_dir: str | None = None,
                     build: str | None = None) -> dict:
    from abismal_bench.harness import inputs, spec
    from abismal_bench.harness.system import resolve
    from abismal_bench.reference.check import Judge, conversion_of
    from abismal_bench.reference.control import control_sam

    cell = spec.find_cell(cell_name, root, bench_dir or spec.BENCH)
    conf, wl = cell.config, cell.workload
    paired = bool(conf["paired"])
    _, genome = inputs.genome_files(conf, build)
    pool = inputs.make_pool(genome, wl, seed, paired)
    n_files = int(wl["traffic"]["pool_files"])
    bounds = [(pool.n * i // n_files, pool.n * (i + 1) // n_files)
              for i in range(n_files)]
    st = resolve(conf["settings"])
    judge = Judge(genome, pool, bounds, paired, float(st["max_distance"]),
                  conversion_of(st, paired))
    with tempfile.TemporaryDirectory(prefix="abismal_bench_ctl_") as tmp:
        maps = []
        for f in range(n_files):
            path = os.path.join(tmp, f"control{f}.sam")
            control_sam(judge, f, path)
            maps.append((f, path))
        res = judge.judge(maps, seed, int(wl["check"]["sample_reads"]))
    limit = float(wl["check"]["missed_share"])
    res["correct"] = res["record_faults"] <= 0 and res["missed_share"] <= limit
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args(argv)
    for s in a.seeds.split(","):
        res = control_readings(a.workload, int(s))
        print(json.dumps({"workload": a.workload, "seed": int(s), **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
