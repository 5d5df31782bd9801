"""Host cost of the torch engine (↔ tools/tune_hybrid.py): per unit_batch
(and TorchNativeEngine.pipeline_depth, the batches in flight), the wall
time of the best of three maps of 10k simulated reads (seed 1), the
process's CPU time over it (getrusage), CPU as a share of the wall, and
the fallback fraction.  A high CPU share means the engine competes with
the native shard of a hybrid split for host cores; a low one, that it
waits on the device.

Usage: python -m abismal_tpu_torch.tools.tune_hybrid
           [unit_batch[,unit_batch...]] [depth] [--reads N] [--device cpu]
           [--threads N]
"""

from __future__ import annotations

import argparse

from . import _workload as W

REPS = 3


def tune(index, fq, sam, device, unit_batch: int, threads: int,
         reads: int) -> dict:
    """One unit_batch: a warm map, then the best of REPS maps by wall time
    with the process's CPU time over it; the engine goes on return."""
    eng = W.engine(index, device, unit_batch=unit_batch, threads=threads)
    try:
        warm, runs = W.timed_maps(index, fq, None, sam, W.engine_factory(eng),
                                  threads, REPS)
    finally:
        eng.close()
    wall, cpu, _ = min(runs)
    return dict(unit_batch=unit_batch, depth=eng.pipeline_depth,
                reads_per_s=reads / wall, wall_s=wall, cpu_s=cpu,
                cpu_share=cpu / wall, warm_s=warm,
                fallback=eng.n_fallback / max(1, eng.n_units))


def run(batches, depth=None, device="cuda", threads: int = 1,
        reads: int = 10000, out=W.say) -> list[dict]:
    """One row per unit_batch: reads/s, wall and CPU seconds of the best
    map, warm-up seconds and the fallback fraction."""
    from ..index.serialize import read_index
    from ..map.pipeline import TorchNativeEngine

    index = read_index(W.trex1_index_file(threads))
    fq = W.simulate(W.TREX1_FA, reads, seed=1)[0]
    sam = W.cache_path("tune_hybrid", "out.sam")
    rows = []
    old_depth = TorchNativeEngine.pipeline_depth
    if depth is not None:
        TorchNativeEngine.pipeline_depth = depth
    try:
        for ub in batches:
            r = tune(index, fq, sam, device, ub, threads, reads)
            rows.append(r)
            out(f"unit_batch={ub} depth={r['depth']}: "
                f"{r['reads_per_s']:.0f} reads/s  wall={r['wall_s']:.2f}s "
                f"cpu={r['cpu_s']:.2f}s ({r['cpu_share'] * 100:.0f}% of "
                f"wall)  warmup={r['warm_s']:.0f}s  "
                f"fallback={r['fallback']:.4f}")
    finally:
        TorchNativeEngine.pipeline_depth = old_depth
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", nargs="?", default="2048,4096")
    ap.add_argument("depth", type=int, nargs="?", default=None)
    ap.add_argument("--reads", type=int, default=10000)
    W.add_common_args(ap, lmax=False)
    a = ap.parse_args(argv)
    return run([int(x) for x in a.batches.split(",")], a.depth, a.device,
               a.threads, a.reads)


if __name__ == "__main__":
    main()
