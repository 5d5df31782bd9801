"""Weak scaling of multi-host mapping (↔ tools/multihost_scale.py): the
work a host holds fixed, the host count grown, efficiency =
throughput(N) / (N * throughput(1)), against the fewest hosts measured.

Each host is a spawned process with its own index replica and --threads
worker threads, mapping its read-range shard of one simulated FASTQ
(seed 1) through run_map_multihost; the gather concatenates the shard
SAMs in rank order.  --engine torch (the default, as for map --hosts)
maps each shard on a card (shard i on cuda:i mod the card count;
--device cpu: the plain kernels); --engine native, what the JAX tool
measures, maps on the host cores.

Usage: python -m abismal_tpu_torch.tools.multihost_scale [--per-host 20000]
           [--hosts 1 2] [--threads 2] [--reps 3] [--engine torch|native]
           [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from . import _workload as W


def run(per_host: int = 20000, hosts=(1, 2), threads: int = 2,
        reps: int = 3, engine: str = "torch", device="cuda",
        out=W.say) -> dict:
    """{"reads_per_s": {N: rate}, "efficiency": {N: share}}."""
    from ..parallel.multihost import run_map_multihost

    idx = W.trex1_index_file(threads)
    rates = {}
    for n in hosts:
        total = per_host * n
        fq = W.simulate(W.TREX1_FA, total, seed=1)[0]
        sam = W.cache_path("multihost_scale", f"out{n}.sam")
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            run_map_multihost(idx, fq, None, sam, "weak-scaling bench",
                              n_hosts=n, threads_per_host=threads,
                              engine=engine,
                              device=None if device == "cuda" else device)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        rates[n] = total / best
        out(f"hosts={n} ({threads} threads each): {total} reads in "
            f"{best:.2f}s = {rates[n]:.0f} reads/s")
    base = min(rates)
    eff = {n: rates[n] / (rates[base] * n / base) for n in sorted(rates)}
    for n, e in eff.items():
        out(f"weak-scaling efficiency at {n} host(s): {100 * e:.0f}%")
    return {"engine": engine, "reads_per_s": rates, "efficiency": eff}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--per-host", type=int, default=20000)
    ap.add_argument("--hosts", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--engine", choices=["torch", "native"],
                    default="torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device of --engine torch's shards (default "
                         "cuda: shard i on cuda:i mod the card count)")
    a = ap.parse_args(argv)
    return run(a.per_host, a.hosts, a.threads, a.reps, a.engine, a.device)


if __name__ == "__main__":
    main()
