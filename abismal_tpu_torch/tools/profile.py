"""End-to-end mapping profile (↔ tools/profile.py): simulated 100 bp
single-end reads through one engine, timed over a few runs after a warm
one, and its stage table.  For the native engine the table is the
library's own nanosecond accounting (seed / align / format / parse,
summed over worker threads); for the torch engine (TorchNativeEngine on
the card) it is that of its native half beside the spans of the engine's
tracer (tracing.Tracer: total wall seconds by path, e.g. map/dispatch/
encode).  --trace DIR writes a torch.profiler trace (Chrome JSON) of the
timed runs into DIR, the tracer's spans on it as abismal:<name>.

Usage: python -m abismal_tpu_torch.tools.profile [--engine native|torch]
           [--reads 10000] [--threads N] [--reps 3] [--trace DIR]
           [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from . import _workload as W


def run(index, genome, engine: str = "native", reads: int = 10000,
        threads: int = 1, reps: int = 3, trace: str = "", device="cuda",
        out=W.say) -> dict:
    from ..map.engine import run_map
    from ..map.host_units import make_native_engine_factory
    from ..map.native_engine import _ptr

    fq = W.simulate(genome, reads)[0]
    sam = W.cache_path("profile", "out.sam")
    if engine == "torch":
        eng = W.engine(index, device, threads=threads)
    else:
        eng = make_native_engine_factory(n_threads=threads)(
            index, False, 0.1, 32, 3000)

    factory = W.engine_factory(eng)  # one engine: its timers add up

    def run_once():
        run_map(index, fq, None, sam, None, "profile run",
                engine_factory=factory, threads=threads)

    run_once()  # warm: engine tables, kernels' build
    native = getattr(eng, "native", eng)
    native.lib.engine_set_profile(native._ctx, 1)
    ns = np.zeros(16, dtype=np.int64)
    native.lib.engine_stage_ns(native._ctx, _ptr(ns), 1)  # reset
    tr = getattr(eng, "tracer", None) if engine == "torch" else None
    if tr is not None:
        tr.reset()
        tr.on = True

    def timed_reps():
        t0 = time.perf_counter()
        for _ in range(reps):
            run_once()
        return time.perf_counter() - t0

    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if engine == "torch" and eng.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            wall = timed_reps()
        os.makedirs(trace, exist_ok=True)
        path = os.path.join(trace, f"profile_{engine}.json")
        prof.export_chrome_trace(path)
        out(f"[torch.profiler trace written to {path}]")
    else:
        wall = timed_reps()
    n = reps * reads
    res = dict(engine=engine, threads=threads, reads=n, seconds=wall,
               reads_per_s=n / wall)
    out(f"engine={engine} threads={threads}: {n} reads in {wall:.2f}s = "
        f"{n / wall:.0f} reads/s")
    native.lib.engine_stage_ns(native._ctx, _ptr(ns), 0)
    cpu = max(1, int(ns[:4].sum()))
    res["native_cpu_s"] = {}
    out("native stage table (CPU seconds summed over worker threads):")
    for name, v in zip(("seed", "align", "format", "parse"), ns[:4]):
        res["native_cpu_s"][name] = int(v) / 1e9
        out(f"  {name:8s} {v / 1e9:8.2f}s  ({100 * int(v) // cpu}%)")
    if tr is not None:
        tr.on = False
        spans = tr.summary()["spans"]
        res["stage_wall_s"] = {p: t for p, (_, t, _s) in spans.items()}
        out("torch engine spans (wall seconds):")
        for p, t in sorted(res["stage_wall_s"].items()):
            out(f"  {p:32s} {t:8.2f}s  ({100 * t / wall:.0f}%)")
        out(f"  fallback units: {eng.n_fallback}/{eng.n_units}")
        res["fallback_frac"] = eng.n_fallback / max(1, eng.n_units)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", default="native", choices=["native", "torch"])
    ap.add_argument("--reads", type=int, default=10000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", default="")
    W.add_common_args(ap, lmax=False)
    a = ap.parse_args(argv)
    index, genome = W.profile_index(a.threads)
    return run(index, genome, a.engine, a.reads, a.threads, a.reps, a.trace,
               a.device)


if __name__ == "__main__":
    main()
