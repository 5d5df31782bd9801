"""Per-kernel device timeline of the fused single-end program (↔
tools/trace_ops.py): runs a few executions of build_stage12 on one chunk
of simulated reads under torch.profiler and prints the top CUDA kernels
by their total device time (name, calls, µs, share of all kernel time).
This is the ground truth that the cut bisection of profile_stage12
approximates.  On the CPU (--device cpu) it lists the top CPU ops.

Usage: [ABISMAL_PROFILE_INDEX=... ABISMAL_PROFILE_GENOME=...]
       python -m abismal_tpu_torch.tools.trace_ops [unit_batch] [reps]
           [top_n] [--device cpu]
The trace (Chrome JSON) is kept under build/abismal_tpu_torch/tools/.
"""

from __future__ import annotations

import argparse
import json
import os

from . import _workload as W


def top_events(path: str, cats, top_n: int):
    """The trace's events of the categories cats, summed by name: (rows of
    (name, calls, total µs) by total, the total µs of all of them)."""
    with open(path) as f:
        tr = json.load(f)
    events = tr["traceEvents"] if isinstance(tr, dict) else tr
    tot = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats:
            calls, us = tot.get(e["name"], (0, 0.0))
            tot[e["name"]] = (calls + 1, us + float(e.get("dur", 0.0)))
    rows = sorted(((n, c, us) for n, (c, us) in tot.items()),
                  key=lambda r: -r[2])
    return rows[:top_n], sum(us for _, _, us in rows)


def run(eng, chunk, reps: int = 5, top_n: int = 40, out=W.say) -> dict:
    """Times the whole program on chunk, then traces reps executions;
    returns the steady ms a chunk, the kernel (or CPU op) µs an execution
    and the top rows [name, calls, µs an execution, share]."""
    from torch.profiler import ProfilerActivity, profile

    args = chunk.on(eng)
    tables = eng.dev.tables()
    prog = W.stage12_prog(eng, chunk)
    steady = W.timed_ms(lambda: prog(*tables, *args), reps, eng.device)
    out(f"steady: {steady:.3f} ms/chunk "
        f"({steady * 1e3 / chunk.args[0].shape[0]:.3f} us/unit)")
    on_card = eng.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        for _ in range(reps):
            prog(*tables, *args)
        W.sync(eng.device)
    path = W.cache_path("traces", f"trace_ops_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    cats = ("kernel",) if on_card else ("cpu_op",)
    rows, total = top_events(path, cats, top_n)
    what = "CUDA kernel" if on_card else "CPU op"
    if not rows:
        out(f"no {what} in the trace {path}")
    out(f"total {what} time: {total / reps:.1f} us/exec over {reps} "
        f"execs (trace {path})")
    out(f"{'us/exec':>10}  {'calls':>6}  {'share':>6}  {what}")
    top = []
    for name, calls, us in rows:
        share = us / total if total else 0.0
        out(f"{us / reps:10.1f}  {calls // reps:6d}  {100 * share:5.1f}%  "
            f"{name[:90]}")
        top.append([name, calls // reps, us / reps, share])
    return dict(steady_ms=steady, total_us_per_exec=total / reps,
                events=what, top=top, trace=path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("unit_batch", nargs="?", type=int, default=2048)
    ap.add_argument("reps", nargs="?", type=int, default=5)
    ap.add_argument("top_n", nargs="?", type=int, default=40)
    W.add_common_args(ap)
    a = ap.parse_args(argv)
    index, genome = W.profile_index(a.threads)
    eng = W.engine(index, a.device, a.unit_batch, a.lmax)
    reads = W.load_reads(W.simulate(genome, a.unit_batch // 2)[0],
                         a.unit_batch // 2)
    chunk = W.se_chunk(eng, reads)
    W.say(f"informed cand budget: {chunk.budget}/unit")
    return run(eng, chunk, a.reps, a.top_n)


if __name__ == "__main__":
    main()
