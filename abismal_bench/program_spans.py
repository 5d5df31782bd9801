"""The program's own spans and counters in a run of a cell: the split of a
batch's host time that the engine's tracer (abismal_tpu_torch/tracing.py)
records, read beside the harness's outside timers, and the tracer's cost.
Needs a card, as run.py does; the benchmark's own runs do not run it.

  python3 abismal_bench/program_spans.py --workload <cell> --seed <n>
      --seconds <s> [--on-cost]

The traced split is one `--trace 1` run of run.py, unchanged, with the
tracer switched on after the warm-up map (run.py's hook).  Its readings
are the window's unprofiled maps, the maps that `loop_share`,
`dispatch_ms` and `finish_ms` read:

- read_ms: map/read, ms a call (a batch's FASTQ reading);
- encode_ms: dispatch/encode, ms a dispatch;
- device_wait_ms: every device_wait path, ms a chunk (None without a
  card: the CPU has no stream to wait for);
- native_ms, write_ms: finish/native and finish/write, ms a finish;
- native_busy_share: the native workers' seed, align and format seconds
  over finish/native's seconds times the native threads;

and each span's ms a batch, the program's dispatch and finish means
against the harness's, and the profiled map's idle seconds on the card
split by the innermost program span open over each stretch of them
("none": inside no span).

--on-cost is one `--trace 0` run whose window maps the pool files with
the tracer on and off by turns of one pass over the files each: the
median over the passes with the tracer on of a pass's seconds over those
of the passes beside it, and the host microseconds of one span on and
off.

Prints one JSON object, the last line of standard output."""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MAP = re.compile(r"map(\d+)\.sam$")


def diff(after: dict, before: dict) -> dict:
    """The tracer summary of what happened between two summaries."""
    spans = {}
    for p, (c, t, s) in after["spans"].items():
        c0, t0, s0 = before["spans"].get(p, (0, 0.0, 0.0))
        if c - c0:
            spans[p] = (c - c0, t - t0, s - s0)
    counters = {k: v - before["counters"].get(k, 0)
                for k, v in after["counters"].items()}
    return {"spans": spans, "counters": counters}


def add(a: dict | None, b: dict) -> dict:
    """Two tracer summaries' spans and counters summed."""
    if a is None:
        return b
    spans = dict(a["spans"])
    for p, v in b["spans"].items():
        spans[p] = tuple(x + y for x, y in zip(spans.get(p, (0, 0, 0)), v))
    counters = {k: a["counters"].get(k, 0) + v
                for k, v in b["counters"].items()}
    return {"spans": spans, "counters": counters}


def _sum(spans: dict, suffix: str) -> tuple:
    """(calls, total s) of every span path that ends with suffix."""
    hit = [v for p, v in spans.items()
           if p == suffix or p.endswith("/" + suffix)]
    return sum(v[0] for v in hit), sum(v[1] for v in hit)


def _per(total: float, calls: int):
    return 1e3 * total / calls if calls else None


def metrics(summary: dict, n_threads: int) -> dict:
    """The six readings of a tracer summary (module docstring); None
    where the summary holds nothing to read."""
    sp, c = summary["spans"], summary["counters"]
    n_disp, _ = _sum(sp, "dispatch")
    n_fin, _ = _sum(sp, "finish")
    n_read, t_read = _sum(sp, "read")
    _, t_enc = _sum(sp, "dispatch/encode")
    n_wait, t_wait = _sum(sp, "device_wait")
    _, t_nat = _sum(sp, "finish/native")
    _, t_write = _sum(sp, "finish/write")
    worker = sum(c.get(f"native_{k}_s", 0.0)
                 for k in ("seed", "align", "format"))
    return {
        "read_ms": _per(t_read, n_read),
        "encode_ms": _per(t_enc, n_disp),
        "device_wait_ms": (_per(t_wait, c.get("chunks", 0)) if n_wait
                           else None),
        "native_ms": _per(t_nat, n_fin),
        "write_ms": _per(t_write, n_fin),
        "native_busy_share": (worker / (t_nat * n_threads)
                              if t_nat and "native_seed_s" in c else None),
    }


def _innermost(ranges: list) -> list:
    """[(start, end, path)]: the timeline from the first span's start to
    the last one's end, cut where the innermost open span changes, with
    its path ("/"-joined names; "none" between spans), from ranges
    (start, end, name) that nest, as one thread's spans do."""
    out, stack, t = [], [], None

    def path():
        return "/".join(n for _, n in stack) or "none"

    def close(x):
        nonlocal t
        while stack and stack[-1][0] <= x:
            end = stack[-1][0]
            if end > t:
                out.append((t, end, path()))
                t = end
            stack.pop()

    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        if t is None:
            t = s
        close(s)
        if s > t:
            out.append((t, s, path()))
            t = s
        stack.append((e, name))
    close(float("inf"))
    return out


def idle_by_span(path: str) -> dict:
    """The device's idle seconds inside the `bench:map` window of a
    chrome trace, split by the innermost `abismal:` host span open over
    each stretch of idle time (its path; "none" outside every span); {}
    without device activity."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, ranges, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
        elif cat == "user_annotation":
            if name == "bench:map":
                window = (ts, ts + dur)
            elif name.startswith("abismal:"):
                ranges.append((ts, ts + dur, name[8:]))
    if window is None or not dev:
        return {}
    w0, w1 = window
    busy = []
    for s, e in sorted((max(s, w0), min(e, w1)) for s, e in dev
                       if e > w0 and s < w1):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    edges = [(w0, w0)] + [tuple(b) for b in busy] + [(w1, w1)]
    gaps = [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]
    full = _innermost(ranges)
    if not full:
        full = [(w0, w1, "none")]
    full = ([(w0, full[0][0], "none")] + full
            + [(full[-1][1], w1, "none")])
    out, j = {}, 0
    for a, b in gaps:
        while j < len(full) and full[j][1] <= a:
            j += 1
        k = j
        while k < len(full) and full[k][0] < b:
            s, e, p = full[k]
            ov = min(b, e) - max(a, s)
            if ov > 0:
                out[p] = out.get(p, 0.0) + ov / 1e6
            k += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


class Probe:
    """run.py's hook: wraps the system's map so that the engine's tracer
    is on from the end of the warm-up map to the end of the window, and
    sums the summaries of the window's maps but the profiled one."""

    def __init__(self, profiled: int):
        self.profiled = profiled
        self.maps = None
        self.n_threads = 1

    def hook(self, system):
        tracer = system.engine.tracer
        self.n_threads = system.threads
        inner = system.map

        def traced_map(fq1, fq2, out):
            m = WINDOW_MAP.search(os.path.basename(out))
            if m is None:  # the warm-up, or a map after the window
                tracer.on = False
                res = inner(fq1, fq2, out)
                if os.path.basename(out) == "warm.sam":
                    tracer.reset()
                    tracer.on = True
                return res
            before = tracer.summary()
            res = inner(fq1, fq2, out)
            d = diff(tracer.summary(), before)
            if int(m.group(1)) != self.profiled:
                self.maps = add(self.maps, d)
            return res

        system.map = traced_map


def traced_split(cell: str, seed: int, seconds: float, **run_kw) -> dict:
    """One traced run of the cell with the tracer on (module docstring):
    {"result": run.py's result, "metrics": the six readings, "per_batch_ms":
    each span's total and self ms a batch, "agreement": the program's
    dispatch and finish means over the harness's, "idle_s": idle seconds
    by span, "counters": the unprofiled maps' counters}."""
    from abismal_bench import run as R
    from abismal_bench.harness import trace as T

    probe = Probe(R.PROFILED)
    reduce_trace, idle = T.reduce_trace, {}

    def reduce_with_spans(path):
        idle.update(idle_by_span(path))
        return reduce_trace(path)

    T.reduce_trace = reduce_with_spans
    try:
        out = R.run(cell, seed, seconds, True, hook=probe.hook, **run_kw)
    finally:
        T.reduce_trace = reduce_trace
    s = probe.maps
    sp, c = s["spans"], s["counters"]
    batches = max(1, c["batches"])
    per_batch = {p: (1e3 * t / batches, 1e3 * self_s / batches)
                 for p, (_, t, self_s) in sorted(sp.items())}
    agree = {}
    for name in ("dispatch", "finish"):
        calls, total = _sum(sp, name)
        harness = out["metrics"].get(f"{name}_ms", {}).get("value")
        if calls and harness:
            agree[name] = (1e3 * total / calls) / harness
    return {"result": out, "metrics": metrics(s, probe.n_threads),
            "per_batch_ms": per_batch, "agreement": agree, "idle_s": idle,
            "counters": c}


def on_cost(cell: str, seed: int, seconds: float, **run_kw) -> dict:
    """One untraced run whose window maps the pool files with the tracer on
    and off by turns of one pass over the files (the first pass off):
    {"ratio": the median over the passes with the tracer on of the pass's
    seconds over the mean of the passes beside it, "ratios": each of
    those, "passes": (on, seconds) of each whole pass, "result": run.py's
    result}.  Beside passes, the host's drift over tens of seconds
    (PERF.md section 2) cancels to first order."""
    import time

    from abismal_bench import run as R

    files, maps = [], []

    def hook(system):
        tracer = system.engine.tracer
        inner = system.map

        def timed_map(fq1, fq2, out):
            m = WINDOW_MAP.search(os.path.basename(out))
            if m is None:
                tracer.on = False
                return inner(fq1, fq2, out)
            if fq1 not in files:
                files.append(fq1)
            i = int(m.group(1))
            tracer.on = (i // len(files)) % 2 == 1
            t0 = time.perf_counter()
            res = inner(fq1, fq2, out)
            maps.append((i // len(files), tracer.on,
                         time.perf_counter() - t0))
            tracer.on = False
            return res

        system.map = timed_map

    out = R.run(cell, seed, seconds, False, hook=hook, **run_kw)
    passes = []
    for p in range(len(maps) // len(files)):
        this = [(on, dt) for q, on, dt in maps if q == p]
        passes.append((this[0][0], sum(dt for _, dt in this)))
    ratios = [passes[p][1] / (0.5 * (passes[p - 1][1] + passes[p + 1][1]))
              for p in range(1, len(passes) - 1) if passes[p][0]]
    return {"ratio": statistics.median(ratios) if ratios else None,
            "ratios": ratios, "passes": passes, "span_us": span_cost(),
            "result": out}


def span_cost(n: int = 20000) -> dict:
    """Host microseconds of one empty span of a tracer on and off, each
    the best of three loops of n (no profiler running)."""
    import time

    from abismal_tpu_torch.tracing import Tracer

    tr, out = Tracer(), {}
    for on in (False, True):
        tr.on = on
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                with tr.span("x"):
                    pass
            best = min(best, time.perf_counter() - t0)
        out["on" if on else "off"] = 1e6 * best / n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--on-cost", action="store_true")
    a = ap.parse_args(argv)
    from abismal_bench import run as R

    try:
        res = (on_cost if a.on_cost else traced_split)(a.workload, a.seed,
                                                       a.seconds)
    except R.NoCard as e:
        print(f"abismal_bench: {e}", file=sys.stderr)
        return 3
    lines = res["result"].pop("stderr")
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
