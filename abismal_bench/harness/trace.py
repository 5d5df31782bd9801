"""The profiler's trace of one map, reduced: the device's busy seconds
(the union of its operations' intervals), each graph replay's span (its
first device operation to its last, grouped by the cudaGraphLaunch that
started it), the device operations by time (and the calls and seconds
of each by name), and the idle gaps by the
harness span that was open on the host (dispatch, finish, or the batch
loop around them)."""

from __future__ import annotations

import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # a templated kernel's name, cut to this length


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(path: str) -> dict:
    """Reads a chrome trace that torch.profiler exported around one map
    annotated `bench:map` (times in microseconds)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, launches, spans = [], set(), defaultdict(list)
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, name[:NAME_CHARS], corr))
        elif cat in ("cuda_runtime", "cuda_driver") and "GraphLaunch" in name:
            launches.add(corr)
        elif name.startswith("bench:"):
            if name == "bench:map":
                window = (ts, ts + dur)
            else:
                spans[name[6:]].append((ts, ts + dur))
    if window is None or not dev:
        return dict(window_s=None, busy_s=0.0, kernels={}, device_ops=[],
                    idle_gaps=[],
                    replay_ms=None, n_replays=0, n_device_ops=len(dev))
    w0, w1 = window
    inside = [d for d in dev if d[1] > w0 and d[0] < w1]
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _, _ in inside])
    busy_us = sum(e - s for s, e in busy)
    by_name = defaultdict(float)
    for s, e, name, _ in inside:
        by_name[name] += (e - s) / 1e6
    reps = defaultdict(list)
    for s, e, _, corr in inside:
        if corr in launches:
            reps[corr].append((s, e))
    replay = [max(e for _, e in v) - min(s for s, _ in v)
              for v in reps.values()]
    gaps = []
    edges = [(w0, w0)] + [tuple(b) for b in busy] + [(w1, w1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            mid = 0.5 * (a + b)
            who = next((k for k, iv in spans.items()
                        if any(s <= mid < e for s, e in iv)), "loop")
            gaps.append([who, (b - a) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    count = defaultdict(int)
    for _, _, name, _ in inside:
        count[name] += 1
    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                kernels={n: (count[n], t) for n, t in by_name.items()},
                device_ops=[[n, t] for n, t in ops[:10]],
                idle_gaps=gaps[:10],
                replay_ms=(sum(replay) / len(replay) / 1e3) if replay
                else None,
                n_replays=len(replay), n_device_ops=len(inside))


def kernel_time(trace, name: str):
    """(instances, seconds) of the device operations of the kernel `name`
    in the reduced trace (a demangled name: its return type, a scope, the
    name, its parameters); None where there are none."""
    if not trace:
        return None
    pat = re.compile(rf"(?:^|[\s:]){re.escape(name)}\s*[(<]")
    hits = [v for k, v in trace["kernels"].items() if pat.search(k)]
    if not hits:
        return None
    return sum(n for n, _ in hits), sum(t for _, t in hits)
