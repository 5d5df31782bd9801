"""The port's host tracer: where a map's wall goes on the host, span by
span, on the profiler's clock.

One Tracer belongs to one TorchNativeEngine, which hands it to its graph
runner (graphs.Graphs or graphs.Eager) and to its native half
(NativeMappingEngine); the batch loop (run_map_pipelined) finds it on the
engine.  It is off by default, and a span then costs one attribute test
and records nothing.  On, a span

- records its path (the names of the spans open around it and its own,
  joined by "/", e.g. "map/finish/collect/device_wait"), its calls, its
  total seconds and its self seconds (the total less its children's
  totals), on one monotonic host clock (time.perf_counter_ns);
- opens torch.profiler.record_function("abismal:<name>"), so that under
  a profiler the spans lie on the timeline of the card's activity.

While on, device_wait blocks on the card's current stream before a
blocking copy, in a span of its own, so that the copy's span is the
transfer alone; off, no synchronize is added.

Counters: reads (each mate counts), batches, read_bytes (the FASTQ text
the batch loop's reader parsed, uncompressed, both files of a pair,
skipped records included; counted once a map),
chunks (graph replays or eager runs of a device program), captures (a
capture during a map means a graph was built again), oversized (the reads
longer than the engine's lmax, each mate counted, that go up as
zero-length rows and are mapped on the host whole), pool_jobs (batches
handed to the native finalize pool), pool_waits (finish calls that
blocked on the pool, in finish/native_wait: 1 - pool_waits / pool_jobs
is the share of batches whose finalize the batch loop did not wait for),
pool_first (items the card handed back, which the pool claims first:
SE reads of status 3, PE pairs with a unit of cnt < 0), encoded_units
(the unit rows the native encoder wrote with bases in dispatch/encode:
per a read, and per / 2 a mate with bases, of the reads and pairs within
lmax; empty and oversized ones go up as zero-length rows), a_rich_units
(of those rows, the ones whose unit's strand code carries the A-rich
flag: 0 for directional single-end reads, half under random PBAT and of
a pair's units), cv_a_winners and cv_t_winners (the fused single-end
route's records of status exact or aligned, ambiguous ones too, whose
winning strand code is A-rich, CV:A, or T-rich, CV:T), and the native
library's worker nanoseconds in seed, align and format (engine_stage_ns:
the SE finalize, and the PE slot finalize's seeding or slot fill, pair
and single-end alignments, and SAM text).
Turning the tracer on and off sets and clears the library's StageTimers
(engine_set_profile; the flag is the library's, one for the process).

Only the thread that maps records: the event route's collector threads
open no span.  The module imports torch only once a span records: the
native engine's shard processes (parallel/multihost.py) load no torch."""

from __future__ import annotations

import time
import weakref
from collections import defaultdict

import numpy as np

COUNTERS = ("reads", "batches", "read_bytes", "chunks", "captures",
            "oversized", "pool_jobs", "pool_waits", "pool_first",
            "encoded_units", "a_rich_units", "cv_a_winners", "cv_t_winners")
NATIVE = ("seed", "align", "format")  # engine_stage_ns slots 0-2


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "t0", "child", "rf")

    def __init__(self, tracer, name):
        self.tracer, self.name, self.child = tracer, name, 0

    def __enter__(self):
        from torch.profiler import record_function

        self.rf = record_function("abismal:" + self.name)
        self.rf.__enter__()
        self.tracer._stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        tr = self.tracer
        path = "/".join(s.name for s in tr._stack)
        tr._stack.pop()
        if tr._stack:
            tr._stack[-1].child += dt
        rec = tr._spans[path]
        rec[0] += 1
        rec[1] += dt
        rec[2] += dt - self.child
        self.rf.__exit__(*exc)
        return False


class Tracer:
    """Spans and counters of the maps of one engine (module docstring)."""

    def __init__(self):
        self._on = False
        self._stack = []
        self._native = None  # weakref to the NativeMappingEngine bound
        self.reset()

    @property
    def on(self) -> bool:
        return self._on

    @on.setter
    def on(self, value: bool):
        self._on = bool(value)
        nat = self._native and self._native()
        if nat is not None:
            nat.lib.engine_set_profile(nat._ctx, int(self._on))

    def bind_native(self, native) -> None:
        """Makes native's worker counters the tracer's native counters."""
        self._native = weakref.ref(native)
        self._native_base = self._native_ns()

    def span(self, name: str):
        """A context manager: the span `name` while on, nothing while off."""
        if not self._on:
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if self._on:
            self._counts[name] += n

    def device_wait(self, device) -> None:
        """While on, on a CUDA device: waits for the device's current
        stream in a device_wait span (the caller's blocking copy follows).
        The CPU has no stream: nothing is recorded there."""
        if self._on and device.type == "cuda":
            import torch

            with self.span("device_wait"):
                torch.cuda.current_stream(device).synchronize()

    def _native_ns(self):
        nat = self._native and self._native()
        if nat is None:
            return None
        ns = np.zeros(16, dtype=np.int64)
        nat.lib.engine_stage_ns(nat._ctx, ns.ctypes.data, 0)
        return ns[: len(NATIVE)]

    def reset(self) -> None:
        """Forgets every span and counter recorded so far (spans open now
        still record when they close)."""
        self._spans = defaultdict(lambda: [0, 0, 0])
        self._counts = dict.fromkeys(COUNTERS, 0)
        self._native_base = self._native_ns()

    def summary(self) -> dict:
        """{"spans": {path: (calls, total s, self s)}, "counters": {name:
        count}}; the native counters are native_<stage>_s, worker seconds
        summed over the native half's threads (absent without one)."""
        spans = {p: (c, t / 1e9, s / 1e9)
                 for p, (c, t, s) in self._spans.items()}
        counters = dict(self._counts)
        ns = self._native_ns()
        if ns is not None:
            for name, v in zip(NATIVE, ns - self._native_base):
                counters[f"native_{name}_s"] = int(v) / 1e9
        return {"spans": spans, "counters": counters}
