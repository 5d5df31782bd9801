"""Device programs run as captured CUDA graphs: the port's counterpart of
jax.jit plus the JAX engine's per-key program cache
(abismal_tpu/map/pipeline.py _stage12_prog / _stage12pe_prog).

JAX traces a program once per shape key and runs each chunk as one
dispatch of the compiled executable.  Run eagerly, the port's programs
issue every torch op of a chunk from Python (~1,300 launches for a
2048-unit chunk), and the card idles between them.  Graphs captures a
program once per (program, device, bound tensors, shapes and dtypes of
the per-chunk inputs) as a torch.cuda.CUDAGraph; each later chunk copies
its host arrays into the graph's static inputs and replays it, one launch.

- Bound tensors (the index tables, a shard's lists and bounds) are passed
  as they are: their addresses are baked into the graph, which keeps a
  reference to them.
- The first call of a key runs the program once eagerly on a side stream
  (it builds and loads the kernels; its result is that chunk's), then
  captures it in the memory pool that one Graphs object shares among its
  graphs on a device.
- Each chunk's host arrays are copied into the static inputs with a
  blocking copy, in stream order after the previous replay.
- Every output is cloned on the device right after its replay, on the
  same stream: the engine keeps the rows of many chunks in flight, and the
  next replay rewrites the static outputs.  A clone is one device copy a
  chunk that the engine's finish already collects, where a pinned host
  copy would need a buffer per chunk in flight and an event to read it.
  The clone also makes the shared pool safe: another graph of the pool
  may reuse a freed intermediate's memory for its static outputs, and
  those are consumed before any other replay.
- The kernel wrappers' launch counters count the kernels a replay runs:
  a capture launches nothing, so the counts it added are taken back and
  added again at every replay.
- A failed capture or replay raises.  Nothing falls back to the eager
  program.
- The engine's tracer (tracing.Tracer), handed to the runner, times the
  copy in (stage_in, with the wait on the card before it as device_wait),
  the replay's enqueue and the clones (replay) and the warm run with the
  capture (capture), and counts chunks and captures.

Eager runs the programs op by op behind the same run(): the engines use
it with graphs=False or on the CPU, and Graphs on a CUDA device."""

from __future__ import annotations

import time

import numpy as np
import torch

from .device import device_context, put
from .kernels.banded_align import (
    banded_score_packed, banded_trace, banded_trace_packed,
)
from .kernels.candidate_list import candidate_list
from .kernels.popcount_compare import popcount_compare
from .kernels.seed_extend import seed_extend
from .kernels.segment_rank import segment_rank
from .tracing import Tracer

# the kernel wrappers whose launch counters a replay advances
COUNTED = (popcount_compare, banded_score_packed, banded_trace_packed,
           banded_trace, seed_extend, segment_rank, candidate_list)


def capture(fn, pool, stream):
    """(graph, outputs): fn() captured as a torch.cuda.CUDAGraph on stream,
    its allocations from pool.  thread_local: the event route's collector
    threads copy earlier chunks' streams to the host during a capture,
    which the default "global" mode refuses."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
        out = fn()
    return graph, out


def _mark(marks, name):
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))


class GraphedProgram:
    """One program captured for one key (see the module docstring).
    inputs are the static input tensors, in the program's order after the
    bound ones; outputs the static outputs (a tuple); capture_s, the
    seconds of the warm run and the capture; pool_bytes, what the capture
    added to the device's reserved memory (its share of the pool);
    captured, (kernel wrapper, launches) of one replay; replays, the
    count of replays."""

    def __init__(self, prog, bound, kwargs, args, pool, stream, tracer):
        self.prog, self.bound, self.kwargs = prog, tuple(bound), kwargs
        self.tracer = tracer
        self.device = self.bound[0].device
        self.pool, self.stream = pool, stream
        self._cuda = self.device.type == "cuda"
        self.inputs = tuple(
            torch.empty_like(torch.from_numpy(np.ascontiguousarray(a)),
                             device=self.device)
            for a in args)
        self.graph = self.outputs = None
        self._single = False
        self.captured = ()
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def _run(self):
        return self.prog(*self.bound, *self.inputs, **self.kwargs)

    def _copy_in(self, args):
        """The chunk's host arrays into the static inputs."""
        for dst, a in zip(self.inputs, args):
            dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))

    def __call__(self, args, marks=None):
        """The program's outputs on the chunk args (host arrays of the
        key's shapes and dtypes), which no later call overwrites.  marks,
        a list, gets ("start", "end") CUDA events around the run."""
        tr = self.tracer
        tr.count("chunks")
        with device_context(self.device):
            with tr.span("stage_in"):
                tr.device_wait(self.device)
                self._copy_in(args)
            if self.graph is None:
                tr.count("captures")
                with tr.span("capture"):
                    return self._warm_and_capture(marks)
            with tr.span("replay"):
                _mark(marks, "start")
                self.graph.replay()
                _mark(marks, "end")
                for k, n in self.captured:
                    k.launches += n
                self.replays += 1
                out = tuple(t.clone() for t in self.outputs)
        return out[0] if self._single else out

    def _warm_and_capture(self, marks):
        t0 = time.perf_counter()
        _mark(marks, "start")
        if self._cuda:
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                out = self._run()
            cur.wait_stream(self.stream)
        else:
            out = self._run()
        self._single = torch.is_tensor(out)
        out = (out,) if self._single else tuple(out)
        if self._cuda:
            for t in out:  # made on the side stream, read on this one
                t.record_stream(cur)
        _mark(marks, "end")
        counts = [k.launches for k in COUNTED]
        if self._cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
        self.graph, static = capture(self._run, self.pool, self.stream)
        self.outputs = (static,) if self._single else tuple(static)
        self.captured = tuple((k, k.launches - c)
                              for k, c in zip(COUNTED, counts)
                              if k.launches != c)
        for k, c in zip(COUNTED, counts):
            k.launches = c
        if self._cuda:
            torch.cuda.synchronize(self.device)
            self.pool_bytes = (torch.cuda.memory_reserved(self.device)
                               - reserved)
        self.capture_s = time.perf_counter() - t0
        return out[0] if self._single else out

    def stats(self) -> dict:
        return dict(program=self.prog.__qualname__,
                    device=str(self.device),
                    shapes=[list(t.shape) for t in self.inputs],
                    capture_s=self.capture_s, pool_bytes=self.pool_bytes,
                    replays=self.replays,
                    captured_launches={k.__name__: n
                                       for k, n in self.captured})


class Graphs:
    """One engine's captured programs: a GraphedProgram per (program,
    device, bound tensors, per-chunk input shapes and dtypes), and per
    device one memory pool and one stream (for the warm runs and the
    captures) that its graphs share; tracer, the engine's."""

    def __init__(self, tracer: Tracer | None = None):
        self._graphs = {}
        self._pools = {}
        self.tracer = Tracer() if tracer is None else tracer

    def get(self, prog, bound, args, **kwargs) -> GraphedProgram:
        """The GraphedProgram of prog with the bound tensors bound (and the
        bound tensors kwargs, by name) for chunks shaped like args."""
        dev = bound[0].device
        key = (prog, str(dev),
               tuple(t.data_ptr() for t in bound),
               tuple((k, t.data_ptr()) for k, t in sorted(kwargs.items())),
               tuple((np.shape(a), np.asarray(a).dtype.str) for a in args))
        gp = self._graphs.get(key)
        if gp is None:
            if str(dev) not in self._pools:
                with device_context(dev):
                    self._pools[str(dev)] = (
                        (torch.cuda.graph_pool_handle(),
                         torch.cuda.Stream(dev))
                        if dev.type == "cuda" else (None, None))
            gp = GraphedProgram(prog, bound, kwargs, args,
                                *self._pools[str(dev)], self.tracer)
            self._graphs[key] = gp
        return gp

    def run(self, prog, bound, args, marks=None, **kwargs):
        """prog's outputs on the chunk's host arrays args (see get)."""
        return self.get(prog, bound, args, **kwargs)(args, marks)

    def stats(self) -> list[dict]:
        return [gp.stats() for gp in self._graphs.values()]


class Eager:
    """The programs run op by op, behind Graphs' run(): each chunk's host
    arrays are put on the bound tensors' device (stage_in), the program
    runs (run), and marks, a list, gets the program's own phase marks."""

    def __init__(self, tracer: Tracer | None = None):
        self.tracer = Tracer() if tracer is None else tracer

    def run(self, prog, bound, args, marks=None, **kwargs):
        dev = bound[0].device
        tr = self.tracer
        tr.count("chunks")
        if marks is not None:
            kwargs["marks"] = marks
        with device_context(dev):
            with tr.span("stage_in"):
                tr.device_wait(dev)
                ins = [put(a, dev) for a in args]
            with tr.span("run"):
                return prog(*bound, *ins, **kwargs)


def use_graphs(graphs: bool, device,
               tracer: Tracer | None = None) -> Graphs | Eager:
    """The engines' runner of their device programs: Graphs on a CUDA
    device unless graphs is False, Eager otherwise; tracer, the engine's."""
    return (Graphs(tracer) if graphs and device.type == "cuda"
            else Eager(tracer))
