"""The system under test, driven as `python -m abismal_tpu_torch map` runs
it (abismal_tpu_torch/cli.py:cmd_map) with the configuration's settings:
the engine of map.pipeline.make_torch_native_engine_factory, and with
`engine: hybrid` the native engine's shard in a process of its own beside
it (map/hybrid_split.py); reads in from FASTQ, SAM or BAM out to a file.

The settings are the `map` command's options under their long names
(SETTINGS), each passed where the command passes it; a key the harness
does not know, or a combination the command refuses, is an error, so a
configuration never runs other than it says.  The harness's spans wrap
the engine's dispatch and finish calls from outside (instance
attributes), and only in a traced run."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

# the `map` options a configuration may set (cmd_map's long names, '-'
# as '_'), with the command's defaults; -i, -o and the reads are the
# harness's, and left out are the options that only report (-s, -j, -v),
# split the run over processes (--hosts, --shard), or break a guarantee
# the judge holds a run to (-a: ambiguous reads reported)
SETTINGS = {
    "engine": "torch", "max_distance": 0.1, "min_frag": 32,
    "max_frag": 3000, "lmax": 128, "unit_batch": 2048, "threads": 1,
    "max_candidates": 0, "pbat": False, "random_pbat": False,
    "a_rich": False, "bam": False, "device_align": False,
    "device_share": None, "mesh": None, "index_shards": None,
}
ENGINES = ("torch", "hybrid")  # those that drive the card
FLAGS = {"pbat": "-P", "random_pbat": "-R", "a_rich": "-A", "bam": "-B",
         "device_align": "--device-align"}


def resolve(settings: dict) -> dict:
    """The settings over the command's defaults; ValueError for a key the
    harness does not know or a combination `map` refuses."""
    unknown = sorted(set(settings) - set(SETTINGS))
    if unknown:
        raise ValueError(f"settings the harness does not know: {unknown}")
    s = {**SETTINGS, **settings}
    if s["engine"] not in ENGINES:
        raise ValueError(f"engine {s['engine']!r}: the benchmark drives "
                         f"the card, with one of {ENGINES}")
    if int(s["lmax"]) < 64:
        raise ValueError("lmax must be at least 64")
    for opt in ("mesh", "index_shards"):
        if s[opt] is not None and (s["engine"] != "torch"
                                   or s["device_align"]):
            raise ValueError(f"{opt} runs with engine torch alone, without "
                             f"device_align")
    if s["mesh"] is not None and s["index_shards"] is not None:
        raise ValueError("mesh cannot be combined with index_shards")
    if (s["device_share"] is None) == (s["engine"] == "hybrid"):
        raise ValueError("device_share is set with engine hybrid alone, "
                         "and always there: unset, the program reads it "
                         "from the environment")
    return s


def command_line(s: dict) -> str:
    """The `map` command line that these settings stand for (@PG)."""
    words = ["map", "-m", str(s["max_distance"]), "-l", str(s["min_frag"]),
             "-L", str(s["max_frag"]), "--lmax", str(s["lmax"]),
             "-t", str(s["threads"])]
    if s["engine"] != "torch":
        words += ["--engine", s["engine"]]
    if s["max_candidates"]:
        words += ["-c", str(s["max_candidates"])]
    words += [f for k, f in FLAGS.items() if s[k]]
    for k in ("device_share", "mesh", "index_shards"):
        if s[k] is not None:
            words += [f"--{k.replace('_', '-')}", str(s[k])]
    return " ".join(words + ["-o", "out.sam", "-i", "genome.idx",
                             "reads.fq"])


def _slots(val, device: str):
    """A --mesh or --index-shards value as the command resolves it."""
    from abismal_tpu_torch.parallel.mesh import make_mesh

    if not device.startswith("cuda"):
        if val == "all":
            raise ValueError("mesh all needs CUDA devices")
        return make_mesh([device] * int(val))
    return make_mesh(val if val == "all" else int(val))


@dataclass
class Spans:
    """Host seconds and calls of the engine's dispatch and finish; the
    profiler's annotations while `annotate` is on."""

    total: dict = field(default_factory=lambda: {"dispatch": 0.0,
                                                 "finish": 0.0})
    calls: dict = field(default_factory=lambda: {"dispatch": 0,
                                                 "finish": 0})
    on: bool = True
    annotate: bool = False

    def wrap(self, name: str, fn):
        import torch

        def call(*args, **kw):
            ctx = (torch.profiler.record_function(f"bench:{name}")
                   if self.annotate else contextlib.nullcontext())
            t0 = time.perf_counter()
            with ctx:
                out = fn(*args, **kw)
            if self.on:
                self.total[name] += time.perf_counter() - t0
                self.calls[name] += 1
            return out
        return call


class System:
    """One engine (the factory memoizes it per index, as in the CLI), the
    native shard's process of a hybrid engine, and the maps they run."""

    def __init__(self, index, index_path: str, settings: dict, device: str,
                 paired: bool):
        from abismal_tpu_torch.map.pipeline import (
            make_torch_native_engine_factory,
        )

        s = self.s = resolve(settings)
        self.index, self.paired = index, paired
        self.threads = int(s["threads"])
        self.command_line = command_line(s)
        if s["max_candidates"]:
            index.max_candidates = int(s["max_candidates"])
        mesh = shards = None
        unit_batch = int(s["unit_batch"])
        if s["mesh"] is not None:
            # every slot maps the one-device chunk, as cmd_map sets it
            mesh = _slots(s["mesh"], device)
            unit_batch *= len(mesh)
        elif s["index_shards"] is not None:
            shards = _slots(s["index_shards"], device)
        self.factory = make_torch_native_engine_factory(
            device, lmax=int(s["lmax"]), unit_batch=unit_batch,
            n_threads=self.threads, mesh_devices=mesh,
            device_align=True if s["device_align"] else None,
            index_shards=shards)
        self.engine = self.factory(index, False,
                                   float(s["max_distance"]),
                                   int(s["min_frag"]), int(s["max_frag"]))
        self.server = None
        if s["engine"] == "hybrid":
            from abismal_tpu_torch.map.hybrid_split import NativeShardServer

            self.threads = max(1, self.threads)
            self.engine.n_threads = self.threads
            self.server = NativeShardServer(
                index_path, False, float(s["max_distance"]),
                int(s["min_frag"]), int(s["max_frag"]),
                threads=self.threads)
        self.spans = None

    def add_spans(self) -> Spans:
        sp = Spans()
        e = self.engine
        for name, attrs in (("dispatch", ("dispatch_se", "dispatch_pe")),
                            ("finish", ("finish_se", "finish_pe"))):
            for a in attrs:
                setattr(e, a, sp.wrap(name, getattr(e, a)))
        self.spans = sp
        return sp

    def map(self, fq1: str, fq2, out: str):
        s = self.s
        kw = dict(a_rich=bool(s["a_rich"]), pbat=bool(s["pbat"]),
                  random_pbat=bool(s["random_pbat"]),
                  valid_frac=float(s["max_distance"]),
                  pe_min_dist=int(s["min_frag"]),
                  pe_max_dist=int(s["max_frag"]), threads=self.threads,
                  bam=bool(s["bam"]))
        if self.server is not None:
            from abismal_tpu_torch.map.hybrid_split import (
                run_map_hybrid_split,
            )

            return run_map_hybrid_split(
                self.index, fq1, fq2, out, self.command_line,
                device_share=s["device_share"], lmax=int(s["lmax"]),
                tpu_engine=self.engine, native_server=self.server, **kw)
        from abismal_tpu_torch.map.engine import run_map

        return run_map(self.index, fq1, fq2, out, None, self.command_line,
                       engine_factory=self.factory, **kw)

    def counters(self) -> dict:
        e = self.engine
        return dict(n_units=int(e.n_units), n_fallback=int(e.n_fallback))

    def close(self):
        """Drops the engine and its device tables, and ends the native
        shard's process."""
        from abismal_tpu_torch.map import pipeline

        if self.server is not None:
            self.server.close()
            self.server = None
        self.engine.close()
        for k in [k for k, v in pipeline._engine_memo.items()
                  if v[1] is self.engine]:
            del pipeline._engine_memo[k]
        self.engine = self.factory = None
