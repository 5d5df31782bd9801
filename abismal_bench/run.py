"""One run of one cell of the benchmark of abismal_tpu_torch, the PyTorch
and CUDA port of the bisulfite read mapper.

  python3 abismal_bench/run.py --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

Set-up builds the cell's configuration (BENCHMARK.json, then
abismal_bench/configs/ and abismal_bench/workloads/): the genome and the
port's index of it, cached under build/abismal_bench/ in the checkout;
the port's engine with its tables on the card; a pool of reads drawn
from --seed, in FASTQ files; and one warm-up map of the first pool file.
The window then maps the pool files one after another, as `python -m
abismal_tpu_torch map` does with the configuration's settings, until
--seconds have passed, each map's SAM to a file of its own.  After the
window the plain reference (abismal_bench/reference/check.py) judges a
sample of the records, drawn from the seed, and decides `correct`.

--trace 0 reports the cell's end-to-end metrics; --trace 1 wraps the
engine's calls in spans, profiles the window's second map with
torch.profiler, counts the kernels' work on the arguments of each chunk
of an eager map of the same pool file after the window, and reports the
per-layer metrics, each read by abismal_bench/metrics/<metric>.py.  The last line of standard output is
one JSON object; the numbers compared are its last key and the last
lines of standard error.

It exits 3, printing no result, where CUDA is missing or has fewer cards
than the cell asks for, and 4 where jax, jaxlib, flax or abismal_tpu was
loaded by the time the window closed."""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BANNED = ("jax", "jaxlib", "flax", "abismal_tpu")
PROFILED = 1  # the map of the window that a traced run profiles
RECORD_FAULTS_LIMIT = 0


class NoCard(RuntimeError):
    pass


def say(msg: str) -> None:
    """A progress line on standard error, with the process's seconds."""
    print(f"[abismal_bench {time.perf_counter() - _T0:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float = 0.0
    window_s: float = 0.0
    reads: int = 0
    maps: int = 0
    loop_wall_s: float = 0.0  # the window's wall but the profiled map's
    spans: object = None
    counters: dict = field(default_factory=dict)
    trace: dict | None = None
    recorded: dict = field(default_factory=dict)


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of BANNED, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _sync(device):
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _profiled_map(system, fq, sam, out_dir):
    """One map under torch.profiler, annotated; its reduced trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from abismal_bench.harness.trace import reduce_trace

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    system.spans.on, system.spans.annotate = False, True
    with profile(activities=acts) as prof:
        with record_function("bench:map"):
            system.map(fq[0], fq[1], sam)
    system.spans.on, system.spans.annotate = True, False
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    red = reduce_trace(path)
    os.remove(path)
    return red


def _record_kernels(system, fq, wanted: dict, device, out: str) -> dict:
    """What the metrics in wanted ({metric: its reader module}) count on
    the arguments that every call of their kernel's entry point (RECORD,
    an attribute of map/pipeline.py) is handed, in one eager map of the
    pool file fq by the window's engine, the same chunks that a graphed
    map of fq replays (the recording pattern of chip_smoke.py:794).  Each
    count is taken before the call.  {metric: [count a call]}."""
    from abismal_tpu_torch.graphs import Eager
    from abismal_tpu_torch.map import pipeline

    eng = system.engine
    seen = {m: [] for m in wanted}
    fns = sorted({mod.RECORD for mod in wanted.values()})
    inner = {fn: getattr(pipeline, fn) for fn in fns}

    def stand_in(fn):
        def call(*args):
            for m, mod in wanted.items():
                if mod.RECORD == fn:
                    seen[m].append(mod.count(args))
            return inner[fn](*args)
        return call

    graphs, eng.graphs = eng.graphs, Eager()
    system.spans.on = False
    for fn in fns:
        setattr(pipeline, fn, stand_in(fn))
    try:
        system.map(fq[0], fq[1], out)
        _sync(device)
    finally:
        for fn in fns:
            setattr(pipeline, fn, inner[fn])
        eng.graphs = graphs
    return seen


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", require_card: bool = True, hook=None,
        root: str = ROOT, bench_dir: str | None = None,
        build: str | None = None, t0: float = _T0,
        min_maps: int = 1) -> dict:
    """One run of the cell; its result (the printed line's dict) and, under
    "stderr", the lines for standard error.  hook(system), when given, is
    called on the built system before the warm-up map; the window maps at
    least min_maps pool files (a traced one at least PROFILED + 2)."""
    import torch

    from abismal_bench.harness import inputs, spec
    from abismal_bench.harness.host import HostLog
    from abismal_bench.harness.system import System, resolve
    from abismal_bench.harness.trace import kernel_time
    from abismal_bench.reference.check import Judge, conversion_of

    cell = spec.find_cell(cell_name, root, bench_dir or spec.BENCH)
    chips = int(cell.entry["chips"])
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        raise NoCard(f"the cell needs {chips} CUDA device(s); "
                     f"{torch.cuda.device_count()} found")
    conf, wl = cell.config, cell.workload
    st, paired = resolve(conf["settings"]), bool(conf["paired"])
    mates = 2 if paired else 1
    fa, genome = inputs.genome_files(conf, build)
    say("genome ready")
    idx_path = inputs.index_file(fa, int(st["threads"]))
    say("index ready")
    pool = inputs.make_pool(genome, wl, seed, paired)
    say(f"pool of {pool.n} simulated")

    from abismal_tpu_torch.index.serialize import read_index

    with tempfile.TemporaryDirectory(prefix="abismal_bench_") as tmp:
        files, bounds = inputs.write_pool(
            pool, int(wl["traffic"]["pool_files"]), tmp)
        index = read_index(idx_path)
        say("index read")
        system = System(index, idx_path, st, device, paired)
        say("engine built")
        if hook is not None:
            hook(system)
        spans = system.add_spans() if trace else None
        system.map(*files[0], os.path.join(tmp, "warm.sam"))
        _sync(device)
        r = Run(setup_s=time.perf_counter() - t0, spans=spans)
        say(f"warm-up map done: set-up {r.setup_s:.3f} s")
        if spans is not None:
            spans.total = {k: 0.0 for k in spans.total}
            spans.calls = {k: 0 for k in spans.calls}

        maps, profiled_s, map_s, all_s = [], 0.0, [], []
        host = HostLog()
        w0 = time.perf_counter()
        while True:
            i = len(maps)
            f = i % len(files)
            sam = os.path.join(tmp, f"map{i}.sam")
            if trace and i == PROFILED:
                m0 = time.perf_counter()
                r.trace = _profiled_map(system, files[f], sam, tmp)
                profiled_s = time.perf_counter() - m0
            else:
                m0 = time.perf_counter()
                system.map(*files[f], sam)
                map_s.append(time.perf_counter() - m0)
            all_s.append(time.perf_counter() - m0)
            host.mark()
            maps.append((f, sam))
            r.reads += (bounds[f][1] - bounds[f][0]) * mates
            if (time.perf_counter() - w0 >= seconds
                    and len(maps) >= (PROFILED + 2 if trace else min_maps)):
                break
        _sync(device)
        r.window_s = time.perf_counter() - w0
        r.maps = len(maps)
        r.loop_wall_s = r.window_s - profiled_s
        say(f"window closed: {len(maps)} maps, {r.window_s:.3f} s")
        peak = (torch.cuda.max_memory_reserved()
                if device.startswith("cuda") else 0)
        r.counters = system.counters()
        wanted = cell.per_layer if trace else cell.end_to_end
        readers = {m["name"]: spec.reader(m["name"], bench_dir or spec.BENCH)
                   for m in wanted}
        recording = {m: mod for m, mod in readers.items()
                     if hasattr(mod, "RECORD")}
        if trace and recording:
            r.recorded = _record_kernels(
                system, files[PROFILED % len(files)], recording, device,
                os.path.join(tmp, "recorded.sam"))
        recorded_lines = [
            f"recorded {m}: {len(r.recorded.get(m, []))} calls, "
            f"{sum(1 for b in r.recorded.get(m, []) if b)} live; trace "
            f"{mod.KERNEL}: {kernel_time(r.trace, mod.KERNEL)}"
            for m, mod in recording.items() if trace]
        metrics = {}
        for m in wanted:
            v = readers[m["name"]].read(r)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        r.recorded = {}
        system.close()
        del system, index
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()

        # the plain reference, once the program's state is freed
        chk = wl["check"]
        judge = Judge(genome, pool, bounds, paired,
                      float(st["max_distance"]),
                      conversion_of(st, paired), bool(st["bam"]))
        res = judge.judge(maps, seed, int(chk["sample_reads"]))
    say("judged")
    limits = {"record_faults": RECORD_FAULTS_LIMIT,
              "missed_share": float(chk["missed_share"])}
    check = {k: {"value": res[k], "limit": limits[k]} for k in limits}
    correct = all(res[k] <= limits[k] for k in limits)
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if device.startswith("cuda") else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": r.reads, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace and r.trace is not None:
        dev["busy_s"] = r.trace["busy_s"]
        dev["window_s"] = r.trace["window_s"]
        out["breakdown"] = {"device_ops": r.trace["device_ops"],
                            "idle_gaps": r.trace["idle_gaps"]}
    out["check"] = check
    out["stderr"] = [
        "map seconds: " + " ".join(f"{x:.3f}" for x in map_s),
        *recorded_lines,
        *host.lines(all_s),
        f"window: {r.maps} maps, {r.reads} reads in {r.window_s:.3f} s; "
        f"judged {res['checked']} records, {res['eligible']} mates "
        f"eligible, {res['missed']} missed; faults {res['faults']}",
        *(f"check {k}: {v['value']} limit {v['limit']}"
          for k, v in check.items())]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        out = run(a.workload, a.seed, a.seconds, bool(a.trace))
    except NoCard as e:
        print(f"abismal_bench: {e}", file=sys.stderr)
        return 3
    found = banned_modules()
    if found:
        print(f"abismal_bench: loaded {', '.join(found)}", file=sys.stderr)
        return 4
    lines = out.pop("stderr")
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
