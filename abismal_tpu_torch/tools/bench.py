"""End-to-end mapping throughput of the port, its output verified (↔
bench.py at the repository's root).

Maps simulated 100 bp single-end WGBS reads (1% mutations, bisulfite
converted, seed 1) against the tRex1 index and times five engine
configurations, each in a child process of its own so that none disturbs
another:

  native     the native C++ streaming engine on the host cores (no
             device);
  torch      the fused stage-1+2 program on --device (K1-K3) plus the
             native finalize (the JAX bench's "hybrid");
  split      the native engine in a NativeShardServer process and the
             torch engine on disjoint read shards at once, over 10x the
             reads (seed 2), the device's share calibrated from the two
             engines' rates measured just before;
  pe_native, pe_torch  reads // 2 simulated pairs (seed 3), pairs/s.

A repetition counts only if its output is verified: at the default
10,000 reads the single-end SAM's md5 must equal upstream's golden
(tests/golden/reads.sam.gz); at any other size, and for the split's and
the pairs' sets, the SAM must equal the native engine's on the same
reads.  Each mode reports the best and the median verified rate over its
repetitions, and the device modes their fallback fraction (the engine's
n_fallback / n_units).  Prints ONE JSON line {"metric", "value", "unit",
"modes"}: the JAX bench's keys but its vs_baseline, whose target was set
for a TPU.

The native mode runs first, in two children, and the better is kept; the
device modes run under ABISMAL_BENCH_DEADLINE seconds (1800).  A mode
whose child fails, or outlives the deadline, fails the bench: a device
mode never falls back to the host.

Usage: python -m abismal_tpu_torch.tools.bench [--device cuda|cpu]
           [--reads 10000] [--reps N] [--threads N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

from . import _workload as W

N_READS = 10000
N_REPS = {"native": 20, "torch": 10, "split": 10, "pe_native": 8,
          "pe_torch": 6}
DEVICE_MODES = ("torch", "split", "pe_torch")
GOLDEN_SAM_MD5 = W.GOLDEN_SAM_MD5
DESC = {"torch": "device stage-1+2 + native finalize",
        "split": "hybrid split: native engine + device engine on disjoint "
                 "read shards, concurrently",
        "native": "fully-native streaming engine"}


def _fallback(eng):
    return (eng.n_fallback / eng.n_units) if eng.n_units else None


def _summary(rates, fallback, **extra):
    return {"best": max(rates) if rates else 0.0,
            "median": statistics.median(rates) if rates else 0.0,
            "fallback": fallback, **extra}


def _split(index, idx_path, reads, device, reps, threads, sam,
           golden: bool) -> dict:
    """The split mode (↔ bench.py's "split"): the native shard in its own
    process, the torch engine in this one, over 10x the reads."""
    from ..io.sam import make_sam_header
    from ..map.engine import run_map
    from ..map.hybrid_split import NativeShardServer, run_map_hybrid_split
    from ..map.pipeline import make_torch_native_engine_factory

    n_big = 10 * reads
    big_fq = W.simulate(W.TREX1_FA, n_big, seed=2)[0]
    srv = NativeShardServer(idx_path, threads=threads)
    try:
        dev_f = make_torch_native_engine_factory(device, n_threads=1)
        dev = dev_f(index, False, 0.1, 32, 3000)
        hdr = make_sam_header(index.cl, W.GOLDEN_CL).encode()

        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        def nat_only(src, n):
            srv.map_range(src, None, sam, hdr, False, False, 0, n, False,
                          False)
            srv.wait()

        def split_once(share):
            return timed(lambda: run_map_hybrid_split(
                index, big_fq, None, sam, W.GOLDEN_CL,
                device_share=share, threads=threads, native_server=srv,
                tpu_engine=dev, total_reads=n_big))

        if golden:
            # the server's output on the golden set anchors the truth of
            # the big set, its own output
            nat_only(W.simulate(W.TREX1_FA, reads, seed=1)[0], reads)
            if W.md5(sam) != GOLDEN_SAM_MD5:
                return _summary([], None)
        t_nat = min(timed(lambda: nat_only(big_fq, n_big))
                    for _ in range(2))
        truth = W.md5(sam)
        split_once(0.1)  # warm: the engine's programs, first copies
        t_dev = timed(lambda: run_map(
            index, big_fq, None, sam, None, W.GOLDEN_CL,
            engine_factory=dev_f, threads=threads))
        share = (1.0 / t_dev) / (1.0 / t_dev + 1.0 / t_nat)
        rates = []
        for _ in range(reps):
            dt = split_once(share)
            if W.md5(sam) == truth:
                rates.append(n_big / dt)
    finally:
        srv.close()
    return _summary(rates, _fallback(dev), device_share=round(share, 4))


def run_mode(mode: str, device="cuda", reads: int = N_READS,
             reps: int | None = None, threads: int | None = None) -> dict:
    """Times one mode in this process: {"best", "median", "fallback"} (and
    "device_share" for split), best and median over the verified
    repetitions (reads/s, pairs/s for the pe_ modes), fallback the device
    engine's fallback fraction over every run (None for the native
    engine)."""
    from ..index.serialize import read_index
    from ..map.host_units import make_native_engine_factory

    if mode not in N_REPS:
        raise ValueError(f"mode must be one of {', '.join(N_REPS)}")
    threads = threads or (os.cpu_count() or 1)
    reps = reps or N_REPS[mode]
    idx_path = W.trex1_index_file(threads)
    index = read_index(idx_path)
    sam = W.cache_path("bench", f"{mode}.sam")
    golden = reads == N_READS
    if mode == "split":
        return _split(index, idx_path, reads, device, reps, threads, sam,
                      golden)

    if mode in ("pe_native", "pe_torch"):
        n = reads // 2
        fq1, fq2 = W.simulate(W.TREX1_FA, n, paired=True, seed=3)
        truth = W.truth_md5(index, fq1, fq2, sam, threads, False)
    else:
        n, fq1, fq2 = reads, W.simulate(W.TREX1_FA, reads, seed=1)[0], None
        truth = W.truth_md5(index, fq1, None, sam, threads, golden)
    if mode in DEVICE_MODES:
        from ..map.pipeline import make_torch_native_engine_factory

        factory = make_torch_native_engine_factory(device, n_threads=threads)
    else:
        factory = make_native_engine_factory(n_threads=threads)

    _, runs = W.timed_maps(index, fq1, fq2, sam, factory, threads, reps)
    rates = [n / wall for wall, _, m in runs if m == truth]
    # the memoizing factory returns the live engine, whose counters cover
    # every run above
    return _summary(rates, _fallback(factory(index, False, 0.1, 32, 3000))
                    if mode in DEVICE_MODES else None)


def _run_child(mode: str, deadline, argv) -> dict | None:
    """run_mode in a child process (python -m ...tools.bench --mode M
    argv); its dict, or None if it failed or outlived deadline."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (W.ROOT, os.environ.get("PYTHONPATH")) if p))
    try:
        p = subprocess.run(
            [sys.executable, "-m", "abismal_tpu_torch.tools.bench",
             "--mode", mode, *argv], capture_output=True, text=True,
            timeout=deadline, env=env)
    except subprocess.TimeoutExpired:
        W.say(f"[bench: mode {mode} outlived {deadline} s]")
        return None
    for line in reversed(p.stdout.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    W.say(f"[bench: mode {mode} failed, rc {p.returncode}]\n"
          f"{p.stderr[-3000:]}")
    return None


def _merge(a, b):
    return b if (a is None or b["best"] > a["best"]) else a


def summary_line(results: dict, pe: dict, threads: int,
                 device_name: str) -> dict:
    """bench.py's line from the modes' dicts: the best SE mode's best rate
    as the value, every mode's best, median, fallback fraction, device
    share and unit (pairs/s) under "modes"."""
    mode = max(results, key=lambda m: results[m]["best"])
    detail = {m: {"best": round(v["best"], 1),
                  "median": round(v["median"], 1),
                  **({"fallback_frac": round(v["fallback"], 5)}
                     if v.get("fallback") is not None else {}),
                  **({"device_share": v["device_share"]}
                     if v.get("device_share") is not None else {})}
              for m, v in {**results, **pe}.items()}
    for m in pe:
        detail[m]["unit"] = "pairs/s"
    return {"metric": f"end-to-end SE mapping, {DESC[mode]} ({threads} "
                      f"threads, {device_name}), output md5-verified",
            "value": round(results[mode]["best"], 1),
            "unit": "reads/s",
            "modes": detail}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=list(N_REPS), default=None,
                    help="run this mode alone and print its dict (the "
                         "children's entry)")
    ap.add_argument("--reads", type=int, default=N_READS)
    ap.add_argument("--reps", type=int, default=None,
                    help="repetitions of every mode (default: "
                         + ", ".join(f"{m} {n}" for m, n in N_REPS.items())
                         + ")")
    W.add_common_args(ap, lmax=False)
    a = ap.parse_args(argv)
    if a.mode:
        res = run_mode(a.mode, a.device, a.reads, a.reps, a.threads)
        print(json.dumps(res), flush=True)
        return res

    import torch

    from ..device import resolve_device

    dev = resolve_device(a.device)  # no card: raises here, not in a child
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    W.trex1_index_file(a.threads)  # made once, before the children
    args = ["--device", a.device, "--reads", str(a.reads), "--threads",
            str(a.threads)]
    if a.reps:
        args += ["--reps", str(a.reps)]
    deadline = int(os.environ.get("ABISMAL_BENCH_DEADLINE", "1800"))
    results, pe = {}, {}
    # native first, alone on the machine, in two children, the better
    # kept: one process's cache and page state moves its rate
    for _ in range(2):
        r = _run_child("native", None, args)
        if r:
            results["native"] = _merge(results.get("native"), r)
    for mode, dst in (("torch", results), ("split", results),
                      ("pe_native", pe), ("pe_torch", pe)):
        r = _run_child(mode, deadline if mode in DEVICE_MODES else None,
                       args)
        if r:
            dst[mode] = r
    missing = [m for m in N_REPS if m not in {**results, **pe}]
    if missing:
        raise RuntimeError(f"bench modes failed: {', '.join(missing)}")
    line = summary_line(results, pe, a.threads, name)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
