#!/usr/bin/env python3
"""Whole-path mapping rates of two or more checkouts on one card, taken
in turns within one run, so that a drift of the host's speed falls on
every checkout alike.

    python3 path_rates.py --tree A --tree B [--rounds 10] [--out FILE]

Every --tree names a checkout of the repository (a directory that holds
abismal_tpu_torch/); one named twice gets two processes (slots), which
shows what two processes of the same code differ by.  The 1 Gb synthetic genome of chip_smoke.py's scale
phase and 20k simulated reads and 20k pairs are made once; then one
process per checkout builds the index with its own code, makes its
engine, maps each set twice (cold, warm) and waits.  The processes are
then asked in turns (A B, B A, A B, ...), one pass at a time while the
others sleep: the 20k reads with the port engine (se), the 20k pairs
(pe), and the 20k reads with the native engine alone (native), whose C++
is the control.  A pass is a whole run_map, reads in, SAM out, as in the
scale phase; its rate, its mean device span per chunk and the part of it
from the decisions to K2's scores (score_ms) are printed, and
at the end per checkout the median of each, and whether the SAMs of all
checkouts are the same bytes.  The genome, the read sets and the mapping
helpers are those of the chip_smoke.py beside this script."""

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
KINDS = ("se", "pe", "native")


def smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_sets(cs, work):
    """The scale phase's genome, reads and pairs, from this checkout's
    code; returns (fasta, se fastq, pe fastq 1, pe fastq 2)."""
    from abismal_tpu_torch.host import SimConfig, simulate_reads

    size = cs.SCALE_MB * 1_000_000
    fa = os.path.join(work, f"scale_{size}.fa")
    if not os.path.exists(fa):
        cs.gen_genome(fa + ".tmp", size)
        os.replace(fa + ".tmp", fa)
    pre = os.path.join(work, "reads")
    for single, prefix in ((True, pre + "_se"), (False, pre + "_pe")):
        simulate_reads(fa, SimConfig(
            output_prefix=prefix, n_reads=20000, mutation_rate=0.01,
            bs_conv=0.98, seed=1, single_end=single))
    return fa, pre + "_se_1.fq", pre + "_pe_1.fq", pre + "_pe_2.fq"


def worker(tree, work, fa, fq, fq1, fq2):
    """Serves passes over the sets with the package of `tree`: reads one
    kind per line on stdin, answers one JSON line each."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from abismal_tpu_torch.host import create_index, make_native_engine_factory
    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory

    cs = smoke_module()
    threads = min(8, os.cpu_count() or 1)
    tag = hashlib.md5(os.path.abspath(tree).encode()).hexdigest()[:8]
    sam = os.path.join(work, f"out_{tag}_{os.getpid()}")
    index = create_index(fa, n_threads=threads)
    factory = make_torch_native_engine_factory(torch.device("cuda"),
                                               n_threads=threads)
    native = make_native_engine_factory(n_threads=threads)

    def one(kind):
        out = f"{sam}_{kind}.sam"
        if kind == "native":
            secs = cs.map_with(native, index, fq, out, None, "scale", threads)
            return {"per_s": cs.n_reads_of(fq) / secs}, out
        pair = fq2 if kind == "pe" else None
        st = cs.port_map(factory, index, fq1 if pair else fq, out, None,
                         "scale", threads, pair)
        return {"per_s": st["pairs_per_s" if pair else "reads_per_s"],
                "span_ms": st.get("total_ms"),
                "score_ms": st.get("score_ms"),
                "dispatch_s": st["host_s"].get("device dispatch")}, out

    md5s = {}
    for kind in KINDS:  # cold, then warm; the warm SAM is the one compared
        one(kind)
        _, out = one(kind)
        md5s[kind] = cs.md5(out)
    print(json.dumps({"ready": tree, "sam_md5": md5s}), flush=True)
    for line in sys.stdin:
        kind = line.strip()
        if kind not in KINDS:
            break
        print(json.dumps(one(kind)[0]), flush=True)


def answer(proc):
    """The next JSON line of a worker's output ({} once it has ended);
    whatever else the mapping code prints is passed over."""
    for line in proc.stdout:
        if line.startswith("{"):
            return json.loads(line)
    return {}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--worker", nargs=6, default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(*a.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("path_rates: needs a CUDA card", file=sys.stderr)
        return 2
    if len(a.tree) < 2:
        ap.error("give two or more --tree")
    from abismal_tpu_torch.device import card_info

    cs = smoke_module()
    work = os.path.join(ROOT, "build", "path_rates")
    os.makedirs(work, exist_ok=True)
    lines = []

    def say(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    say({"card": card_info(), "rounds": a.rounds, "trees": a.tree})
    sets = make_sets(cs, work)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", tree, work,
         *sets], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for tree in a.tree]
    try:
        ready = [answer(p) for p in procs]
        if not all("ready" in r for r in ready):
            print("path_rates: a worker failed to start", file=sys.stderr)
            return 1
        same = all(r["sam_md5"] == ready[0]["sam_md5"] for r in ready)
        say({"sam_identical_across_trees": same})
        res = {kind: [[] for _ in procs] for kind in KINDS}
        for kind in KINDS:
            for rnd in range(a.rounds):
                order = list(range(len(procs)))
                if rnd % 2:
                    order.reverse()
                for i in order:
                    procs[i].stdin.write(kind + "\n")
                    procs[i].stdin.flush()
                    got = answer(procs[i])
                    if "per_s" not in got:
                        print(f"path_rates: {a.tree[i]} ended early",
                              file=sys.stderr)
                        return 1
                    res[kind][i].append(got)
                    say({"kind": kind, "round": rnd, "tree": a.tree[i],
                         "slot": i, **got})
        for kind in KINDS:
            for i, tree in enumerate(a.tree):
                row = {"kind": kind, "tree": tree, "slot": i}
                for key in ("per_s", "span_ms", "score_ms", "dispatch_s"):
                    vals = [r[key] for r in res[kind][i]
                            if r.get(key) is not None]
                    if vals:
                        row[f"median_{key}"] = statistics.median(vals)
                        row[f"min_{key}"], row[f"max_{key}"] = (min(vals),
                                                                max(vals))
                say(row)
        if not same:
            print("path_rates: the checkouts' SAMs differ", file=sys.stderr)
            return 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.stdin.close()  # end of input ends the worker's loop
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
        if a.out:
            os.makedirs(os.path.dirname(os.path.abspath(a.out)),
                        exist_ok=True)
            with open(a.out, "w") as f:
                f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
