#!/usr/bin/env python3
"""Times the port's CUDA kernels K1-K6 of one or more checkouts on the
card, at the shapes and seeds of chip_smoke.py's kernels phase, so that
two versions of a kernel can be compared within one run.

    python3 kernel_times.py --tree A --tree B \\
        --tree B --tree A [--out FILE]

Every --tree names a checkout of the repository (a directory that holds
abismal_tpu_torch/); each is built and timed in a process of its own, in
the order given.  Per case it prints the kernel's device time from a CUDA
graph of its launches (ms), the time of a Python loop of launches
(host_loop_ms, which the wrapper's host time bounds from below) and
whether the result equals the plain version's.  The cases and the timers
are those of the chip_smoke.py beside this script (kernel_cases), so every
tree must have the entry points of K1-K3 that script names.  K4
(seed_extend) is timed on the pools that the tree's own engine hands it
(chip_smoke.py's ext_pool), with the tree's own wrapper and plain version:
the first chunk of the 10k golden reads, and the first chunk of
chip_smoke.py's scale-phase SE reads on its 1 Gb synthetic genome at the
engine's pool size and at 512 slots (the genome, its index and the reads
are made once, in this process, and each tree's process reads the index
from its file); a tree without K4 is reported as lacking it.  K5
(segment_rank) and K6 (candidate_list) are timed on what the tree's
programs hand them on the first chunk of the 10k golden reads and of the
10k golden pairs (chip_smoke.py's scan_args, k5_case and k6_case); a tree
without them is reported as lacking them."""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scale_set(cs, size_mb):
    """(index file, SE reads) of chip_smoke.py's scale phase at size_mb
    megabases: its genome, index and 20k simulated reads (seed 1), made
    here with the checkout's own code."""
    from abismal_tpu_torch.host import (
        SimConfig, create_index, simulate_reads, write_index,
    )
    from abismal_tpu_torch.tools._workload import gen_genome

    os.makedirs(cs.WORK, exist_ok=True)
    size = size_mb * 1_000_000
    fa = os.path.join(cs.WORK, f"scale_{size}.fa")
    if not os.path.exists(fa):
        gen_genome(fa, size)
    idx = os.path.join(cs.WORK, f"scale_{size}.idx")
    write_index(create_index(fa, n_threads=min(8, os.cpu_count() or 1)), idx)
    pre = os.path.join(cs.WORK, f"scale_{size}_r")
    simulate_reads(fa, SimConfig(output_prefix=pre, n_reads=20000,
                                 mutation_rate=0.01, bs_conv=0.98, seed=1,
                                 single_end=True))
    return idx, pre + "_1.fq"


def worker(tree, scale_idx=None, scale_fq=None):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = smoke_module()
    dev = torch.device("cuda")
    out = {"tree": tree}
    cases = cs.kernel_cases(dev)
    os.makedirs(cs.WORK, exist_ok=True)
    threads = min(8, os.cpu_count() or 1)
    index, _ = cs.trex1_index(threads)

    def has(name):
        return os.path.exists(os.path.join(tree, cs.SOURCES[name]))

    if has("seed_extend"):
        from abismal_tpu_torch.host import read_index
        from abismal_tpu_torch.kernels import seed_extend as se

        fq = cs.gunzip_to("reads_1.fq", cs.WORK)
        pools = dict(zip(("seed_extend_trex1",),
                         cs.ext_pool(dev, index, fq, threads)))
        if scale_idx:
            pools.update(zip(
                ("seed_extend", "seed_extend_1gb_512"),
                cs.ext_pool(dev, read_index(scale_idx), scale_fq, threads,
                            (None, cs.EXT_POOL_STATIC))))
        cases += [dict(name=n, plain=se.seed_extend_plain,
                       kernel=se.seed_extend, args=a)
                  for n, a in pools.items()]
    else:
        out["seed_extend"] = "lacking: this tree has no K4"
    if has("segment_rank") and has("candidate_list"):
        for (n5, n6), fqs in (
                (("segment_rank", "candidate_list_trex1"),
                 cs.golden_fastqs("reads")),
                (("segment_rank_pe", "candidate_list_pe"),
                 cs.golden_fastqs("reads_pe"))):
            a5, a6 = cs.scan_args(dev, index, threads, *fqs)
            cases += [cs.k5_case(n5, a5), cs.k6_case(n6, a6)]
    else:
        out["segment_rank"] = "lacking: this tree has no K5 and K6"
    for case in cases:
        plain, kernel, args = case["plain"], case["kernel"], case["args"]
        want, got = plain(*args), kernel(*args)
        torch.cuda.synchronize()
        loop = (cs.cuda_ms(lambda: kernel(*args), 50)
                + cs.cuda_ms(lambda: kernel(*args), 50)) / 2
        out[case["name"]] = dict(
            ms=cs.graph_ms(lambda: kernel(*args)), host_loop_ms=loop,
            equals_plain=cs.outputs_equal(got, want) == 0)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--scale-set", nargs=2, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help="also write the lines here")
    a = ap.parse_args()
    if a.worker:
        worker(a.worker, *(a.scale_set or ()))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    lines = [json.dumps({"card": card})]
    print(lines[0], flush=True)
    cs = smoke_module()
    extra = ["--scale-set", *scale_set(cs, cs.SCALE_MB)]
    for tree in a.tree or [ROOT]:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             *extra], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return 1
        lines.append(res.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
