#!/usr/bin/env python3
"""Times the port's CUDA kernels K1-K3 of one or more checkouts on the
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
tree must have the entry points that script names."""

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


def worker(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = smoke_module()
    out = {"tree": tree}
    for case in cs.kernel_cases(torch.device("cuda")):
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
    ap.add_argument("--out", default=None, help="also write the lines here")
    a = ap.parse_args()
    if a.worker:
        worker(a.worker)
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
    for tree in a.tree or [ROOT]:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree],
            capture_output=True, text=True)
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
