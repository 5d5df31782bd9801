"""Fallback sweep of the fused single-end route (↔ tools/fallback_sweep.py):
the share of units the card hands back to the host, against the mutation
rate, the read length and a repeat-rich genome, each run's SAM checked
against the port's native engine (--engine native) by md5.  A fallback
unit is re-mapped exactly on the host, so the share is a rate, not a
correctness, metric: where it is high the host does the card's work.
Prints one JSON line a configuration and writes the list to --out (by
default build/abismal_tpu_torch/fallback_sweep.json of the checkout);
exits 1 if any SAM differs.

Usage: python -m abismal_tpu_torch.tools.fallback_sweep [n_reads]
           [--out F] [--rows 0,7] [--device cpu] [--threads N]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np

from . import _workload as W

DEFAULT_OUT = os.path.join(W.ROOT, "build", "abismal_tpu_torch",
                           "fallback_sweep.json")
# (genome, mutation rate, read length, lmax), the JAX tool's rows
CONFIGS = ([("tRex1", m, 100, 128) for m in (0.0, 0.01, 0.02, 0.03, 0.05)]
           + [("tRex1", 0.01, n, 256) for n in (150, 250)]
           + [("repeat30", m, 100, 128) for m in (0.01, 0.03)])


def repeat_genome(path: str, seed: int = 9):
    """The JAX tool's tRex1-sized genome with 30% repeats: a 137 kb tandem
    block of a 171 bp unit and 60 copies of a 2 kb segment at 3% of
    divergence among ~600 kb of random sequence (the same generator and
    seed, so the same bases)."""
    rng = np.random.default_rng(seed)
    parts = [rng.choice(list("ACGT"), size=200_000)]
    unit = "".join(rng.choice(list("ACGT"), size=171))
    parts.append(np.array(list(unit * 800)))
    seg = "".join(rng.choice(list("ACGT"), size=2000))
    for _ in range(60):
        s = np.array(list(seg))
        mut = rng.random(len(s)) < 0.03
        s[mut] = rng.choice(list("ACGT"), size=int(mut.sum()))
        parts.append(s)
        parts.append(rng.choice(list("ACGT"), size=30))
    parts.append(rng.choice(list("ACGT"), size=400_000))
    seq = "".join("".join(p) for p in parts)
    with open(path + ".tmp", "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i : i + 80] + "\n")
    os.replace(path + ".tmp", path)


def md5(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def run_one(index, eng, fq, threads):
    """(fallback share of the card engine's units, SAM equal to the native
    engine's) for one FASTQ."""
    from ..map.engine import run_map
    from ..map.host_units import make_native_engine_factory

    sam_n, sam_t = W.cache_path("fbsweep", "n.sam"), W.cache_path(
        "fbsweep", "t.sam")
    run_map(index, fq, None, sam_n, None, "map",
            engine_factory=make_native_engine_factory(n_threads=threads),
            threads=threads)

    def factory(*_args):
        return eng

    factory.is_native = True
    u0, f0 = eng.n_units, eng.n_fallback
    run_map(index, fq, None, sam_t, None, "map", engine_factory=factory,
            threads=threads)
    return ((eng.n_fallback - f0) / max(1, eng.n_units - u0),
            md5(sam_n) == md5(sam_t))


def run(n_reads: int, device, threads: int, rows=None, out=W.say):
    from ..index.build import create_index

    fa = {"tRex1": W.TREX1_FA, "repeat30": W.cache_path("repeat30.fa")}
    if not os.path.exists(fa["repeat30"]):
        repeat_genome(fa["repeat30"])
    indexes, engines, results = {}, {}, []
    for i, (gname, mut, flen, lmax) in enumerate(CONFIGS):
        if rows is not None and i not in rows:
            continue
        if gname not in indexes:
            indexes[gname] = create_index(fa[gname], n_threads=threads)
        if (gname, lmax) not in engines:
            engines[gname, lmax] = W.engine(indexes[gname], device,
                                            lmax=lmax, threads=threads)
        fq = W.simulate(fa[gname], n_reads, seed=3, mutation=mut,
                        read_length=flen)[0]
        fb, ok = run_one(indexes[gname], engines[gname, lmax], fq, threads)
        rec = {"genome": gname, "mutation": mut, "read_len": flen,
               "lmax": lmax, "reads": n_reads, "fallback_frac": fb,
               "md5_ok": ok}
        out(json.dumps(rec))
        results.append(rec)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=4000)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--rows", default="",
                    help="comma-separated rows of CONFIGS (default all)")
    W.add_common_args(ap, lmax=False)
    a = ap.parse_args(argv)
    rows = {int(r) for r in a.rows.split(",")} if a.rows else None
    results = run(a.n_reads, a.device, a.threads, rows)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    W.say(f"wrote {a.out}")
    if not all(r["md5_ok"] for r in results):
        raise SystemExit("fallback_sweep: a SAM differs from the native "
                         "engine's")
    return results


if __name__ == "__main__":
    main()
