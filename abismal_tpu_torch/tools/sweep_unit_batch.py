"""unit_batch sweep of the torch engine (↔ tools/sweep_unit_batch.py):
maps the 10k-read golden set (tests/golden/reads_1.fq.gz, which the
simulator's seed-1 reads equal byte for byte) once per size, after a
warm run, and prints reads/s and whether the SAM has the first size's md5
(every size writes the same header).

Usage: python -m abismal_tpu_torch.tools.sweep_unit_batch [unit_batch ...]
           [--reads N] [--device cpu] [--threads N]
"""

from __future__ import annotations

import argparse

from . import _workload as W


def run(sizes, device="cuda", threads: int = 1, reads: int = 10000,
        out=W.say) -> list[dict]:
    """One row per unit_batch: reads/s of the timed map, the SAM's md5
    and whether it equals the first size's."""
    from ..index.serialize import read_index

    index = read_index(W.trex1_index_file(threads))
    fq = W.simulate(W.TREX1_FA, reads, seed=1)[0]
    sam = W.cache_path("sweep", "out.sam")
    rows, ref = [], None
    for ub in sizes:
        eng = W.engine(index, device, unit_batch=ub, threads=threads)
        try:
            _, [(wall, _, m)] = W.timed_maps(
                index, fq, None, sam, W.engine_factory(eng), threads, 1)
        finally:
            eng.close()
        ref = ref or m
        rows.append(dict(unit_batch=ub, reads_per_s=reads / wall, md5=m,
                         md5_ok=m == ref))
        out(f"unit_batch={ub:6d}  {reads / wall:9.1f} reads/s  "
            f"md5={'OK' if m == ref else 'MISMATCH ' + m}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sizes", type=int, nargs="*",
                    default=[2048, 8192, 16384])
    ap.add_argument("--reads", type=int, default=10000)
    W.add_common_args(ap, lmax=False)
    a = ap.parse_args(argv)
    return run(a.sizes, a.device, a.threads, a.reads)


if __name__ == "__main__":
    main()
