"""Cut bisection of the fused paired-end program (↔
tools/profile_stage12pe.py; the protocol of profile_stage12): builds
build_stage12pe cut at successive points (hash -> ranges -> extend ->
list -> pecompact -> pejobs -> pescore -> full) and times each on the
card with simulated pairs.

Usage: python -m abismal_tpu_torch.tools.profile_stage12pe [unit_batch]
           [reps] [cuts...] [--device cpu]
       ABISMAL_PROFILE_INDEX=/path/to.idx ABISMAL_PROFILE_GENOME=/path.fa
           python -m abismal_tpu_torch.tools.profile_stage12pe ...
A cut named "full" is the whole program.
"""

from __future__ import annotations

import argparse

from . import _workload as W
from .profile_stage12 import bisect, parse_cuts

CUTS = ("hash", "ranges", "extend", "list", "pecompact", "pejobs", "pescore",
        None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("unit_batch", nargs="?", type=int, default=2048)
    ap.add_argument("reps", nargs="?", type=int, default=10)
    ap.add_argument("cuts", nargs="*")
    W.add_common_args(ap)
    a = ap.parse_args(argv)
    index, genome = W.profile_index(a.threads)
    eng = W.engine(index, a.device, a.unit_batch, a.lmax)
    n_pairs = a.unit_batch // 4
    r1, r2 = (W.load_reads(p, n_pairs)
              for p in W.simulate(genome, n_pairs, paired=True))
    chunk = W.pe_chunk(eng, r1, r2)
    W.say(f"device={eng.device} pairs={len(r1)} unit_batch={a.unit_batch} "
          f"per={chunk.per} budget={chunk.budget} ext_pool={chunk.ext_pool}")
    return bisect(eng, chunk, parse_cuts(a.cuts, CUTS), a.reps, paired=True)


if __name__ == "__main__":
    main()
