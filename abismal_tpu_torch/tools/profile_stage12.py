"""Cut bisection of the fused single-end program (↔ tools/profile_stage12.py).

Builds build_stage12 cut at successive points (hash -> ranges -> extend ->
list -> core -> compact -> decide -> jobs -> score -> full) and times each
on the card with simulated reads: after one warm execution, `reps`
executions back to back between two CUDA events (the device's span of
the chunk, the host's launch gaps included wherever the device waits on
them), in three passes over the cuts, a cut's time the median of its
passes.  The deltas between cuts split a chunk's time among the stages.
Each program uses the engine's informed candidate budget and extension
pool, as the engine's own runs do.

Usage: python -m abismal_tpu_torch.tools.profile_stage12 [unit_batch]
           [reps] [cuts...] [--device cpu]
       ABISMAL_PROFILE_INDEX=/path/to.idx ABISMAL_PROFILE_GENOME=/path.fa
           python -m abismal_tpu_torch.tools.profile_stage12 ...  # GB scale
A cut named "full" is the whole program.
"""

from __future__ import annotations

import argparse

import numpy as np

from . import _workload as W

CUTS = ("hash", "ranges", "extend", "list", "core", "compact", "decide",
        "jobs", "score", None)
ROUNDS = 3


def bisect(eng, chunk, cuts, reps: int, paired: bool = False,
           out=W.say) -> list[dict]:
    """Times each cut's program on chunk, in ROUNDS passes over the cuts
    (the host's speed drifts between passes, so a cut's time is the median
    of its passes); returns one row per cut (name, ms a chunk, the passes'
    ms, delta from the previous cut, µs a unit)."""
    args = chunk.on(eng)
    tables = eng.dev.tables()
    B = chunk.args[0].shape[0]
    progs = [W.stage12_prog(eng, chunk, cut, paired) for cut in cuts]
    passes = [[] for _ in cuts]
    for _ in range(ROUNDS):
        for times, prog in zip(passes, progs):
            times.append(W.timed_ms(lambda p=prog: p(*tables, *args), reps,
                                    eng.device))
    rows, prev = [], 0.0
    for cut, times in zip(cuts, passes):
        ms = float(np.median(times))
        row = dict(cut=cut or "full", ms=ms, passes_ms=times,
                   delta_ms=ms - prev, us_per_unit=ms * 1e3 / B)
        out(f"{row['cut']:10s} ms/chunk={ms:9.3f}  delta={ms - prev:9.3f} ms"
            f"  ({row['us_per_unit']:7.3f} us/unit)  passes "
            + " ".join(f"{t:.3f}" for t in times))
        rows.append(row)
        prev = ms
    return rows


def parse_cuts(names, default):
    if not names:
        return default
    return tuple(None if c == "full" else c for c in names)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("unit_batch", nargs="?", type=int, default=2048)
    ap.add_argument("reps", nargs="?", type=int, default=20)
    ap.add_argument("cuts", nargs="*")
    W.add_common_args(ap)
    a = ap.parse_args(argv)
    index, genome = W.profile_index(a.threads)
    eng = W.engine(index, a.device, a.unit_batch, a.lmax)
    reads = W.load_reads(W.simulate(genome, a.unit_batch // 2)[0],
                         a.unit_batch // 2)
    chunk = W.se_chunk(eng, reads)
    W.say(f"device={eng.device} reads={len(reads)} "
          f"unit_batch={a.unit_batch} per={chunk.per} "
          f"budget={chunk.budget} ext_pool={chunk.ext_pool}")
    return bisect(eng, chunk, parse_cuts(a.cuts, CUTS), a.reps)


if __name__ == "__main__":
    main()
