"""Tuning of the fused stage-1+2 single-end path on the card (↔
tools/tune_stage2.py): per unit_batch, the best verified reads/s of five
maps of 10k simulated reads (seed 1; the SAM's md5 must equal the
golden's, or at another --reads the native engine's), the fallback
fraction and the spans of the engine's tracer (tracing.Tracer: total wall
seconds by path, of the last map).  ABISMAL_TPU_K_SLOTS and ABISMAL_TPU_JOBS_PER_READ take
effect through build_stage12, which reads them.

Usage: python -m abismal_tpu_torch.tools.tune_stage2 [unit_batch ...]
           [--reads N] [--device cpu] [--threads N]
"""

from __future__ import annotations

import argparse

from . import _workload as W

REPS = 5


def tune(index, fq, sam, truth, device, unit_batch: int, threads: int,
         reads: int) -> dict:
    """One unit_batch: a warm map, then REPS timed maps; the engine goes
    on return."""
    from ..map.pipeline import TorchNativeEngine

    eng = TorchNativeEngine(index, unit_batch=unit_batch, n_threads=threads,
                            device=device, device_stage2=True)

    eng.tracer.on = True
    try:
        warm, runs = W.timed_maps(index, fq, None, sam, W.engine_factory(eng),
                                  threads, REPS, before=eng.tracer.reset)
    finally:
        eng.tracer.on = False
        eng.close()
    rates = [reads / wall for wall, _, m in runs if m == truth]
    return dict(unit_batch=unit_batch, best=max(rates, default=0.0),
                verified=len(rates), reps=REPS, warm_s=warm,
                fallback=eng.n_fallback / max(1, eng.n_units),
                stages={p: round(t, 3) for p, (_, t, _s)
                        in eng.tracer.summary()["spans"].items()})


def run(batches, device="cuda", threads: int = 1, reads: int = 10000,
        out=W.say) -> list[dict]:
    """One row per unit_batch: best reads/s, verified repetitions, warm
    seconds, fallback fraction and the tracer's spans."""
    from ..index.serialize import read_index

    index = read_index(W.trex1_index_file(threads))
    fq = W.simulate(W.TREX1_FA, reads, seed=1)[0]
    sam = W.cache_path("tune_stage2", "out.sam")
    truth = W.truth_md5(index, fq, None, sam, threads, reads == 10000)
    rows = []
    for ub in batches:
        r = tune(index, fq, sam, truth, device, ub, threads, reads)
        rows.append(r)
        out(f"unit_batch={ub}: best={r['best']:,.0f} reads/s  "
            f"warm={r['warm_s']:.1f}s fallback={r['fallback']:.3f}  "
            f"stages={r['stages']}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", type=int, nargs="*",
                    default=[2048, 8192, 16384])
    ap.add_argument("--reads", type=int, default=10000)
    W.add_common_args(ap, lmax=False)
    a = ap.parse_args(argv)
    return run(a.batches, a.device, a.threads, a.reads)


if __name__ == "__main__":
    main()
