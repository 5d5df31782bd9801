"""Mapping on the card at GB scale (↔ tools/scale_device.py): the index
tables of the synthetic 1 Gb genome of tools/scale_test.py (the hg38-size
stand-in) uploaded to the card, the per-unit candidate distribution of
simulated reads (the core's "unitstats" cut), the informed candidate
budget, the fused stage-1+2 time a chunk, and the engine rates, single-end
and paired-end, of the card, the native engine and the hybrid split of
the two (in this process, its share from the two rates).  Writes one
JSON object to --out (by default build/abismal_tpu_torch/scale_device.json
of the checkout).

The index is built with the port's create_index (or read from --index);
nothing of the upstream binary is needed.  --size-mb makes a smaller
genome of the same generator.

Usage: python -m abismal_tpu_torch.tools.scale_device [--size-mb 1000]
           [--index PATH --genome PATH] [--reads 100000]
           [--unit-batch 2048] [--lmax 100] [--out F] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import _workload as W

DEFAULT_OUT = os.path.join(W.ROOT, "build", "abismal_tpu_torch",
                           "scale_device.json")


def unit_stats(eng, chunk, cand_per_unit=None) -> dict:
    """The "unitstats" cut on chunk at cand_per_unit (None: the index's
    automatic budget): the distribution of candidates a unit and the
    fraction of units over a cell or the budget."""
    from ..map.pipeline import build_stage12

    dev = eng.dev
    prog, _ = build_stage12(eng.lmax, dev.max_candidates, dev.n_index2,
                            dev.n_index3, chunk.per,
                            cand_per_unit=cand_per_unit,
                            ext_iters=dev.ext_iters, ext_pool=chunk.ext_pool,
                            cut="unitstats")
    st = prog(*dev.tables(), *chunk.on(eng)).cpu().numpy()
    ut, ovf = st[0][: chunk.n_units], st[1][: chunk.n_units]
    return {"mean": float(ut.mean()),
            "p50": int(np.percentile(ut, 50)),
            "p90": int(np.percentile(ut, 90)),
            "p99": int(np.percentile(ut, 99)),
            "max": int(ut.max()),
            "cell_or_budget_overflow_frac": float(ovf.mean())}


def _rate(n, fn):
    t0 = time.perf_counter()
    fn()
    return n / (time.perf_counter() - t0)


def engine_rates(index, eng, fq1, fq2, n, threads, tag, res, out=W.say):
    """Warm rates of the card engine and the native engine on fq1 (and fq2,
    paired), then of the hybrid split between them, into res under the
    JAX tool's keys (tag "" single-end, "_pe" paired-end)."""
    from ..map.engine import run_map
    from ..map.hybrid_split import run_map_hybrid_split
    from ..map.native_engine import NativeMappingEngine

    sam = W.cache_path("scale", "out.sam")
    nat = NativeMappingEngine(index, n_threads=threads)
    unit = "pairs" if fq2 else "reads"
    for name, engine in (("tpu", eng), ("native", nat)):
        fac = W.engine_factory(engine)

        def once():
            run_map(index, fq1, fq2, sam, None, "map scale",
                    engine_factory=fac, threads=threads)

        once()  # warm: the engine's programs and kernels
        f0, u0 = eng.n_fallback, eng.n_units
        res[f"engine_{name}{tag}_{unit}_per_s"] = _rate(n, once)
        if name == "tpu":
            res[f"engine{tag}_fallback_frac"] = (
                (eng.n_fallback - f0) / max(1, eng.n_units - u0))
    dev_rate = res[f"engine_tpu{tag}_{unit}_per_s"]
    share = dev_rate / (dev_rate + res[f"engine_native{tag}_{unit}_per_s"])

    def split():
        run_map_hybrid_split(index, fq1, fq2, sam, "map scale",
                             device_share=share, threads=threads,
                             native_engine=nat, tpu_engine=eng,
                             total_reads=n, lmax=eng.lmax)

    rates = [_rate(n, split) for _ in range(3)]  # the first one warms
    res[f"engine_split{tag}_{unit}_per_s"] = max(rates[1:])
    res[f"split{tag}_device_share"] = share
    out(f"{unit}/s: card {dev_rate:.1f} (fallback "
        f"{res[f'engine{tag}_fallback_frac']:.5f}), native "
        f"{res[f'engine_native{tag}_{unit}_per_s']:.1f}, split "
        f"{res[f'engine_split{tag}_{unit}_per_s']:.1f} at share "
        f"{share:.3f}")


def run(a, out=W.say) -> dict:
    import torch

    from ..device import card_info, resolve_device
    from ..index.build import create_index
    from ..index.serialize import read_index
    from ..map.pipeline import DeviceIndex

    device = resolve_device(a.device)
    fa = a.genome or W.scale_genome(a.size_mb)
    res = {"config": {"genome": os.path.relpath(fa, W.ROOT)
                      if fa.startswith(W.ROOT) else fa,
                      "size_mb": a.size_mb, "unit_batch": a.unit_batch,
                      "lmax": a.lmax, "reads": a.reads,
                      "device": str(device), "threads": a.threads}}
    if device.type == "cuda":
        res["config"]["card"] = card_info()
    t0 = time.perf_counter()
    index = (read_index(a.index) if a.index
             else create_index(fa, n_threads=a.threads))
    res["index_s"] = time.perf_counter() - t0
    out(f"index in {res['index_s']:.1f}s")

    t0 = time.perf_counter()
    dev = DeviceIndex.from_index(index, device)
    W.sync(device)
    res["table_upload_s"] = time.perf_counter() - t0
    res["table_bytes"] = dev.nbytes()
    res["upload_MBps"] = dev.nbytes() / 1e6 / max(res["table_upload_s"],
                                                  1e-9)
    del dev
    out(f"tables {res['table_bytes'] / 1e9:.3f} GB uploaded in "
        f"{res['table_upload_s']:.2f}s ({res['upload_MBps']:.0f} MB/s)")

    eng = W.engine(index, device, a.unit_batch, a.lmax, a.threads)
    fq = W.simulate(fa, a.reads, seed=7)[0]
    chunk = W.se_chunk(eng, W.load_reads(fq, a.unit_batch // 2))
    res["candidates_per_unit"] = unit_stats(eng, chunk)
    mean = res["candidates_per_unit"]["mean"]
    # the JAX tool's informed budget, 1.1x the measured mean, beside the
    # engine's own estimate (estimate_cand_budget), which its runs use
    res["informed_cand_budget_per_unit"] = max(64, (int(1.10 * mean) + 15)
                                               & ~15)
    res["engine_cand_budget_per_unit"] = chunk.budget
    res["informed_ext_pool"] = chunk.ext_pool
    res["informed_budget_overflow_frac"] = unit_stats(
        eng, chunk, chunk.budget)["cell_or_budget_overflow_frac"]
    out(f"candidates/unit: {res['candidates_per_unit']}")

    prog = W.stage12_prog(eng, chunk)
    args, tables = chunk.on(eng), eng.dev.tables()
    ms = W.timed_ms(lambda: prog(*tables, *args), 10, device)
    B = chunk.args[0].shape[0]
    res["stage12_ms_per_chunk"] = ms
    res["stage12_us_per_unit"] = ms * 1e3 / B
    res["stage12_device_reads_per_s"] = B // chunk.per / ms * 1e3
    out(f"stage12: {ms:.3f} ms/chunk ({res['stage12_device_reads_per_s']:.0f}"
        f" reads/s on the card alone)")

    engine_rates(index, eng, fq, None, a.reads, a.threads, "", res, out)
    n_pairs = a.reads // 2
    pfq = W.simulate(fa, n_pairs, paired=True, seed=11)
    engine_rates(index, eng, pfq[0], pfq[1], n_pairs, a.threads, "_pe", res,
                 out)
    if device.type == "cuda":
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    out(f"wrote {a.out}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size-mb", type=int, default=1000)
    ap.add_argument("--index", default="")
    ap.add_argument("--genome", default="")
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--unit-batch", type=int, default=2048)
    ap.add_argument("--out", default=DEFAULT_OUT)
    W.add_common_args(ap, lmax=False)
    ap.add_argument("--lmax", type=int, default=100,
                    help="padded read length, fitted to the 100 bp reads "
                         "(as in the JAX tool)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
