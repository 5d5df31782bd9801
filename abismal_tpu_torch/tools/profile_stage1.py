"""Timing of the event-stream program build_stage1 (↔
tools/profile_stage1.py): the steady time of one batch of single-end
units and its rate, for the program as the engine runs it and for its
ABISMAL_TPU_NOEXT variant (no seed extension: profiling only, it changes
the output), which localizes the extension's share; then the host<->card
copies of one batch alone.  Timed as profile_stage12 times a chunk.

Usage: python -m abismal_tpu_torch.tools.profile_stage1 [--units 1024]
           [--reps 20] [--trace DIR] [--device cpu]
--trace writes a torch.profiler trace (Chrome JSON) of three executions
of each variant into DIR.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import _workload as W


def stage1_args(genome, units: int, lmax: int):
    """(pnib, lens, is_ga, thr): `units` simulated reads as T-rich units,
    the threshold 0.4 len each."""
    from ..map.host_units import prepare_units
    from ..map.seeds import prep_read

    reads = W.load_reads(W.simulate(genome, units)[0], units)
    pnib, lens = prepare_units([prep_read(s, False) for _, s in reads], lmax)
    thr = ((2 * lens.astype(np.int64)) // 5).astype(np.int32)
    return pnib, lens, np.zeros(len(reads), bool), thr


def _build(dev, lmax: int, noext: bool):
    """build_stage1 for dev's tables, with ABISMAL_TPU_NOEXT set or unset
    while the core is built (it reads the variable then); the caller's
    setting is restored."""
    from ..map.pipeline import build_stage1

    saved = os.environ.pop("ABISMAL_TPU_NOEXT", None)
    if noext:
        os.environ["ABISMAL_TPU_NOEXT"] = "1"
    try:
        return build_stage1(lmax, dev.max_candidates, dev.n_index2,
                            dev.n_index3, ext_iters=dev.ext_iters)[0]
    finally:
        os.environ.pop("ABISMAL_TPU_NOEXT", None)
        if saved is not None:
            os.environ["ABISMAL_TPU_NOEXT"] = saved


def run(index, genome, device, units: int = 1024, reps: int = 20,
        lmax: int = 128, trace: str = "", out=W.say) -> dict:
    from ..device import put, resolve_device
    from ..map.pipeline import DeviceIndex

    dev_t = resolve_device(device)
    dev = DeviceIndex.from_index(index, dev_t)
    host = stage1_args(genome, units, lmax)
    args = tuple(put(a, dev_t) for a in host)
    res = {}
    for variant in ("ext", "noext"):
        stage1 = _build(dev, lmax, noext=variant == "noext")
        ms = W.timed_ms(lambda: stage1(*dev.tables(), *args), reps, dev_t)
        res[variant] = dict(ms=ms, units_per_s=units / ms * 1e3,
                            se_reads_per_s=units / ms * 1e3 / 2)
        out(f"units={units} noext={int(variant == 'noext')}: {ms:.3f} "
            f"ms/batch = {units / ms * 1e3:.0f} units/s = "
            f"{units / ms * 1e3 / 2:.0f} SE reads/s")
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev_t.type == "cuda" else [])
            with profile(activities=acts) as prof:
                for _ in range(3):
                    stage1(*dev.tables(), *args)
                W.sync(dev_t)
            os.makedirs(trace, exist_ok=True)
            path = os.path.join(trace, f"stage1_{variant}.json")
            prof.export_chrome_trace(path)
            out(f"trace written to {path}")
    ev, _ = stage1(*dev.tables(), *args)

    def roundtrip():
        put(host[0], dev_t)
        ev.cpu()

    ms = W.timed_ms(roundtrip, reps, dev_t)
    res["transfer_ms"] = ms
    out(f"transfer roundtrip (units up + events down): {ms:.3f} ms")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--units", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace", default="")
    W.add_common_args(ap)
    a = ap.parse_args(argv)
    index, genome = W.profile_index(a.threads)
    return run(index, genome, a.device, a.units, a.reps, a.lmax, a.trace)


if __name__ == "__main__":
    main()
