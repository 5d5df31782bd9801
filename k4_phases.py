#!/usr/bin/env python3
"""Where K4 (seed_extend) spends its time on the card: the kernel's source
(abismal_tpu_torch/csrc/seed_extend.cu) is built a second time with a
globaltimer stamp at the end of each phase of a lane warp (slot search,
setup, k-ary search, LCP window, stop depth and cell) and of a fill warp,
and run once on each pool that chip_smoke.py's kernels_ext phase records:
the first chunk of the 10k golden reads, of the scale-phase SE reads at
the engine's pool size and at 512 slots, and the full 512-slot pool of
the repeat genome.  Per pool it prints the kernel's time from a CUDA
graph of 20 launches (the stamped build beside the plain one) and, for
the longest live lane, each phase's microseconds, with the phase medians
over the live lanes and the time the last fill warp ended.

    python3 k4_phases.py [--out FILE]

It needs a card and nvcc, and takes ~3 minutes with the 1 Gb genome."""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
LANE_PHASES = ("slot_search", "setup", "search", "window", "stop_and_cell")
ROWS = 512 + 8192  # stamp rows: the pool's slots, then the units

STAMP = r"""
__device__ unsigned long long k4_stamps[%d * 8];
__device__ __forceinline__ void stamp(long long row, int k) {
  if ((threadIdx.x & 31) == 0) {
    unsigned long long g;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g));
    k4_stamps[row * 8 + k] = g;
  }
}
extern "C" int k4_stamps_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k4_stamps, sizeof(k4_stamps));
}
extern "C" int k4_stamps_clear() {
  static unsigned long long z[%d * 8];
  return (int)cudaMemcpyToSymbol(k4_stamps, z, sizeof(z));
}
""" % (ROWS, ROWS)

# (pattern, stamp): a stamp after the first match of each pattern
MARKS = (
    (r"  const int n_cells = [^;]*;\n", "  stamp(slot, 0);\n"),
    (r"  if \(want > total\) return;\n  const int64_t c = hi;\n",
     "  stamp(slot, 1);\n"),
    (r"  L\.D = [^;]*;\n", "  stamp(slot, 2);\n"),
    (r"  kary_search<NW>\([^;]*\);\n", "  stamp(slot, 3);\n"),
    (r"  window[_a-z]*<NW, PB>\([^;]*\);\n  __syncwarp\(\);\n",
     "  stamp(slot, 4);\n"),
    (r"    cell\[2 \* n_lanes\] = fullr \? hi0 : Ub \+ \(n >> 16\);\n  \}\n",
     "  stamp(slot, 5);\n"),
    (r"  bool flag = false;\n", "  stamp(512 + u, 0);\n"),
    (r"  if \(t == 0\) A\.ext_fb\[u\] = fb;\n", "  stamp(512 + u, 1);\n"),
)


def stamped(source: str) -> str:
    """source with the stamp helpers and a stamp after each mark."""
    out = source.replace("#include <cuda_runtime.h>\n",
                         "#include <cuda_runtime.h>\n" + STAMP, 1)
    for pat, mark in MARKS:
        m = re.search(pat, out)
        if not m:
            raise SystemExit(f"k4_phases: no {pat!r} in seed_extend.cu")
        out = out[: m.end()] + mark + out[m.end() :]
    return out


def build_stamped(work):
    from abismal_tpu_torch.kernels import _build

    os.makedirs(work, exist_ok=True)
    cu = os.path.join(work, "seed_extend_stamped.cu")
    so = os.path.join(work, "libseed_extend_stamped.so")
    with open(_build.source_path("seed_extend")) as f:
        text = stamped(f.read())
    with open(cu, "w") as f:
        f.write(text)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    fn = lib.seed_extend_launch
    fn.argtypes = _build.SIGNATURES["seed_extend"]["seed_extend_launch"]
    fn.restype = ctypes.c_int
    return types.SimpleNamespace(seed_extend_launch=fn), lib


def phases(lib, se, args):
    """One stamped launch on args: the longest live lane's phases and the
    medians over live lanes (us), and when the last fill warp ended."""
    import torch

    lib.k4_stamps_clear()
    se.seed_extend(*args)
    torch.cuda.synchronize()
    st = torch.zeros(ROWS * 8, dtype=torch.int64)
    if lib.k4_stamps_read(ctypes.c_void_p(st.data_ptr())):
        raise RuntimeError("k4_phases: reading the stamps failed")
    st = st.view(ROWS, 8)
    lanes, fills = st[:512], st[512 : 512 + args[6].shape[0]]
    live = lanes[lanes[:, 5] > 0]
    t0 = int(torch.cat([lanes[lanes[:, 0] > 0, 0], fills[:, 0]]).min())
    out = dict(fill_end_us=float(fills[:, 1].max() - t0) / 1e3)
    if live.shape[0]:
        ph = (live[:, 1:6] - live[:, 0:5]).double() / 1e3
        j = int((live[:, 5] - live[:, 0]).argmax())
        out.update(
            live_lanes=int(live.shape[0]),
            lane_end_us=float(live[:, 5].max() - t0) / 1e3,
            longest_lane_us=dict(zip(LANE_PHASES, ph[j].tolist())),
            median_us=dict(zip(LANE_PHASES,
                               ph.median(dim=0).values.tolist())))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k4_phases: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import kernel_times as kt
    from abismal_tpu_torch.host import read_index
    from abismal_tpu_torch.kernels import _build
    from abismal_tpu_torch.kernels import seed_extend as se

    dev = torch.device("cuda")
    threads = min(8, os.cpu_count() or 1)
    os.makedirs(cs.WORK, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    trex, _ = cs.trex1_index(threads)
    pools = dict(zip(("seed_extend_trex1",), cs.ext_pool(
        dev, trex, cs.gunzip_to("reads_1.fq", cs.WORK), threads)))
    idx, fq = kt.scale_set(cs, cs.SCALE_MB)
    pools.update(zip(("seed_extend", "seed_extend_1gb_512"), cs.ext_pool(
        dev, read_index(idx), fq, threads, (None, cs.EXT_POOL_STATIC))))
    pools["seed_extend_full_pool"] = cs.full_pool_args(dev, threads)
    ns, lib = build_stamped(os.path.join(cs.WORK, "k4_phases"))
    lines = [{"card": card}]
    load = _build.load
    for name, args in pools.items():
        want = se.seed_extend_plain(*args)
        res = dict(pool=name, ms=cs.graph_ms(lambda: se.seed_extend(*args)))
        _build.load = lambda: ns
        try:
            got = se.seed_extend(*args)
            torch.cuda.synchronize()
            cs.check(cs.outputs_equal(got, want) == 0,
                     f"{name}: the stamped kernel differs from the plain")
            res["stamped_ms"] = cs.graph_ms(lambda: se.seed_extend(*args))
            res.update(phases(lib, se, args))
        finally:
            _build.load = load
        lines.append(res)
    for ln in lines:
        print(json.dumps(ln), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write("".join(json.dumps(ln) + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
