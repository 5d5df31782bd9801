"""Check of the pooled seed extension against the host oracle (↔
tools/debug_ext.py): the core's "extdbg" cut gives every specific-phase
cell's extended range (l, lo, hi) on the device, and each cell whose
bucket holds more than max_candidates positions is held against the
exact engine's binary search (map/seeds.py _find_candidates_two and
_find_candidates_three), for T-rich and A-rich units.

The genome is made to give oversized buckets: tandem repeats of 10-mers
put a region's kept positions on one hash key, so N copies give a bucket
of ~N/2.  240 copies keep the count in (max_candidates, CELLCAP] to the
read's end; 6000 overflow a cell; 600 short repeat segments with unique
tails narrow below max_candidates mid-read; reads with a mutation deep
in a 240-copy block empty the range in one step (the rollback case).

Usage: python -m abismal_tpu_torch.tools.debug_ext [--device cpu]
Prints the mismatched cells (at most 20) and their count; exits 1 if
any cell differs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import _workload as W

ACGT = list("ACGT")


def _unit(rng):
    """A 10-mer whose two-letter classes are not a shorter repeat."""
    while True:
        u = "".join(rng.choice(ACGT, size=10))
        bits = ["01"[c in "CT"] for c in u]
        if bits[:5] != bits[5:]:
            return u


def _mutate(s, pos):
    return s[:pos] + {"A": "C", "C": "A", "G": "C", "T": "G"}[s[pos]] \
        + s[pos + 1:]


def ext_genome(path: str, seed: int = 42):
    """Writes the repeat genome to path; returns the reads to check."""
    rng = np.random.default_rng(seed)
    u1, u2, u3, u4 = (_unit(rng) for _ in range(4))
    seq, marks, segs = [], {}, []

    def add(s):
        seq.append(s)

    def at():
        return sum(len(s) for s in seq)

    def rand(n):
        return "".join(rng.choice(ACGT, size=n))

    add(rand(30_000))
    marks["b1"] = at()
    add(u1 * 240 + rand(10_000))
    marks["b2"] = at()
    add(u2 * 6000 + rand(10_000))
    for _ in range(600):
        segs.append(at())
        add(u3 * 6 + rand(60))
    add(rand(10_000))
    marks["b4"] = at()
    add(u4 * 240 + rand(30_000))
    g = "".join(seq)
    with open(path + ".tmp", "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(g), 80):
            f.write(g[i : i + 80] + "\n")
    os.replace(path + ".tmp", path)

    reads = [g[marks["b1"] + 200 + j :][:100] for j in range(0, 20, 3)]
    reads += [g[marks["b2"] + 300 + j :][:100] for j in range(0, 10, 3)]
    for si in (5, 150, 350, 550):
        reads += [g[segs[si] : segs[si] + 100],
                  _mutate(g[segs[si] : segs[si] + 100], 90)]
    base4 = g[marks["b4"] + 400 :][:100]
    reads += [base4] + [_mutate(base4, d) for d in (76, 80, 85, 90, 99, 30,
                                                    45)]
    for _ in range(4):
        p = int(rng.integers(1000, 28_000))
        reads.append(g[p : p + 100])
    return [r.encode() for r in reads]


def check(index, reads, device, a_rich: bool, lmax: int = 128, out=W.say):
    """(mismatched cells, checked cells) of one conversion."""
    from ..constants import WINDOW_SIZE
    from ..device import put, resolve_device
    from ..map.host_units import get_conv_is_ga, prepare_units, strand_code
    from ..map.pipeline import DeviceIndex, _make_core
    from ..map.seeds import (
        SeedIndexView, _find_candidates_three, _find_candidates_two,
        prep_read,
    )

    dev_t = resolve_device(device)
    dev = DeviceIndex.from_index(index, dev_t)
    view = SeedIndexView(index)
    units = [prep_read(r, a_rich) for r in reads]
    pnib, lens = prepare_units(units, lmax)
    ga = get_conv_is_ga(strand_code("+", a_rich))
    B = len(units)
    core, o_spec = _make_core(lmax, dev.max_candidates, dev.n_index2,
                              dev.n_index3, 64, ext_iters=dev.ext_iters,
                              cut="extdbg")
    got = core(*dev.tables(), *(put(a, dev_t) for a in (
        pnib, lens, np.full(B, ga), np.zeros((B, 1), np.int32))))
    c = {k: v.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
         for k, v in got.items()}
    max_c = index.max_candidates
    bad = checked = 0
    for i, u in enumerate(units):
        n = u.shape[0]
        for off in range(min(max(WINDOW_SIZE, n >> 1), o_spec)):
            for t in ("2", "3"):
                s, e = int(c["s" + t][i, off]), int(c["e" + t][i, off])
                if e - s <= max_c:
                    continue
                checked += 1
                if t == "2":
                    want = _find_candidates_two(view, u, off, n - off, s, e)
                else:
                    want = _find_candidates_three(view, u, off, n - off, s,
                                                  e, ga)
                dev_res = tuple(int(c[k][i, off])
                                for k in (f"l{t}", f"s{t}x", f"e{t}x"))
                if tuple(int(x) for x in want) != dev_res:
                    if bad < 20:
                        out(f"{t}L unit={i} off={off} host(p,lo,hi)={want} "
                            f"dev={dev_res} init=({s},{e})")
                    bad += 1
    out(f"a_rich={int(a_rich)}: ext_fb units "
        f"{int(c['ext_fb'].astype(bool).sum())}/{B}, cells checked "
        f"{checked}, mismatched {bad}")
    return bad, checked


def main(argv=None):
    from ..index.build import create_index

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    W.add_common_args(ap)
    a = ap.parse_args(argv)
    fa = W.cache_path("ext_genome.fa")
    reads = ext_genome(fa)
    index = create_index(fa, n_threads=a.threads)
    res = [check(index, reads, a.device, ar, a.lmax) for ar in (False, True)]
    bad = sum(b for b, _ in res)
    W.say(f"nbad: {bad}")
    if bad:
        raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
