"""The paired-end configuration at lmax 160 in small: 2x150 bp pairs of
the tiny genome, mapped end to end on the CPU by the PE program at lmax
160 and judged correct, with no unit handed back for length; the same
cell's reads of another protocol judged not correct; roofline/k1.py
equal to chip_smoke.py's k1_bound; the new reader silent, never
raising, where its data is missing."""

from __future__ import annotations

import importlib.util
import os

import pytest

from abismal_bench.harness import spec
from abismal_bench.run import Run
from abismal_bench.tests import _tiny
from abismal_bench.tests.conftest import ROOT

L160 = {"lmax": 160}
NEW = ("k1_roofline",)


def test_pe_l160_cell_runs_correct(tiny, run_tiny):
    root, _ = tiny
    cell = _tiny.add_cell(root, "pe_l160.len150", "pe_l160", True, L160,
                          read_length=150, frag_min=150, frag_max=400,
                          pool_reads=200)
    out = run_tiny(cell, 2**31 + 19, trace=True)
    assert out["check"]["record_faults"]["value"] == 0, out["stderr"]
    assert out["correct"], out["stderr"]
    m = out["metrics"]
    assert m["finish_ms"]["value"] > 0
    # a 150-base mate fits: no pair goes to the host for its length
    assert m["device_fallback_frac"]["value"] < 0.2
    # device numbers come from the card alone
    assert not {"replay_ms", "k1_roofline"} & set(m)


def test_pe_l160_other_protocol_is_not_correct(tiny, run_tiny):
    root, _ = tiny
    cell = _tiny.add_cell(root, "pe_l160.pbat150", "pe_l160", True, L160,
                          read_length=150, frag_min=150, frag_max=400,
                          pool_reads=200, protocol="pbat")
    assert not run_tiny(cell, 5)["correct"]


def _chip_smoke():
    path = os.path.join(ROOT, "chip_smoke.py")
    s = importlib.util.spec_from_file_location("chip_smoke_k1", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_k1_bound_is_chip_smokes(seed):
    import numpy as np
    import torch

    from abismal_bench.roofline.k1 import k1_bound

    rng = np.random.default_rng(seed)
    n_gw, G, B, nw = 4096, 3000, 64, 20
    genome32 = torch.from_numpy(rng.integers(
        -2**31, 2**31, n_gw, dtype=np.int64).astype(np.int32))
    pos = torch.from_numpy(rng.integers(0, 8 * n_gw + 512, G))
    pos[::5] &= ~7
    pk = torch.from_numpy(rng.integers(-2**31, 2**31, (B, nw),
                                       dtype=np.int64).astype(np.int32))
    b_of = torch.from_numpy(np.sort(rng.integers(0, B, G)))
    nw_of = torch.from_numpy(
        (2 * rng.integers(1, nw // 2 + 1, G)).astype(np.int32))
    args = (genome32, pos, pk, b_of, nw_of)
    assert k1_bound(*args) == _chip_smoke().k1_bound(*args)


@pytest.mark.parametrize("metric", NEW)
def test_new_readers_are_silent_without_data(metric):
    mod = spec.reader(metric)
    assert mod.read(Run()) is None
    assert mod.read(Run(counters={"n_units": 0, "n_fallback": 0})) is None
