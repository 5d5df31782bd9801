"""A configuration runs as its settings say, and as nothing else: each of
the `map` options that the harness passes (protocols, BAM, the hybrid
engine, a mesh) in a tiny cell of its own, added as files and entries
alone, judged correct on the CPU; a key the harness does not know, or a
combination `map` refuses, stops the run; reads of one protocol mapped as
another are judged not correct."""

from __future__ import annotations

import pytest

from abismal_bench.harness.system import command_line, resolve
from abismal_bench.tests import _tiny

CASES = {
    "se_pbat.len100": (False, {"pbat": True}, "pbat"),
    "pe_pbat.len100": (True, {"pbat": True}, "pbat"),
    "se_rpbat.len100": (False, {"random_pbat": True}, "random_pbat"),
    "pe_rpbat.len100": (True, {"random_pbat": True}, "random_pbat"),
    "se_bam.len100": (False, {"bam": True}, "directional"),
    "pe_bam.len100": (True, {"bam": True}, "directional"),
    "se_hybrid.len100": (False, {"engine": "hybrid", "device_share": 0.5},
                         "directional"),
    "pe_mesh2.len100": (True, {"mesh": 2}, "directional"),
    "pe_shards2.len100": (True, {"index_shards": 2}, "directional"),
    "se_arich.len100": (False, {"a_rich": True}, "pbat"),
    "se_align.len100": (False, {"device_align": True}, "directional"),
    "se_cands.len100": (False, {"max_candidates": 50}, "directional"),
}


@pytest.mark.parametrize("cell", sorted(CASES))
def test_settings_run_as_stated(tiny, run_tiny, cell):
    root, _ = tiny
    paired, settings, protocol = CASES[cell]
    _tiny.add_cell(root, cell, cell.split(".")[0], paired, settings,
                   protocol=protocol)
    out = run_tiny(cell, 2**31 + 7)
    assert out["check"]["record_faults"]["value"] == 0, out["stderr"]
    assert out["correct"], out["stderr"]


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_protocol_mapped_as_another_is_not_correct(tiny, run_tiny, paired):
    root, _ = tiny
    cell = _tiny.add_cell(root, f"{'pe' if paired else 'se'}_dir.pbatreads",
                          f"{'pe' if paired else 'se'}_dir", paired,
                          protocol="pbat")
    out = run_tiny(cell, 5)
    assert not out["correct"]


@pytest.mark.parametrize("settings", [
    {"enigne": "torch"},
    {"ambig": True},
    {"engine": "native"},
    {"engine": "hybrid"},
    {"device_share": 0.5},
    {"mesh": 2, "index_shards": 2},
    {"mesh": 2, "device_align": True},
    {"lmax": 32},
], ids=["unknown_key", "ambiguous_reads_reported", "host_engine", "hybrid_without_share",
        "share_without_hybrid", "mesh_and_shards", "mesh_and_align",
        "lmax_below_64"])
def test_settings_the_harness_refuses(settings):
    with pytest.raises(ValueError):
        resolve(settings)


def test_unknown_traffic_parameter_stops_the_run(tiny, run_tiny):
    root, _ = tiny
    cell = _tiny.add_cell(root, "se_tiny.typo", "se_tiny", False,
                          pbat_share=0.5)
    with pytest.raises(ValueError):
        run_tiny(cell, 1)


def test_command_line_names_every_option():
    s = resolve({"engine": "hybrid", "device_share": 0.25, "pbat": True,
                 "bam": True, "threads": 4, "max_candidates": 3000,
                 "device_align": True})
    cl = command_line(s).split()
    for w in ("--engine", "hybrid", "--device-share", "0.25", "-P", "-B",
              "-t", "4", "-c", "3000", "--device-align"):
        assert w in cl
