"""The reference agrees with the port's SAM: tiny cells of every kind,
mapped on the CPU through the harness, judge correct, with every sampled
record checked and none at fault.  pe_tiny.len150 maps pairs longer than
--lmax, which the port re-maps on the host."""

from __future__ import annotations

import pytest


@pytest.mark.parametrize("cell", ["se_tiny.len100", "pe_tiny.len100",
                                  "pe_tiny.len150"])
def test_reference_agrees_with_the_port(run_tiny, cell):
    out = run_tiny(cell, 2**31 + 11)
    assert out["check"]["record_faults"]["value"] == 0, out["stderr"]
    assert out["correct"], out["stderr"]
    assert out["check"]["missed_share"]["value"] < 0.05
    assert out["attempted"] > 0 and out["failed"] == 0
