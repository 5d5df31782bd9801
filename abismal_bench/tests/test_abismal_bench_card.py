"""On the card (marked cuda; skips without one): a traced run of a tiny
cell reads every per-layer metric, the rooflines within 105%."""

from __future__ import annotations

import pytest


@pytest.mark.cuda
def test_traced_tiny_cell_on_the_card(tiny):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from abismal_bench import run as R

    root, build = tiny
    out = R.run("se_tiny.len100", 41, 1.0, True, root=root, bench_dir=root,
                build=build)
    m = out["metrics"]
    assert out["correct"], out["stderr"]
    assert out["device"]["busy_s"] > 0
    for k in ("replay_ms", "device_idle_share", "k2_roofline",
              "k4_roofline"):
        assert k in m, (k, m)
    assert 0 < m["k2_roofline"]["value"] <= 105
    assert 0 < m["k4_roofline"]["value"] <= 105
