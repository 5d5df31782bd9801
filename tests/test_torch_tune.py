"""The port's tuning and scaling tools (abismal_tpu_torch/tools/
sweep_unit_batch.py, tune_stage2.py, tune_hybrid.py, multihost_scale.py ↔
tools/ of the same names) through their main() with --device cpu at a
tiny size: the sweep's SAM bodies agree across sizes, tune_stage2's
repetitions are verified and its stage table has the spans of the
engine's tracer (the eager runner's, on the CPU), tune_hybrid sets the pipeline depth for its runs only, and the
weak-scaling tool prints one efficiency line per host count, with torch
shards by default and with native shards on --engine native."""

import os

import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    port_index_file, release_engines,
)

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

CPU = ["--device", "cpu", "--threads", "1"]
STAGES = {"map", "map/read", "map/dispatch", "map/dispatch/encode",
          "map/dispatch/stage_in", "map/dispatch/run", "map/finish",
          "map/finish/collect", "map/finish/pack", "map/finish/native",
          "map/finish/write"}


@pytest.fixture(scope="module")
def index_file():
    return port_index_file()


@pytest.fixture
def cache(tmp_path, monkeypatch, index_file):
    """The tools' cache in tmp_path, with the test cache's tRex1 index in
    it; shard processes get one torch thread each."""
    from abismal_tpu_torch.tools import _workload

    path = tmp_path / "cache"
    path.mkdir()
    os.symlink(index_file, path / "tRex1.idx")
    monkeypatch.setattr(_workload, "CACHE", str(path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return path


def test_sweep_unit_batch_bodies_agree(cache, capsys):
    from abismal_tpu_torch.tools import sweep_unit_batch

    rows = sweep_unit_batch.main(["128", "256", "--reads", "100", *CPU])
    assert [r["unit_batch"] for r in rows] == [128, 256]
    assert all(r["md5_ok"] and r["reads_per_s"] > 0 for r in rows)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all(ln.endswith("md5=OK") for ln in lines)


def test_tune_stage2_verified_with_stage_keys(cache):
    from abismal_tpu_torch.tools import tune_stage2

    (row,) = tune_stage2.main(["128", "--reads", "100", *CPU])
    assert row["verified"] == row["reps"] == tune_stage2.REPS
    assert row["best"] > 0 and 0 <= row["fallback"] <= 1
    # finish/native_wait: where a finish waited for the finalize pool
    assert STAGES <= set(row["stages"]) <= STAGES | {"map/finish/native_wait"}
    assert row["stages"]["map/dispatch"] > 0


def test_tune_hybrid_sets_the_depth_for_its_runs(cache):
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine
    from abismal_tpu_torch.tools import tune_hybrid

    depth = TorchNativeEngine.pipeline_depth
    rows = tune_hybrid.main(["128,256", "1", "--reads", "100", *CPU])
    assert [(r["unit_batch"], r["depth"]) for r in rows] == [(128, 1),
                                                            (256, 1)]
    assert all(r["reads_per_s"] > 0 and 0 < r["cpu_s"] for r in rows)
    assert TorchNativeEngine.pipeline_depth == depth


# torch shards on the CPU hold an index and its tables each (~2.6 GB):
# one host of them here, two native ones
@pytest.mark.parametrize("engine,hosts", [("native", [1, 2]),
                                          ("torch", [1])])
def test_multihost_scale_efficiency_per_host_count(cache, capsys, engine,
                                                   hosts):
    from abismal_tpu_torch.tools import multihost_scale

    argv = ["--per-host", "100", "--hosts", *map(str, hosts), "--reps", "1",
            "--threads", "1"]
    argv += ["--device", "cpu"] if engine == "torch" else ["--engine",
                                                           "native"]
    res = multihost_scale.main(argv)
    assert res["engine"] == engine and sorted(res["reads_per_s"]) == hosts
    assert res["efficiency"][1] == 1.0
    out = capsys.readouterr().out
    for n in hosts:
        assert out.count(f"weak-scaling efficiency at {n} host(s): ") == 1
        assert os.path.getsize(cache / "multihost_scale" / f"out{n}.sam")
