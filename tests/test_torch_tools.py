"""The port's device tools (abismal_tpu_torch/tools/) run on the CPU at a
tiny size through their main(), with --device cpu: every cut of the
bisections is timed, the traces and stage tables have rows, the 1 Gb
measurement (on a 2 Mb genome here) keeps its paired-end split keys,
the fallback sweep's SAMs equal the native engine's and the extension
check finds no mismatched cell.  Their files go to a temporary cache
directory; none goes where the JAX package's tools write."""

import json
import os

import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    TREX1_FA, port_index_file, release_engines,
)

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--threads", "1"]


@pytest.fixture
def tools(tmp_path, monkeypatch):
    """The tools' module, their cache in tmp_path, the tRex1 index of the
    test cache as the profiled one."""
    from abismal_tpu_torch.tools import _workload

    monkeypatch.setattr(_workload, "CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("ABISMAL_PROFILE_INDEX", port_index_file())
    monkeypatch.setenv("ABISMAL_PROFILE_GENOME", TREX1_FA)
    return _workload


def test_profile_stage12_times_every_cut(tools):
    from abismal_tpu_torch.tools import profile_stage12

    rows = profile_stage12.main(["128", "2", *CPU])
    assert [r["cut"] for r in rows] == [
        c or "full" for c in profile_stage12.CUTS]
    assert all(r["ms"] > 0 and r["us_per_unit"] > 0 for r in rows)
    rows = profile_stage12.main(["64", "2", "fbstats", "full", *CPU])
    assert [r["cut"] for r in rows] == ["fbstats", "full"]


def test_profile_stage12pe_times_every_cut(tools):
    from abismal_tpu_torch.tools import profile_stage12pe

    rows = profile_stage12pe.main(["128", "2", *CPU])
    assert [r["cut"] for r in rows] == [
        c or "full" for c in profile_stage12pe.CUTS]
    assert all(r["ms"] > 0 for r in rows)


def test_profile_stage1_with_noext_variant(tools, tmp_path):
    from abismal_tpu_torch.tools import profile_stage1

    res = profile_stage1.main(["--units", "32", "--reps", "2",
                               "--trace", str(tmp_path / "tr"), *CPU])
    assert res["ext"]["ms"] > 0 and res["noext"]["ms"] > 0
    assert sorted(os.listdir(tmp_path / "tr")) == [
        "stage1_ext.json", "stage1_noext.json"]
    assert "ABISMAL_TPU_NOEXT" not in os.environ


def test_trace_ops_lists_top_ops(tools):
    from abismal_tpu_torch.tools import trace_ops

    res = trace_ops.main(["64", "2", "5", *CPU])
    assert res["events"] == "CPU op" and len(res["top"]) == 5
    assert res["total_us_per_exec"] > 0 and os.path.exists(res["trace"])


@pytest.mark.parametrize("engine", ["native", "torch"])
def test_profile_stage_table(tools, tmp_path, engine):
    from abismal_tpu_torch.tools import profile

    res = profile.main(["--engine", engine, "--reads", "40", "--reps", "2",
                        "--trace", str(tmp_path / "tr"), *CPU])
    assert res["reads"] == 80 and res["reads_per_s"] > 0
    assert set(res["native_cpu_s"]) == {"seed", "align", "format", "parse"}
    assert ("stage_wall_s" in res) == (engine == "torch")
    assert os.path.exists(tmp_path / "tr" / f"profile_{engine}.json")


def test_scale_device_keeps_pe_split_keys(tools, tmp_path):
    """A whole run writes every key, the paired-end split's among them,
    to --out, and nothing to the JAX tool's BENCH_SCALE.json."""
    from abismal_tpu_torch.tools import scale_device

    before = os.path.getmtime(os.path.join(ROOT, "BENCH_SCALE.json"))
    out = tmp_path / "scale.json"
    res = scale_device.main(["--size-mb", "2", "--reads", "60",
                             "--unit-batch", "64", "--out", str(out), *CPU])
    assert json.load(open(out)) == json.loads(json.dumps(res))
    for key in ("table_bytes", "candidates_per_unit",
                "informed_cand_budget_per_unit", "stage12_ms_per_chunk",
                "engine_tpu_reads_per_s", "engine_native_reads_per_s",
                "engine_split_reads_per_s", "split_device_share",
                "engine_tpu_pe_pairs_per_s", "engine_native_pe_pairs_per_s",
                "engine_split_pe_pairs_per_s", "split_pe_device_share"):
        assert key in res, key
    assert os.path.getmtime(os.path.join(ROOT, "BENCH_SCALE.json")) == before
    assert scale_device.DEFAULT_OUT.startswith(
        os.path.join(ROOT, "build", "abismal_tpu_torch"))


def test_fallback_sweep_sams_equal_native(tools, tmp_path):
    from abismal_tpu_torch.tools import fallback_sweep

    before = os.path.getmtime(os.path.join(ROOT, "FALLBACK_SWEEP.json"))
    out = tmp_path / "sweep.json"
    res = fallback_sweep.main(["12", "--rows", "1,7", "--out", str(out),
                               *CPU])
    assert [(r["genome"], r["mutation"]) for r in res] == [
        ("tRex1", 0.01), ("repeat30", 0.01)]
    assert all(r["md5_ok"] for r in res) and json.load(open(out)) == res
    assert os.path.getmtime(
        os.path.join(ROOT, "FALLBACK_SWEEP.json")) == before
    assert fallback_sweep.DEFAULT_OUT.startswith(
        os.path.join(ROOT, "build", "abismal_tpu_torch"))


def test_debug_ext_finds_no_mismatched_cell(tools):
    from abismal_tpu_torch.tools import debug_ext

    res = debug_ext.main(CPU)
    assert [bad for bad, _ in res] == [0, 0]
    assert all(checked > 50 for _, checked in res)
