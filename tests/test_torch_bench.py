"""The port's bench (abismal_tpu_torch/tools/bench.py ↔ bench.py at the
repository's root): under the same child results its JSON line equals the
JAX bench's but for the mode names, the metric text and vs_baseline;
every mode maps and verifies its output on the CPU (plain kernels); the
default 10k seed-1 reads give upstream's golden md5; a repetition whose
SAM differs from the truth is not counted; a child runs through the
subprocess path; a failed mode fails the bench."""

import importlib.util
import json
import os
import sys

import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    port_index_file, release_engines,
)

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--threads", "1"]
# the port's mode names for the JAX bench's
PORT_NAME = {"native": "native", "hybrid": "torch", "split": "split",
             "pe_native": "pe_native", "pe_hybrid": "pe_torch"}


@pytest.fixture(scope="module")
def index_file():
    return port_index_file()


@pytest.fixture
def bench(tmp_path, monkeypatch, index_file):
    """The bench module, the tools' cache in tmp_path with the test cache's
    tRex1 index in it, and the port's memoized engines dropped after the
    test."""
    from abismal_tpu_torch.map import pipeline
    from abismal_tpu_torch.tools import _workload
    from abismal_tpu_torch.tools import bench as port_bench

    cache = tmp_path / "cache"
    cache.mkdir()
    os.symlink(index_file, cache / "tRex1.idx")
    monkeypatch.setattr(_workload, "CACHE", str(cache))
    yield port_bench
    pipeline.release_engines()


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHILD_RESULTS = [
    {"native": {"best": 151234.56789, "median": 140000.04, "fallback": None},
     "hybrid": {"best": 25432.1234, "median": 24000.55,
                "fallback": 0.0651234567},
     "split": {"best": 160001.2345, "median": 150000.0,
               "fallback": 0.064444444, "device_share": 0.1377},
     "pe_native": {"best": 90123.4, "median": 88000.26, "fallback": None},
     "pe_hybrid": {"best": 12000.06, "median": 11000.0,
                   "fallback": 0.0412345678}},
    {"native": {"best": 99.0, "median": 98.0, "fallback": None},
     "hybrid": {"best": 100.04, "median": 90.0, "fallback": 0.0},
     "split": {"best": 0.0, "median": 0.0, "fallback": None,
               "device_share": None},
     "pe_native": {"best": 50.0, "median": 40.0, "fallback": None},
     "pe_hybrid": {"best": 0.0, "median": 0.0, "fallback": 1.0}},
]


@pytest.mark.parametrize("results", CHILD_RESULTS, ids=["split", "torch"])
def test_line_equals_the_jax_bench(bench, monkeypatch, capsys, results):
    jax_bench = _jax_bench()
    monkeypatch.setattr(jax_bench, "_run_child",
                        lambda mode, deadline: dict(results[mode]))
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    jax_bench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port = {PORT_NAME[m]: dict(v) for m, v in results.items()}
    monkeypatch.setattr(bench, "_run_child",
                        lambda mode, deadline, argv: dict(port[mode]))
    got = bench.main(CPU)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    assert set(want) == {"metric", "value", "unit", "vs_baseline", "modes"}
    assert set(got) == {"metric", "value", "unit", "modes"}
    assert got["metric"].startswith("end-to-end SE mapping, ")
    for line in (want, got):
        line.pop("metric")
    want.pop("vs_baseline")
    want["modes"] = {PORT_NAME[m]: v for m, v in want["modes"].items()}
    assert got == want


@pytest.mark.parametrize("mode", ["native", "torch", "split", "pe_native",
                                  "pe_torch"])
def test_every_mode_verifies_on_cpu(bench, mode):
    """200 reads (100 pairs), one repetition, one thread: the repetition
    is verified against the native engine's SAM, so best > 0; the device
    modes report their fallback fraction, split its share."""
    r = bench.run_mode(mode, "cpu", reads=200, reps=1, threads=1)
    assert r["best"] > 0 and r["median"] == r["best"]
    device = mode in bench.DEVICE_MODES
    assert (r["fallback"] is not None) == device
    assert ("device_share" in r) == (mode == "split")
    if mode.startswith("pe_"):
        line = bench.summary_line({"native": r}, {mode: r}, 1, "cpu")
    else:
        line = bench.summary_line({mode: r}, {}, 1, "cpu")
    assert ("fallback_frac" in line["modes"][mode]) == device
    if device:
        assert 0 <= line["modes"][mode]["fallback_frac"] <= 1


def test_golden_reads_give_the_golden_md5(bench):
    """The default 10,000 reads of seed 1 mapped by the native engine with
    the golden's argv: upstream's md5, so a repetition is verified."""
    r = bench.run_mode("native", "cpu", reads=bench.N_READS, reps=1,
                       threads=1)
    assert r["best"] > 0
    assert bench.GOLDEN_SAM_MD5 == _jax_bench().GOLDEN_SAM_MD5


def test_unverified_rep_is_not_counted(bench, monkeypatch):
    """Two repetitions, the first one's SAM read as differing from the
    truth: only the second one's rate counts.  With none verified the mode
    reports 0."""
    from abismal_tpu_torch.tools import _workload

    real, calls = _workload.md5, []

    def md5(path):  # the truth's md5, then one per repetition
        calls.append(path)
        return "0" * 32 if len(calls) == 2 else real(path)

    monkeypatch.setattr(_workload, "md5", md5)
    r = bench.run_mode("native", "cpu", reads=200, reps=2, threads=1)
    assert len(calls) == 3
    assert r["best"] > 0 and r["median"] == r["best"]  # one rate counted
    monkeypatch.setattr(_workload, "truth_md5", lambda *a: "0" * 32)
    r = bench.run_mode("native", "cpu", reads=200, reps=2, threads=1)
    assert r == {"best": 0.0, "median": 0.0, "fallback": None}


def test_native_child_runs_in_a_process(index_file):
    """The child reads and writes the tools' files where any run of the
    bench does (build/abismal_tpu_torch/tools/ of the checkout); where no
    tRex1 index is there yet, the port's test index is linked there
    (written to a name of this process and moved into place)."""
    from abismal_tpu_torch.tools import _workload, bench

    path = _workload.cache_path("tRex1.idx")
    if not os.path.exists(path):
        tmp = f"{path}.tmp{os.getpid()}"
        os.symlink(index_file, tmp)
        os.replace(tmp, path)
    r = bench._run_child("native", 300, ["--reads", "200", "--reps", "1",
                                         *CPU])
    assert r["best"] > 0 and r["fallback"] is None


def test_failed_mode_fails_the_bench(bench, monkeypatch):
    def child(mode, deadline, argv):
        if mode == "split":
            return None
        return {"best": 1.0, "median": 1.0, "fallback": None}

    monkeypatch.setattr(bench, "_run_child", child)
    with pytest.raises(RuntimeError, match="split"):
        bench.main(CPU)


def test_bench_without_card_raises(bench):
    """--device cuda (the default) without a card raises before any child
    starts; nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--reads", "200"])
