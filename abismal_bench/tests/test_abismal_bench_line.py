"""The printed line: exactly the contract's keys, the numbers compared
last; no result and a non-zero exit without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from abismal_bench.tests.conftest import ROOT

E2E_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def test_untraced_line(run_tiny):
    out = run_tiny("se_tiny.len100", 21)
    assert isinstance(out.pop("stderr"), list)
    assert list(out) == E2E_KEYS
    assert set(out["metrics"]) == {"reads_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["check"]) == {"record_faults", "missed_share"}
    assert all(set(v) == {"value", "limit"} for v in out["check"].values())
    json.dumps(out)


def test_traced_line(run_tiny):
    out = run_tiny("pe_tiny.len100", 22, trace=True)
    out.pop("stderr")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "check"]
    assert {"loop_share", "dispatch_ms", "finish_ms",
            "device_fallback_frac"} <= set(out["metrics"])
    # device numbers come from the card alone
    assert not {"replay_ms", "k2_roofline", "k4_roofline",
                "device_idle_share"} & set(out["metrics"])
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["correct"]


def test_no_card_no_result():
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['run.py', '--workload', 'se_g1000.len100', "
            "'--seed', '1', '--seconds', '1', '--trace', '0']; "
            "import runpy; runpy.run_path('abismal_bench/run.py', "
            "run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode not in (0, None)
    assert not p.stdout.strip()


def test_alone_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and abismal_bench/,
    a run exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "abismal_bench"),
                    tmp_path / "abismal_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "abismal_bench/run.py", "--workload",
                        "se_g1000.len100", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
