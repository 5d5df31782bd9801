"""The program's spans in a tiny traced run on the CPU
(abismal_bench/program_spans.py): the five readings that exist without a
card read numbers and device_wait_ms reads none; the program's dispatch
and finish means agree with the harness's outside timers; the run's line
is the harness's own, and an untraced run's keys are unchanged."""

from __future__ import annotations

from abismal_bench.tests.test_abismal_bench_line import E2E_KEYS


def _kw(tiny):
    root, build = tiny
    return dict(device="cpu", require_card=False, root=root, bench_dir=root,
                build=build)


def test_traced_split_reads_the_program_spans(tiny):
    from abismal_bench import program_spans as P

    res = P.traced_split("se_tiny.len100", 23, 0.5, **_kw(tiny))
    m = res["metrics"]
    for k in ("read_ms", "encode_ms", "native_ms", "write_ms",
              "native_busy_share"):
        assert m[k] is not None and m[k] > 0, k
    assert m["device_wait_ms"] is None
    assert set(res["agreement"]) == {"dispatch", "finish"}
    for name, ratio in res["agreement"].items():
        assert 0.9 <= ratio <= 1.0 + 1e-9, (name, ratio)
    assert res["counters"]["batches"] > 0
    assert res["counters"]["captures"] == 0
    assert res["idle_s"] == {}  # no device activity on the CPU
    out = res["result"]
    out.pop("stderr")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "check"]
    assert out["correct"]


def test_on_cost_keeps_the_untraced_line(tiny):
    from abismal_bench import program_spans as P

    res = P.on_cost("se_tiny.len100", 24, 0.5, min_maps=6, **_kw(tiny))
    assert [on for on, _ in res["passes"][:3]] == [False, True, False]
    assert res["ratio"] > 0 and len(res["ratios"]) >= 1
    out = res["result"]
    out.pop("stderr")
    assert list(out) == E2E_KEYS
    assert set(out["metrics"]) == {"reads_per_s", "setup_s"}
    assert out["correct"]


def test_idle_split_by_innermost_span(tmp_path):
    """Idle stretches of a synthetic trace go to the innermost span open
    over them, "none" outside every span; the parts add up to the idle
    time of the window."""
    import json

    from abismal_bench import program_spans as P

    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    ann = "user_annotation"
    events = [x(ann, "bench:map", 0, 100), x(ann, "abismal:map", 2, 95),
              x(ann, "abismal:read", 2, 28), x("kernel", "k", 30, 10),
              x(ann, "abismal:finish", 40, 50),
              x(ann, "abismal:native", 45, 40), x("kernel", "k", 89, 2),
              x("gpu_user_annotation", "abismal:map", 0, 100)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = {k: round(v * 1e6, 6) for k, v in P.idle_by_span(str(path)).items()}
    assert got == {"map/finish/native": 40, "map/read": 28,
                   "map/finish": 9, "map": 6, "none": 5}
