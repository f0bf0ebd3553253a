"""The result line has the contract's shape; the trace reduction and the
metric readers compute what they say on known inputs."""

from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from bench_support import ROOT, tiny_cell
from harness import trace
from harness.bounds import correlate_bound_s, roofline_pct, scan_bound_s
from harness.cell import load_cell, metric_reader

import run as bench_run


def test_result_line_shape_on_the_cpu() -> None:
    cell = tiny_cell("flagship64.live16")
    result, lines = bench_run.run_cell(cell, seed=2**31 + 5, seconds=0.5, traced=False, device="cpu")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool) and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert len(lines) == len(result["checks"])
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_without_a_card_it_prints_no_result() -> None:
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flagship64.live16", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_unknown_workload_is_refused() -> None:
    with pytest.raises(SystemExit):
        load_cell("flagship64.nope")


def _events(window_us=(0, 1000)) -> list[dict]:
    w0, w1 = window_us
    return [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_LABEL, "ts": w0, "dur": w1 - w0},
        {"ph": "X", "cat": "kernel", "name": "void correlate_os_kernel<false>(Args)", "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "candidate_scan_kernel", "ts": 250, "dur": 100},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 600, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 340, "dur": 300},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0, "dur": 100},
    ]


def test_trace_reduction_takes_the_union_inside_the_window() -> None:
    s = trace.reduce(_events())
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(350e-6)  # [100, 350) and [600, 700)
    assert s.kernel_time("correlate_os_kernel") == (1, pytest.approx(200e-6))
    assert "outside" not in s.kernels
    labels = dict(s.idle_gaps)
    assert labels["cudaStreamSynchronize"] == pytest.approx(250e-6)  # the gap [350, 600)
    assert labels["aten::copy_"] == pytest.approx(100e-6)  # [0, 100)
    assert labels["host (no traced call)"] == pytest.approx(300e-6)  # [700, 1000)
    assert s.device_ops[0][0].startswith("void correlate_os_kernel")


def test_metric_readers_on_a_known_context() -> None:
    s = trace.reduce(_events())
    per_step = [correlate_bound_s(1, 32, 21, 32768, 488_000 + 8000 - 1)]
    ctx = SimpleNamespace(setup_s=12.5, trace=s,
                          window={"wall_s": 2.0, "chunks": 100, "audio_s": 6000.0, "read_s": 0.1,
                                  "pack_s": 0.2, "rows": 64, "rounds": 4, "dispatch": [0.001, 0.003],
                                  "latencies": [0.010] * 19 + [0.020]},
                          traced={"chunks": 10, "rounds": 2},
                          launch_bounds={"correlate": per_step, "scan": [scan_bound_s(32, 495_999, 495_999)]})
    assert metric_reader("scan_x_realtime")(ctx) == pytest.approx(3000.0)
    assert metric_reader("setup_s")(ctx) == 12.5
    assert metric_reader("read_ms_per_chunk.file")(ctx) == pytest.approx(1.0)
    assert metric_reader("pack_ms_per_row.live")(ctx) == pytest.approx(1e3 * 0.2 / 64)
    assert metric_reader("dispatch_ms_per_round.live")(ctx) == pytest.approx(2.0)
    assert 10.0 <= metric_reader("live_p95_ms")(ctx) <= 20.0
    assert metric_reader("device_idle_pct.file")(ctx) == pytest.approx(65.0)
    assert metric_reader("device_ms_per_chunk.file")(ctx) == pytest.approx(1e3 * 300e-6 / 10)
    pct = metric_reader("correlate_roofline.file")(ctx)
    assert pct == pytest.approx(100.0 * per_step[0][0] / 200e-6)
    assert roofline_pct(SimpleNamespace(trace=None, launch_bounds={}), "x", "correlate") is None


def test_no_trace_no_device_metric() -> None:
    ctx = SimpleNamespace(trace=None, traced=None, window={}, launch_bounds={})
    for name in ("device_idle_pct.live", "device_ms_per_round.live", "correlate_roofline.live",
                 "scan_roofline.file"):
        assert metric_reader(name)(ctx) is None
