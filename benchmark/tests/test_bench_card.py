"""On a card: one short run of each cell through the command the driver
runs, correct and in the contract's shape. Skips without a CUDA device.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_support import ROOT
from harness.cell import load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell: str, trace: int) -> None:
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 3),
                           "--seconds", "2", "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], proc.stderr[-2000:]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name, m in result["metrics"].items():
            if name.split(".")[0].endswith("_roofline"):
                assert 0 < m["value"] <= 105
