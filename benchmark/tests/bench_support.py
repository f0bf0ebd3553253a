"""Shared helpers of the benchmark's CPU tests: the harness on the path and
cells cut to a size a CPU test can run (a few clips, minutes of audio)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.cell import Cell, load_benchmark, load_cell  # noqa: E402


def tiny_cell(name: str) -> Cell:
    """``name`` (``<config>.<traffic>``, a cell of ``BENCHMARK.json`` or a
    pairing of its files that no cell names yet) at a CPU test's size:
    3 + 3 clips of a seeded bank, two four-minute recordings or three
    stations on a pool of four chunks, and airings dense enough that a
    small sample holds some."""
    bench = load_benchmark()
    if name not in {w["name"] for w in bench["workloads"]}:
        config, traffic = name.split(".", 1)
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1})
        if config not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append({"name": config, "file": f"benchmark/configs/{config}.json"})
    cell = copy.deepcopy(load_cell(name, bench))
    if "bank" in cell.config:
        cell.config["bank"]["normal"]["count"] = 3
        cell.config["bank"]["marker"]["count"] = 3
    t = cell.traffic
    t["check"] = {"chunks": 4, "marked": 2}
    if "stations" not in t:
        t["recordings"], t["recording_seconds"] = 2, 240
        if "inserts" in t:
            t["inserts"]["counts"] = [[1, 2], [2, 1]]
        if "plant" in t:
            t["plant"]["counts"] = [4, 6]
    else:
        t["stations"], t["recording_seconds"] = 3, 240
        t["plant"]["counts"] = [4]
    return cell
