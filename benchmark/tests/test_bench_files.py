"""Every file the benchmark names parses, holds what the contract asks of
it, and the harness finds it by name."""

from __future__ import annotations

import json
import re

import pytest

from bench_support import BENCH_DIR, ROOT
from harness.cell import (CONFIGS, DRIVERS, METRICS, TRAFFIC, load_benchmark, load_cell, load_driver, metric_path,
                          metric_reader, reference_clips)

BENCH = load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRIC_NAMES = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys_and_command() -> None:
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines() -> None:
    names = [c["name"] for c in BENCH["configs"]] + CELLS + METRIC_NAMES
    assert all(NAME.match(n) for n in names)
    assert len(set(METRIC_NAMES)) == len(METRIC_NAMES) and len(set(CELLS)) == len(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]] + \
            [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds_and_sources() -> None:
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_and_reports_enough(cell: str) -> None:
    c = load_cell(cell, BENCH)
    assert c.chips == 1
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    assert (TRAFFIC / f"{[w for w in BENCH['workloads'] if w['name'] == cell][0]['traffic']}.json").exists()
    assert (DRIVERS / f"{c.traffic['driver']}.py").is_file() and c.driver.Driver


@pytest.mark.parametrize("name", METRIC_NAMES)
def test_every_metric_has_a_reader(name: str) -> None:
    assert metric_path(name).is_file() and metric_path(name).parent == METRICS
    assert callable(metric_reader(name))


def test_a_family_suffix_shares_the_reader_of_its_name() -> None:
    assert metric_path("device_idle_pct.live") == metric_path("device_idle_pct.file") == METRICS / "device_idle_pct.py"
    assert metric_path("pack_ms_per_row.live") == METRICS / "pack_ms_per_row.live.py"  # its own reader first
    assert metric_path("live_p95_ms") == METRICS / "live_p95_ms.py"


@pytest.mark.parametrize("name", sorted(p.stem for p in DRIVERS.glob("*.py")))
def test_every_driver_gives_what_the_harness_calls(name: str) -> None:
    mod = load_driver(name)
    assert load_driver(name) is mod
    for fn in ("population", "inputs", "served_whole"):
        assert callable(getattr(mod, fn))
    for method in ("warm", "run", "launch_bounds", "served", "close", "pairs"):
        assert callable(getattr(mod.Driver, method))


@pytest.mark.parametrize("config", sorted(p.stem for p in CONFIGS.glob("*.json")))
def test_configs_parse_and_make_their_bank(config: str) -> None:
    """Every configuration file, named in ``BENCHMARK.json`` or kept for a
    cell that is left for later."""
    data = json.loads((CONFIGS / f"{config}.json").read_text())
    assert data["name"] == config
    assert data["precision"] == "float32" and data["sample_rate"] == 8000 and data["chunk_seconds"] == 60
    clips = reference_clips(data, seed=7)
    assert len({c.name for c in clips}) == len(clips)
    expected = 64 if config == "flagship64" else 5
    assert len(clips) == expected
    for p in data.get("patterns", []):
        assert (CONFIGS / p).exists()


def test_benchmark_configs_are_their_files() -> None:
    for entry in BENCH["configs"]:
        assert entry["file"] == f"benchmark/configs/{entry['name']}.json" and entry["reduced"] == []
        assert json.loads((ROOT / entry["file"]).read_text())["source"] == entry["source"]


def test_every_file_under_the_benchmark_has_a_plain_name() -> None:
    for p in BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts or not p.is_file():
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))), p
