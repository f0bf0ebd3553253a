"""A cell reaches the port through the driver its traffic file names, with
the options its files set and nothing else."""

from __future__ import annotations

import copy

import numpy as np
import pytest

from bench_support import tiny_cell
from harness import port
from harness.cell import reference_clips
from harness.traffic import generate


def _driver(cell, tmp_path):
    clips = reference_clips(cell.config, 5)
    traffic = generate(cell.traffic, 5, 8000, 60, clips, cell.data_dir)
    tmp_path.mkdir(parents=True, exist_ok=True)
    return cell.driver.Driver(cell, traffic, clips, "cpu", tmp_path), traffic


def test_engine_options_take_the_traffic_file_over_the_configuration() -> None:
    cell = copy.deepcopy(tiny_cell("flagship64.file"))
    assert port.engine_options(cell) == {}
    cell.config["engine"] = {"height_min": 0.5, "pipeline_depth": 2}
    cell.traffic["engine"] = {"height_min": 0.0}
    assert port.engine_options(cell) == {"height_min": 0.0, "pipeline_depth": 2}


def test_file_scan_passes_engine_options_and_keeps_the_cli_plan(tmp_path) -> None:
    plain, _ = _driver(tiny_cell("hk_radio.hourly"), tmp_path / "a")
    assert plain.opts.height_min is None and plain.opts.chunk_auto_perf and plain.opts.stream_batch_mode == "scan"
    cell = tiny_cell("hk_radio.hourly")
    cell.traffic["engine"] = {"height_min": 0.0, "stream_batch_mode": "vmap"}
    d, _ = _driver(cell, tmp_path / "b")
    assert d.opts.height_min == 0.0 and d.opts.stream_batch_mode == "vmap"
    assert d.detector.height_min == 0.0
    assert (d.opts.seconds_per_chunk, d.opts.stream_batch) == (plain.opts.seconds_per_chunk, plain.opts.stream_batch)


def test_live_takes_serves_tile_and_the_session_options(tmp_path) -> None:
    d, _ = _driver(tiny_cell("flagship64.live16"), tmp_path)
    assert d.session._tile == 3
    cell = tiny_cell("flagship64.live16")
    cell.traffic["session"] = {"tile": 2}
    cell.traffic["engine"] = {"height_min": 0.0}
    d, _ = _driver(cell, tmp_path)
    assert d.session._tile == 2 and d.session.detector.height_min == 0.0


@pytest.mark.parametrize("name", ["flagship64.file", "flagship64.live16"])
def test_the_control_and_the_run_draw_from_the_same_population(name: str) -> None:
    cell = tiny_cell(name)
    clips = reference_clips(cell.config, 8)
    traffic = generate(cell.traffic, 8, 8000, 60, clips, cell.data_dir)
    mod = cell.driver
    served = mod.served_whole(traffic, 4)
    every, marked = mod.population(traffic, served)
    assert set(marked) <= set(every) and marked
    chunk, prev, index = mod.inputs(traffic, every[1])
    assert chunk.dtype == np.int16 and len(chunk) == traffic.chunk_samples and index == every[1][1]
    assert prev is None or len(prev) == traffic.chunk_samples
