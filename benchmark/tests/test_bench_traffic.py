"""The traffic generator is a function of its file and the seed: the same
seed gives the same audio, another seed other audio of the same size, and
captures are placed as recorded."""

from __future__ import annotations

import numpy as np
import pytest

from bench_support import tiny_cell
from harness.cell import reference_clips
from harness.traffic import generate, read_wav_int16

CELLS = ["flagship64.file", "flagship64.live16", "hk_radio.beeps", "hk_radio.hourly"]


def _make(name: str, seed: int):
    cell = tiny_cell(name)
    clips = reference_clips(cell.config, seed)
    return cell, generate(cell.traffic, seed, 8000, 60, clips, cell.data_dir)


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_traffic(name: str) -> None:
    _, a = _make(name, 2**31 + 12345)
    _, b = _make(name, 2**31 + 12345)
    assert len(a.streams) == len(b.streams)
    for sa, sb in zip(a.streams, b.streams):
        assert np.array_equal(sa.samples, sb.samples) and sa.marked == sb.marked
    if a.order is not None:
        assert np.array_equal(a.order, b.order)


@pytest.mark.parametrize("name", CELLS)
def test_other_seed_other_traffic_of_the_same_size(name: str) -> None:
    _, a = _make(name, 1)
    _, b = _make(name, 2)
    assert [len(s.samples) for s in a.streams] == [len(s.samples) for s in b.streams]
    assert any(not np.array_equal(sa.samples, sb.samples) for sa, sb in zip(a.streams, b.streams))


def test_beeps_places_captures_unedited() -> None:
    cell, t = _make("hk_radio.beeps", 99)
    caps = [read_wav_int16(cell.data_dir / c)[0] for c in cell.traffic["background"]["captures"]]
    head = t.streams[0].samples
    pos, found = 0, 0
    while pos < len(head) - 8000:
        hit = [c for c in caps if np.array_equal(head[pos:pos + len(c)], c[: len(head) - pos])]
        assert hit, f"no capture starts at sample {pos}"
        pos += len(hit[0])
        found += 1
    assert found > 10


def test_hourly_opens_with_an_opening_and_marks_its_airings() -> None:
    cell, t = _make("hk_radio.hourly", 5)
    openings = [read_wav_int16(cell.data_dir / c)[0] for c in cell.traffic["opening"]["captures"]]
    for s in t.streams:
        assert any(np.array_equal(s.samples[: len(o)], o) for o in openings)
        assert 0 in s.marked


def test_planted_airings_are_marked() -> None:
    _, t = _make("flagship64.file", 3)
    assert all(s.marked for s in t.streams)
