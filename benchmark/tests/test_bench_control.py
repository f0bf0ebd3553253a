"""The correctness check fails what it must: the bfloat16 control in the
program's place, and a run of the harness with the timed path broken
underneath (half of a batch's rows left out; an answer altered where it is
produced). Each kept at a size a CPU test can hold; the control at the
cells' own sizes is ``benchmark/control.py``, run on the card's machine."""

from __future__ import annotations

import pytest

from bench_support import tiny_cell

import control
import run as bench_run

CELLS = ["flagship64.file", "flagship64.live16", "hk_radio.beeps", "hk_radio.hourly"]


def test_bf16_control_is_not_correct() -> None:
    readings = control.control_readings(tiny_cell("hk_radio.beeps"), seed=41)
    assert readings["correct"] is False
    assert readings["unmatched_events"] > 0 or readings["max_gap_ms"] > 0


def _break_collect(monkeypatch, fault: str) -> None:
    from audio_pattern_detector_tpu_torch.models.bank import PatternBank

    original = PatternBank.collect_chunks_batch

    def broken(self, dispatched):
        rows = original(self, dispatched)
        if fault == "half_rows":
            return [r if i % 2 == 0 else {name: [] for name in r} for i, r in enumerate(rows)]
        for r in rows:
            for name, positions in r.items():
                if positions:
                    r[name] = [positions[0] + 1, *positions[1:]]
                    break
        return rows

    monkeypatch.setattr(PatternBank, "collect_chunks_batch", broken)


@pytest.mark.parametrize("fault", ["half_rows", "altered_answer"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, name: str, fault: str) -> None:
    cell = tiny_cell(name)
    if fault == "half_rows":
        cell.traffic["check"] = {"chunks": 12, "marked": 12}  # most rows, so the dropped ones are seen
    _break_collect(monkeypatch, fault)
    result, lines = bench_run.run_cell(cell, seed=2**31 + 9, seconds=0.3, traced=False, device="cpu")
    assert result["correct"] is False, lines
