"""``scripts/profile_stages_torch.py`` at its CPU smoke size: each shape's
line names every stage of the lean class step with a host time
(``cpu_ms``, never a device metric), a bound and a share of the step, the
sum of the stages beside the whole step; on a machine without a card the
card run refuses to start."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "profile_stages_torch.py"


@pytest.fixture(scope="module")
def split():
    spec = importlib.util.spec_from_file_location("profile_stages_torch", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shape,stages", [
    ("one_clip_file_mode", 8),  # 4 class stages, the group's 4
    ("flagship_step", 12),  # 4 class stages, 4 a group for 2 groups
    ("flagship_round", 12),
    ("rainbow_file_mode", 8),  # the rainbow intro clip's class: fft_len 131,072
])
def test_the_split_prints_every_stage_of_the_step(split, capsys, shape, stages):
    assert split.main(["--device", "cpu", "--shapes", shape]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "cpu"
    (record,) = [json.loads(line) for line in out[1:]]
    assert record["shape"] == shape and record["card"] == "cpu"
    assert record["rows"] == (3 if shape == "flagship_round" else 1)
    names = [st["stage"] for st in record["stages"]]
    assert len(names) == stages and names[:4] == ["k_weighting", "gate", "normalize",
                                                  "segment_spectra"]
    kinds = {n.split("_", 1)[-1] for n in names[4:] if n.startswith("correlation_")}
    for kind in kinds:
        for part in ("correlation", "scan", "lean_greedy", "lean_tail"):
            assert f"{part}_{kind}" in names
    for st in record["stages"]:
        assert set(st) == {"stage", "cpu_ms", "bound_ms", "bound_by", "share_of_bound",
                           "share_of_step"}
        assert st["cpu_ms"] > 0 and st["bound_ms"] >= 0 and st["bound_by"] in (
            "bytes", "operations")
    assert record["step_cpu_ms"] > 0
    assert record["sum_of_stages_cpu_ms"] == pytest.approx(
        sum(st["cpu_ms"] for st in record["stages"]))
    assert not any("device" in key for key in record)


def test_the_card_run_needs_a_card(split, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert split.main([]) == 2
    assert "no CUDA card" in capsys.readouterr().err
