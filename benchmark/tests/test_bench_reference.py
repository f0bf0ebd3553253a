"""The plain reference finds the upstream's golden detections, agrees with
the port's plain CPU path on every cell at a tiny size, and holds its
numerics to the port's host copies where both define them."""

from __future__ import annotations

import json

import numpy as np
import pytest

from bench_support import ROOT, tiny_cell
from harness import reference as R
from harness.cell import CONFIGS, DATA, reference_clips
from harness.traffic import read_wav_int16

import run as bench_run

SAMPLES = ROOT / "sample_audios"


def _clip(name: str) -> R.Clip:
    cfg = json.loads((CONFIGS / "hk_radio.json").read_text())
    return [c for c in reference_clips(cfg, 0) if c.name == name][0]


@pytest.mark.parametrize("clip,audio,expected_ms", [
    ("rthk_beep", DATA / "hk_radio" / "rthk_section_with_beep.wav", [1408, 2420]),
    ("cbs_news", DATA / "hk_radio" / "cbs_news_audio_section.wav", [25899]),
    ("rainbow_intro", DATA / "hk_radio" / "am1430_section_with_rainbow_intro.wav", [13848]),
])
def test_golden_flows(clip: str, audio, expected_ms: list[int]) -> None:
    x, sr = read_wav_int16(audio)
    det = R.ReferenceDetector([_clip(clip)], sr, 60)
    got = sorted(round(t * 1000) for _, t in det.detect(x, None, 0))
    assert len(got) == len(expected_ms)
    assert all(abs(g - e) <= 1 for g, e in zip(got, expected_ms))


def test_false_positive_capture_gives_nothing() -> None:
    x, sr = read_wav_int16(DATA / "hk_radio" / "rthk_section_with_beep.wav")
    det = R.ReferenceDetector([_clip("881_beep"), _clip("903_beep")], sr, 60)
    assert det.detect(x, None, 0) == []


@pytest.mark.parametrize("name", ["flagship64.file", "flagship64.live16", "hk_radio.beeps", "hk_radio.hourly"])
def test_port_cpu_path_agrees_with_the_reference(name: str) -> None:
    result, lines = bench_run.run_cell(tiny_cell(name), seed=2**31 + 77, seconds=0.5, traced=False, device="cpu")
    assert result["correct"], lines
    assert result["checks"]["events_compared"]["value"] >= 1
    assert result["checks"]["unmatched_events"]["value"] == 0


def test_numerics_match_the_port_host_copies() -> None:
    from audio_pattern_detector_tpu_torch.ops import hostref

    rng = np.random.default_rng(0)
    x = (0.1 * rng.standard_normal(8000 * 5)).astype(np.float32)
    assert R.integrated_loudness(x, 8000) == pytest.approx(hostref.integrated_loudness(x, 8000), abs=1e-9)
    corr = np.abs(rng.standard_normal(5000)).astype(np.float32)
    assert np.array_equal(R.find_peaks(corr, 2.0, 40), hostref.find_peaks(corr, height=2.0, distance=40)[0])
    assert np.array_equal(R.resample_preserve_maxima(corr, 101), hostref.resample_preserve_maxima(corr, 101))
    assert R.pearson(corr[:100], corr[100:200]) == pytest.approx(hostref.pearson_correlation(corr[:100], corr[100:200]))


def test_bf16_rounds_to_eight_bits() -> None:
    x = np.array([1.0, 1.00390625, 1.005859375, -3.14159], dtype=np.float32)
    y = R.bf16(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == np.float32(1.0078125)
    assert abs(y[3] - x[3]) < 2 ** -7 * 4
